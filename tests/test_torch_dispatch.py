"""The port engine's dispatch modes against the JAX package's Engine.

One port Engine and one JAX Engine, both at scan_k=4 with the pipeline
on over a paged pool, give identical tokens and finish reasons on
tests/test_scan_decode.py's mixed workload through 4 slots, with as many
decode dispatches (the chunk policy is JAX's). Then the port against
its own synchronous scan_k=1 loop (which tests/test_torch_engine.py
holds to JAX): paged and dense pools x fp32/int8/int4 KV x scan_k 2 and
8 x pipeline on and off give the same tokens; a mid-chunk eos truncates
exactly, with no slot or block leaked; rows whose prompt plus budget
fill max_len overrun it under a chunk without error or corruption. Last
the guards (busy-engine warmups, scan_k 0) and the serve CLI with
--scan_k and --warmup=full answering one HTTP request. Sizes are
tests/test_torch_engine.py's: 2 layers, n_embd 32, block_size 64, fp32
weights carried over from the JAX init, on the CPU.
"""

import json
import threading
import urllib.request
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu_torch.checkpoint import save_for_serving
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.serve.__main__ import build_server
from nanosandbox_tpu_torch.serve.engine import Engine, scan_ladder

DIMS = dict(n_layer=2, n_head=2, n_embd=32, block_size=64, vocab_size=50)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mixed_reqs(n=10, seed=0, vocab=50, eos=None):
    """tests/test_scan_decode.py's workload: (prompt of 2-39 tokens, 2-11
    new tokens, seed, eos) per request, greedy."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(2, 40))).tolist(),
             int(rng.integers(2, 12)), int(rng.integers(0, 99)), eos)
            for _ in range(n)]


# Two sampled rows on top: one that filters (top_k), so the filtering
# program runs beside the plain one, and one that does not.
SAMPLED = [([7, 3, 9, 1, 4], 9, dict(temperature=0.9, top_k=5, seed=3)),
           ([2, 8, 6], 7, dict(temperature=0.7, seed=4))]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGPTConfig(**DIMS, dropout=0.0, compute_dtype="float32",
                        attention_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jmodel, params, model


def _run(engine, reqs, sampled=()):
    """Submit everything, drain; {submit index: (tokens, reason)}."""
    rids = [engine.submit(p, m, seed=s, eos_id=e) for p, m, s, e in reqs]
    rids += [engine.submit(p, m, **kw) for p, m, kw in sampled]
    res = {r.rid: (r.tokens, r.finish_reason) for r in engine.drain()}
    assert len(res) == len(rids)
    return [res[r] for r in rids]


def test_scan_pipeline_matches_jax_engine(models):
    jmodel, params, model = models
    reqs = _mixed_reqs(seed=3)
    jeng = JaxEngine(jmodel, params, num_slots=4, max_len=64, scan_k=4)
    eng = Engine(model, num_slots=4, max_len=64, scan_k=4, device="cpu")
    assert eng.pipeline and jeng.pipeline and eng.paged
    assert _run(eng, reqs) == _run(jeng, reqs)
    assert eng.scan_rungs == jeng.scan_rungs == [1, 2, 4]
    assert eng.host_dispatches["decode"] == jeng.host_dispatches["decode"]
    st = eng.stats()
    assert st["host_dispatches"] == {"decode": eng.steps}
    assert st["tokens_per_dispatch"] == pytest.approx(
        eng.tokens_generated / eng.steps)
    assert st["tokens_per_dispatch"] > 1


_SYNC: dict = {}


def _sync_tokens(model, paged, kv_dtype):
    """The port's synchronous scan_k=1 loop on the mixed workload and
    the sampled rows, once per (pool, kv mode)."""
    key = (paged, kv_dtype)
    if key not in _SYNC:
        eng = Engine(model, num_slots=4, max_len=64, paged=paged,
                     kv_dtype=kv_dtype, pipeline=False, device="cpu")
        _SYNC[key] = _run(eng, _mixed_reqs(seed=3), SAMPLED)
    return _SYNC[key]


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("scan_k", [2, 8])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("paged", [True, False])
def test_modes_match_sync_loop(models, paged, kv_dtype, scan_k, pipeline):
    model = models[2]
    eng = Engine(model, num_slots=4, max_len=64, paged=paged,
                 kv_dtype=kv_dtype, scan_k=scan_k, pipeline=pipeline,
                 device="cpu")
    assert _run(eng, _mixed_reqs(seed=3), SAMPLED) == _sync_tokens(
        model, paged, kv_dtype)
    assert eng.chunk_steps > eng.steps       # some chunks ran > 1 step
    st = eng.stats()
    assert st["scan_k"] == scan_k and st["pipeline"] == pipeline
    assert st["scan_rungs"] == scan_ladder(scan_k)
    assert st["graph_replays"] == {} and st["graph_pool_bytes"] is None


def _no_leaks(eng):
    assert not eng._active and eng._inflight is None
    assert eng.sched.free_slots == eng.num_slots
    if eng.paged:
        eng.block_pool.check([])
        assert not eng._table.ne(eng.kv_pool_blocks).any()
    assert not eng._live.any() and not eng._pos.any()


def test_mid_chunk_eos_truncates_exactly_no_leaks(models):
    """tests/test_scan_decode.py's: the most common mid-stream token as
    eos cuts rows exactly where the synchronous loop stops them."""
    model = models[2]
    reqs0 = _mixed_reqs(n=12, seed=11)
    free = _run(Engine(model, num_slots=4, max_len=64, pipeline=False,
                       device="cpu"), reqs0)
    eos = Counter(t for toks, _ in free for t in toks[:-1]).most_common(1)
    reqs = [(p, m, s, eos[0][0]) for p, m, s, _ in reqs0]
    base = _run(Engine(model, num_slots=4, max_len=64, pipeline=False,
                       device="cpu"), reqs)
    eng = Engine(model, num_slots=4, max_len=64, scan_k=8, device="cpu")
    assert _run(eng, reqs) == base
    assert any(reason == "eos" for _, reason in base)
    _no_leaks(eng)


@pytest.mark.parametrize("paged", [True, False])
def test_overrun_at_max_len(models, paged):
    """Rows with prompt + budget == max_len ride chunks (and the
    pipeline's lag) past their last position beside longer-lived rows:
    nothing raises, their tokens and the next round's (reusing the
    slots) equal the synchronous loop's."""
    model = models[2]
    L = 48
    rng = np.random.default_rng(5)
    rounds = [[(rng.integers(0, 50, plen).tolist(), L - plen, 0, None)
               for plen in (40, 44, 45)] + [([1, 2, 3], 40, 0, None)],
              [(rng.integers(0, 50, plen).tolist(), L - plen, 0, None)
               for plen in (20, 47, 3, 30)]]

    def run(**kw):
        eng = Engine(model, num_slots=4, max_len=L, paged=paged,
                     device="cpu", **kw)
        out = [_run(eng, reqs) for reqs in rounds]
        _no_leaks(eng)
        return out

    got = run(scan_k=8)
    assert got == run(pipeline=False)
    assert all(len(toks) == m for rnd, reqs in zip(got, rounds)
               for (toks, _), (_, m, _, _) in zip(rnd, reqs))


def test_busy_engine_guards_and_names(models):
    model = models[2]
    with pytest.raises(ValueError, match="scan_k"):
        Engine(model, max_len=64, scan_k=0, device="cpu")
    with pytest.raises(ValueError, match="decode impl"):
        Engine(model, max_len=64, decode_impl="mosaic", device="cpu")
    for name, resolved in (("auto", "pallas"), ("pallas", "pallas"),
                           ("xla", "xla"),
                           ("pallas_interpret", "pallas_interpret")):
        eng = Engine(model, num_slots=2, max_len=64, scan_k=4,
                     decode_impl=name, device="cpu")
        assert eng.stats()["decode_attention_impl"] == resolved
    assert eng.max_programs() == {"decode": 0}      # nothing captured
    eng.submit([1, 2, 3], 20)
    eng.step()
    assert eng.has_work() and eng._inflight is not None
    with pytest.raises(RuntimeError, match="busy"):
        eng.warm_scan_rungs()
    with pytest.raises(RuntimeError, match="busy"):
        eng.reset_prefix_cache()
    done = eng.drain()
    assert [len(r.tokens) for r in done] == [20]
    eng.warm_scan_rungs()                           # idle again
    eng.reset_prefix_cache()
    assert eng.block_pool.stats()["trie_blocks"] == 0


def test_serve_cli_scan_k_and_full_warmup(models, tmp_path):
    model = models[2]
    save_for_serving(str(tmp_path), model.cfg, model.state_dict())
    server, loop, engine = build_server([
        f"--out_dir={tmp_path}", "--host=127.0.0.1", "--port=0",
        "--num_slots=2", "--max_len=64", "--scan_k=4", "--warmup=full",
        "--decode_impl=xla", "--device=cpu"])
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # The warmup left nothing behind: no request, no cached prefix.
        st = engine.stats()
        assert st["completed"] > 0 and st["active"] == 0
        assert st["kv_pool"]["trie_blocks"] == 0
        assert st["ttft_s"] is None
        body = json.dumps({"prompt_tokens": [4, 5, 6], "max_new_tokens": 9,
                           "temperature": 0.0}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=body), timeout=60) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert len(out["tokens"]) == 9 and out["finish_reason"] == "length"
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["scan_k"] == 4 and st["pipeline"] is True
        assert st["decode_attention_impl"] == "xla"
        assert st["scan_rungs"] == [1, 2, 4]
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=10)
        th.join(timeout=10)
    assert not loop.is_alive() and not th.is_alive()
    ref = Engine(model, num_slots=2, max_len=64, pipeline=False,
                 device="cpu")
    assert out["tokens"] == _run(ref, [([4, 5, 6], 9, 0, None)])[0][0]
