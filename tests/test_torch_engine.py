"""The port's serving engine against the JAX package's Engine.

Greedy outputs of the port's Engine(device="cpu") must be token-identical
to the JAX Engine's on the tiny fp32 model (num_slots=2, max_len=64,
page 16), over 4 prompts of which two share a 32-token prefix, so the
second is admitted as a prefix hit. The same holds for the dense pool
(paged=False) at fp32 and int8 and for int8 and int4 paged pools, on a
mixed continuous batch (6 prompts of 1-39 tokens, 2-11 new tokens each,
through 4 slots), against the JAX Engine with its Pallas kernels in
interpret mode. Then the sampling contract: a seed replays, top_k=1 is
greedy, a request's tokens do not depend on its batch, and the per-row
filter equals the JAX filter. Last, one HTTP round trip on an ephemeral
port.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.sample import _filter_logits_rows
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.sample import filter_logits_rows
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.http import EngineLoop, make_server

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
_R = np.random.default_rng(11)
SHARED = [int(t) for t in _R.integers(0, 65, 32)]
WAVES = [
    [SHARED + [int(t) for t in _R.integers(0, 65, 8)],
     [int(t) for t in _R.integers(0, 65, 20)]],
    # After the first wave drains, its prompt blocks sit in the prefix
    # cache: the first prompt here re-uses SHARED's two full blocks.
    [SHARED + [int(t) for t in _R.integers(0, 65, 5)],
     [int(t) for t in _R.integers(0, 65, 9)]],
]
NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny models gain nothing from torch's full intra-op thread pool,
    and the suite's other workers run timing-sensitive tests beside
    these; two threads keep this module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(engine, waves, **kw):
    """Submit wave by wave, draining between; tokens in submit order."""
    out = []
    for wave in waves:
        rids = [engine.submit(p, NEW, **kw) for p in wave]
        done = {r.rid: r.tokens for r in engine.drain()}
        out += [done[r] for r in rids]
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = JaxGPTConfig(**DIMS, compute_dtype="float32",
                        attention_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jmodel, params, model


@pytest.fixture(scope="module")
def engine(models):
    return Engine(models[2], num_slots=2, max_len=64, kv_page_size=16,
                  device="cpu")


def test_greedy_tokens_identical_to_jax_engine(models, engine):
    jmodel, params, _ = models
    jeng = JaxEngine(jmodel, params, num_slots=2, max_len=64,
                     kv_page_size=16)
    ref = _run(jeng, WAVES)
    got = _run(engine, WAVES)
    assert got == ref
    assert all(len(t) == NEW for t in got)
    assert engine.stats()["kv_pool"]["prefix_hit_requests"] >= 1
    assert jeng.stats()["kv_pool"]["prefix_hit_tokens"] > 0


def _run_mixed(engine, n=6, seed=0):
    """tests/test_flash_decode.py's mixed batch: n greedy requests of
    1-39 prompt tokens and 2-11 new tokens, submitted together."""
    rng = np.random.default_rng(seed)
    rids = [engine.submit(rng.integers(0, 50, int(rng.integers(1, 40)))
                          .tolist(), int(rng.integers(2, 12)))
            for _ in range(n)]
    res = {r.rid: r for r in engine.drain()}
    return [res[r].tokens for r in rids]


@pytest.mark.parametrize("kv_dtype,paged", [
    ("fp32", False), ("int8", True), ("int4", True), ("int8", False)])
def test_pools_and_kv_modes_match_jax_engine(models, kv_dtype, paged):
    jmodel, params, model = models
    kw = dict(num_slots=4, max_len=64, kv_dtype=kv_dtype, paged=paged)
    jeng = JaxEngine(jmodel, params, decode_impl="pallas_interpret", **kw)
    eng = Engine(model, device="cpu", **kw)
    assert _run_mixed(eng) == _run_mixed(jeng)
    st = eng.stats()
    assert st["paged"] == paged and st["kv_dtype"] == kv_dtype
    assert st["completed"] == 6


def test_sampling_seed_replays(engine):
    kw = dict(temperature=0.8, top_k=20, seed=7)
    a = _run(engine, [WAVES[1]], **kw)
    b = _run(engine, [WAVES[1]], **kw)
    c = _run(engine, [WAVES[1]], **dict(kw, seed=8))
    assert a == b
    assert a != c


def test_top_k_one_is_greedy(engine):
    greedy = _run(engine, [WAVES[0]])
    assert _run(engine, [WAVES[0]], temperature=1.0, top_k=1,
                seed=3) == greedy


def test_sampled_tokens_do_not_depend_on_the_batch(engine):
    prompt = WAVES[0][1]
    kw = dict(temperature=0.9, top_p=0.9, seed=5)
    alone = _run(engine, [[prompt]], **kw)[0]
    rid = engine.submit(WAVES[0][0], NEW, temperature=0.7, seed=1)
    mine = engine.submit(prompt, NEW, **kw)
    done = {r.rid: r.tokens for r in engine.drain()}
    assert rid in done and done[mine] == alone


def test_filter_matches_jax_filter():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(5, 50)).astype(np.float32) * 3
    t = np.array([0.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    k = np.array([0, 5, 0, 40, 1], np.int32)
    p = np.array([1.0, 1.0, 0.8, 0.5, 0.9], np.float32)
    ref = np.asarray(_filter_logits_rows(jnp.asarray(logits),
                                         temperature=jnp.asarray(t),
                                         top_k=jnp.asarray(k),
                                         top_p=jnp.asarray(p)))
    out = filter_logits_rows(torch.from_numpy(logits),
                             temperature=torch.from_numpy(t),
                             top_k=torch.from_numpy(k),
                             top_p=torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(out <= -1e29, ref <= -1e29)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_http_generate_and_healthz(models):
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    loop = EngineLoop(eng)
    loop.start()
    server = make_server("127.0.0.1", 0, loop)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = json.dumps({"prompt_tokens": WAVES[0][1],
                           "max_new_tokens": 5, "temperature": 0.0}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/generate", data=body), timeout=60) as r:
            assert r.status == 200
            out = json.loads(r.read())
        assert len(out["tokens"]) == 5 and out["finish_reason"] == "length"
        assert out["text"] is None and out["id"] == 0
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            assert json.loads(r.read())["tokens_generated"] == 5
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=10)
        th.join(timeout=10)
    assert not loop.is_alive() and not th.is_alive()
