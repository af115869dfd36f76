"""Tensor-parallel serving of the port against tp 1 and the JAX package.

One module-scoped tiny fp32 model (JAX's tests/test_tp_serve.py
served_model: 2 layers, 2 heads, n_embd 32, vocab 50, JAX's init),
converted to the port. On the CPU:

  * over JAX's PARITY_CASES (paged / dense x fp32 / int8 / int4 x scan_k
    1 / 4 x NGram spec on / off), the port's Engine(tp=2) gives exactly
    the tokens of the port's tp 1 engine and of the JAX package's tp 1
    Engine (JAX's own test holds its tp 2 to its tp 1), and captures as
    many programs (max_programs) as tp 1. The JAX engine prefills in one
    bucket (64): bucketing only pads a prompt, so its tokens are the
    default ladder's, and it compiles 2 prefill programs instead of 5;
  * sampled decode is placement-independent too;
  * a supervised poisoned step and a forced preemption under tp 2
    restitch to a clean tp 2 run's tokens, the pool zeroed in place;
  * read_pool_blocks gives tp 1's payload (heads in shard order): blocks
    move between tp 2 and tp 1 engines both ways, and a disaggregated
    pair with a tp 2 prefill tier and a tp 1 decode tier gives the
    colocated engine's tokens;
  * JAX's ValueErrors (tp < 1, n_head % tp, a device drafter), the
    cross-card refusal, stats()["tp"] and the serve_tp_degree gauge;
  * the pieces: a head-sharded attention call with dropout keeps the
    one-process call's masks for its heads (and JAX's), and the shard /
    gather of parallel/tensor.py round-trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.ops import attention as jattn
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu.serve import NGramDrafter as JaxNGram
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT, shard_for_serving
from nanosandbox_tpu_torch.obs import render_prometheus
from nanosandbox_tpu_torch.ops import attention as tattn
from nanosandbox_tpu_torch.parallel import tensor
from nanosandbox_tpu_torch.serve.disagg import DisaggPair
from nanosandbox_tpu_torch.serve.drafters import NGramDrafter
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.faults import FaultPlan
from nanosandbox_tpu_torch.serve.recovery import EngineSupervisor
from test_tp_serve import PARITY_CASES, _mixed_reqs

DIMS = dict(n_layer=2, n_head=2, n_embd=32, block_size=64, vocab_size=50)
KW = dict(num_slots=4, max_len=64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """(JAX model, its params, the port's GPT of the same weights)."""
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


def _port(model, reqs, *, tp, spec=False, **kw):
    eng = Engine(model, tp=tp, spec=NGramDrafter(k=3) if spec else None,
                 device="cpu", **KW, **kw)
    for prompt, mnt, seed, eos in reqs:
        eng.submit(prompt, mnt, seed=seed, eos_id=eos)
    out = {r.rid: (r.tokens, r.finish_reason) for r in eng.drain()}
    assert len(out) == len(reqs)
    return eng, out


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_tp_greedy_parity_with_tp1_and_jax(served, case):
    jmodel, params, model = served
    reqs = _mixed_reqs(seed=3)
    kw = dict(PARITY_CASES[case])
    spec = kw.pop("spec", False)
    e1, base = _port(model, reqs, tp=1, spec=spec, **kw)
    e2, out = _port(model, reqs, tp=2, spec=spec, **kw)
    assert out == base, f"tp=2 diverged from tp=1 under {case}"
    assert e2.tracecheck.counts() == e1.tracecheck.counts()
    assert e2.stats()["tp"] == 2 and e1.stats()["tp"] == 1
    jeng = JaxEngine(jmodel, params, spec=JaxNGram(k=3) if spec else None,
                     prefill_buckets=[64], **KW, **kw)
    for prompt, mnt, seed, eos in reqs:
        jeng.submit(prompt, mnt, seed=seed, eos_id=eos)
    want = {r.rid: (r.tokens, r.finish_reason) for r in jeng.drain()}
    assert out == want, f"port tp=2 diverged from JAX under {case}"


def test_tp_sampled_parity(served):
    model = served[2]

    def sampled(tp):
        eng = Engine(model, tp=tp, device="cpu", **KW)
        rng = np.random.default_rng(5)
        for i in range(6):
            eng.submit(rng.integers(0, 50, int(rng.integers(2, 30))).tolist(),
                       6, temperature=0.9, top_k=20, top_p=0.95, seed=i)
        return {r.rid: r.tokens for r in eng.drain()}

    assert sampled(2) == sampled(1)


def test_tp_recovery_and_preemption_restitch(served):
    """A poisoned step under tp 2 recovers through the supervisor (the
    pool zeroed in place: the same tensors, each shard's slice) and a
    forced preemption requeues: both end with a clean tp 2 run's
    tokens."""
    model = served[2]
    reqs = _mixed_reqs(n=6, seed=7)
    _, clean = _port(model, reqs, tp=2)
    eng = Engine(model, tp=2, faults=FaultPlan.parse("nan_logits@3"),
                 device="cpu", **KW)
    pool = [buf.data_ptr() for layer in eng._pool for buf in layer]
    sup = EngineSupervisor(eng, backoff_base_s=0)
    for prompt, mnt, seed, eos in reqs:
        eng.submit(prompt, mnt, seed=seed, eos_id=eos)
    out = []
    while eng.has_work() and sup.state != "failed":
        out.extend(sup.step())
    assert sup.state == "ok" and eng.recoveries >= 1
    assert {r.rid: (r.tokens, r.finish_reason) for r in out} == clean
    assert [buf.data_ptr() for layer in eng._pool for buf in layer] == pool
    assert eng._pool[0][0].shape[:3] == (2, eng.kv_pool_blocks + 1, 1)

    reqs = [(list(range(2, 2 + 8)), 10, s, None) for s in range(5)]
    _, clean = _port(model, reqs, tp=2)
    eng, out = _port(model, reqs, tp=2,
                     faults=FaultPlan.parse("preempt_storm@4x2"))
    assert eng.preemptions >= 1 and out == clean


def test_tp_pool_blocks_move_between_degrees(served):
    """read_pool_blocks of a tp 2 engine is tp 1's payload for the same
    prompt (heads in shard order, each leaf (n, H, ...)); written into
    the other degree's pool it reads back unchanged, both ways; a
    disaggregated pair with a tp 2 prefill tier and a tp 1 decode tier
    gives the colocated engine's tokens."""
    model = served[2]
    prompt = list(range(3, 3 + 40))
    engines = {}
    for tp in (1, 2):
        eng = Engine(model, tp=tp, device="cpu", **KW)
        eng.submit(prompt, 2)
        eng.drain()
        engines[tp] = eng
    ids = list(range(2))
    pay = {tp: e.read_pool_blocks(ids) for tp, e in engines.items()}
    for a, b in zip(pay[1], pay[2]):
        assert a.shape == b.shape == (2, 2, 16, 16)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for src, dst in ((1, 2), (2, 1)):
        engines[dst].write_pool_blocks([5, 6], pay[src])
        for a, b in zip(engines[dst].read_pool_blocks([5, 6]), pay[src]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        engines[2].write_pool_blocks([5], [x[:, :1] for x in pay[1]])

    reqs = [(r[0], r[1], dict(seed=r[2])) for r in _mixed_reqs(seed=11)]
    colocated = Engine(model, device="cpu", **KW)
    rids = [colocated.submit(p, n, **kw) for p, n, kw in reqs]
    want = {r.rid: r.tokens for r in colocated.drain()}
    pair = DisaggPair(model, prefill_tp=2, device="cpu", **KW)
    assert (pair.prefill.tp, pair.decode.tp) == (2, 1)
    prids = [pair.submit(p, n, **kw) for p, n, kw in reqs]
    got = {r.rid: r.tokens for r in pair.drain()}
    assert [got[r] for r in prids] == [want[r] for r in rids]
    assert pair.stats()["migrations"] >= 1


def test_tp_validation_metrics_and_stats(served, tmp_path):
    """JAX's constructor ValueErrors, message for message; shards across
    cards are not ported; the posture shows in stats(), /debug/kvpool
    and the serve_tp_degree gauge, and the serve CLI takes --tp."""
    from nanosandbox_tpu_torch.serve.__main__ import build_parser

    jmodel, params, model = served

    class FakeDeviceDrafter:
        kind = "device"
        k = 3

    for kw in (dict(tp=3), dict(tp=0),
               dict(tp=2, spec=FakeDeviceDrafter())):
        with pytest.raises(ValueError) as want:
            JaxEngine(jmodel, params, num_slots=2, max_len=32, **kw)
        with pytest.raises(ValueError) as got:
            Engine(model, num_slots=2, max_len=32, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="across cards"):
        Engine(model, num_slots=2, max_len=32, device="cpu", tp=2,
               tp_devices=["cuda:0", "cuda:1"])
    eng, _ = _port(model, _mixed_reqs(n=2, seed=1), tp=2)
    assert eng.stats()["tp"] == 2 and eng.debug_kvpool()["tp"] == 2
    assert "serve_tp_degree 2" in render_prometheus(eng.metrics)
    dense = Engine(model, num_slots=2, max_len=32, device="cpu", tp=2,
                   paged=False)
    assert dense.debug_kvpool() == {"paged": False, "tp": 2}
    assert build_parser().parse_args(["--tp=2"]).tp == 2


def test_head_sharded_dropout_keeps_the_one_process_masks():
    """Shard i of 2 holds heads [2i, 2i+2) of 4: with the head offset in
    its seed words and the global head count as the sixth, its dropout
    attention is the whole call's for those heads, forward and backward,
    and its mask is JAX's for the same words."""
    B, H, T, D = 2, 4, 128, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, T, D, generator=g, requires_grad=True)
               for _ in range(3))
    full = tattn.flash_attention_dropout(q, k, v, [9], dropout_rate=0.2)
    full.sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for i in range(2):
        hs = slice(2 * i, 2 * i + 2)
        qs, ks, vs = (t.detach()[:, hs].clone().requires_grad_()
                      for t in (q, k, v))
        words = [9, 0, 2 * i, 0, 0, H]
        out = tattn.flash_attention_dropout(qs, ks, vs, words,
                                            dropout_rate=0.2)
        torch.testing.assert_close(out, full[:, hs], rtol=0, atol=1e-6)
        out.sum().backward()
        for t, ref in zip((qs, ks, vs), grads):
            torch.testing.assert_close(t.grad, ref[:, hs], rtol=0,
                                       atol=1e-6)
        o, _ = tattn.flash_attention_lse_dropout(
            qs.detach(), ks.detach(), vs.detach(), [9, 0, 2 * i, 0, 0],
            True, None, 0.2, hash_heads=H)
        torch.testing.assert_close(o, full[:, hs].detach(), rtol=0,
                                   atol=1e-6)
        mask = tattn.hash_dropout_keep_mask(words, B, 2, T, T, rate=0.2)
        want = jattn.hash_dropout_keep_mask(
            jnp.asarray(words[:5], jnp.uint32), B, 2, T, T, rate=0.2,
            hash_heads=H)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_shards_round_trip(served):
    """shard_state_dict then unshard_param is the identity at tp 2 and
    4; the single-controller model holds shard i's weights in its
    shard i, the embeddings and LayerNorms once."""
    model = served[2]
    sd = model.state_dict()
    for tp in (2, 4):
        shards = [tensor.shard_state_dict(sd, tp, i) for i in range(tp)]
        for n, t in sd.items():
            assert torch.equal(tensor.unshard_param(
                n, [s[n] for s in shards]), t), (tp, n)
    sharded = shard_for_serving(model, 2)
    mine = sharded.state_dict()
    assert torch.equal(mine["h.1.attn.1.c_attn.weight"],
                       tensor.shard_param("h.1.attn.c_attn.weight",
                                          sd["h.1.attn.c_attn.weight"], 2, 1))
    assert torch.equal(mine["h.0.mlp.0.c_proj.weight"],
                       sd["h.0.mlp.c_proj.weight"][:, :64])
    assert torch.equal(mine["wte.weight"], sd["wte.weight"])
    assert "h.0.ln_1.weight" in mine and "h.0.attn.1.ln_1.weight" not in mine
    assert sum(p.numel() for p in sharded.parameters()) == sum(
        p.numel() for p in model.parameters())     # no bias: nothing twice
