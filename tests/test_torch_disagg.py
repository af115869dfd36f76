"""Disaggregated prefill/decode on the port, against the colocated port
engine and the JAX package.

On the tiny fp32 model (2 layers, n_embd 64, vocab 65; a seeded init with
its matrices x 8, so greedy streams vary), on the CPU:

  * DisaggPair gives the colocated Engine's tokens, greedy and sampled,
    over fp32 / int8 / int4 pools at scan_k 1 and 4; the decode tier
    calls no K1 (the model's flash_prefill_paged) and dispatches no
    prefill, and its K2 (flash_decode_paged) runs;
  * a replica_down kill in the migration window ends every request
    once, with the same tokens; a deadline in limbo sheds without
    donation; adoption backpressure returns None and reparks;
  * the adopting BlockPool's ledger and refcounts follow JAX's BlockPool
    fed the same operations;
  * the wire payload round-trips (bf16 leaves through torch), and
    crosses packages: a JAX fp32 engine's export adopted by a port
    engine decodes the JAX colocated engine's greedy tokens, and the
    port's payload for the same request has JAX's keys, leaf shapes and
    dtype names (and JAX adopts it).
"""

import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu.serve.disagg import adopt_from_wire as jax_adopt
from nanosandbox_tpu.serve.disagg import export_to_wire as jax_export
from nanosandbox_tpu.serve.paged import BlockPool as JaxBlockPool
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models import gpt as tgpt
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.obs.flight import TERMINAL_EVENTS
from nanosandbox_tpu_torch.serve.disagg import (DisaggPair, adopt_from_wire,
                                                export_to_wire, leaf_from_wire,
                                                leaf_to_wire)
from nanosandbox_tpu_torch.serve.engine import Engine, Request
from nanosandbox_tpu_torch.serve.faults import FaultPlan
from nanosandbox_tpu_torch.serve.paged import BlockPool

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
KW = dict(num_slots=4, max_len=64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    m = GPT(GPTConfig(**DIMS, compute_dtype="float32"),
            generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 2:
                p.mul_(8)
    return m


def _requests(n=8, seed=0):
    """Greedy and sampled (top-k, top-p) requests of 2-29 prompt tokens
    and 1-11 new ones, one with an eos."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kw = {"seed": i}
        if i % 2:
            kw.update(temperature=0.8, top_k=5 if i % 3 else 0,
                      top_p=0.9 if i % 3 == 0 else 1.0)
        if i == 4:
            kw["eos_id"] = 3
        out.append((rng.integers(0, 65, int(rng.integers(2, 30))).tolist(),
                    1 if i == 6 else int(rng.integers(3, 12)), kw))
    return out


def _serve(eng, reqs):
    """Submit every request, drain; (tokens, finish reason) in submit
    order, each rid ending once."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    out = eng.drain()
    assert sorted(str(r.rid) for r in out) == sorted(str(r) for r in rids)
    got = {r.rid: (r.tokens, r.finish_reason) for r in out}
    return [got[r] for r in rids]


def _exactly_once(events):
    """Every namespaced rid that entered an engine (submit or adopt) ends
    once, or hands off (migrate) and ends nowhere on that engine."""
    terms, entered, migrated = Counter(), set(), set()
    for e in events:
        if e["ev"] in ("submit", "adopt"):
            entered.add(e["rid"])
        if e["ev"] in TERMINAL_EVENTS:
            terms[e["rid"]] += 1
        if e["ev"] == "migrate":
            migrated.add(e["rid"])
    for rid in entered:
        want = 0 if rid in migrated else 1
        assert terms[rid] == want, (rid, terms[rid], rid in migrated)


@pytest.fixture
def kernel_calls(monkeypatch):
    """K1 / K2 calls through the model, by the tier whose step made them
    (see _by_tier)."""
    calls = {"tier": None}
    for name, key in (("flash_prefill_paged", "K1"),
                      ("flash_decode_paged", "K2")):
        fn = getattr(tgpt, name)

        def counted(*a, _fn=fn, _key=key, **k):
            tier = calls["tier"] or "other"
            calls.setdefault(tier, Counter())[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tgpt, name, counted)
    return calls


def _by_tier(pair, calls):
    for name, eng in pair.engines.items():
        step = eng.step

        def tagged(_step=step, _name=name):
            calls["tier"] = _name
            try:
                return _step()
            finally:
                calls["tier"] = None

        eng.step = tagged


@pytest.mark.parametrize("kv", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("scan_k", [1, 4])
def test_pair_matches_colocated_engine(model, kernel_calls, kv, scan_k):
    reqs = _requests()
    want = _serve(Engine(model, kv_dtype=kv, scan_k=scan_k, **KW), reqs)
    pair = DisaggPair(model, kv_dtype=kv, scan_k=scan_k, **KW)
    _by_tier(pair, kernel_calls)
    assert _serve(pair, reqs) == want
    st = pair.stats()
    dec, pre = st["tiers"]["decode"], st["tiers"]["prefill"]
    # Every request but the one-token one and the eos-at-first-token ones
    # migrated, and the decode tier prefilled nothing.
    assert st["migrations"] == pair.decode.adopted == pre["migrated"] >= 6
    assert dec["prefill_waves"] == dec["prefill_chunks"] == 0
    assert kernel_calls["decode"]["K1"] == 0
    assert kernel_calls["decode"]["K2"] > 0
    assert kernel_calls["prefill"]["K1"] > 0
    assert st["fallbacks"] == 0 and st["limbo"] == 0
    _exactly_once(pair.merged_flight_events())
    for eng in pair.engines.values():
        eng.block_pool.check([])
    assert pair.decode.block_pool.stats()["adoptions"] == st["migrations"]


@pytest.mark.parametrize("kill_step", [0, 1, 3])
def test_replica_down_mid_migration_ends_each_request_once(model, kill_step):
    reqs = _requests(seed=1)
    want = _serve(Engine(model, **KW), reqs)
    pair = DisaggPair(model, faults=FaultPlan.parse(
        f"replica_down@{kill_step}"), **KW)
    assert _serve(pair, reqs) == want
    assert pair.replica_downs == 1 and pair.decode.failed
    assert pair.fallbacks >= 1
    _exactly_once(pair.merged_flight_events())
    pair.prefill.block_pool.check([])


def test_without_fallback_tier_loss_fails_once(model):
    reqs = _requests(seed=1)
    pair = DisaggPair(model, fallback=False,
                      faults=FaultPlan.parse("replica_down@1"), **KW)
    got = _serve(pair, reqs)
    assert any(reason == "failed" for _, reason in got)
    # An export failed without fallback ends in the pair's Result alone
    # (its engine records no terminal); no rid ends twice.
    terms = Counter(e["rid"] for e in pair.merged_flight_events()
                    if e["ev"] in TERMINAL_EVENTS)
    assert max(terms.values()) == 1


def test_limbo_deadline_shed_releases_without_donation(model):
    eng = Engine(model, role="prefill", **KW)
    rid = eng.submit(list(range(1, 40)), 8, migrate=True, deadline_s=0.05)
    while not eng.sched.limbo:
        assert eng.step() == []
    assert eng.debug_scheduler()["limbo_queue"][0]["rid"] == rid
    assert eng.has_work()
    import time
    time.sleep(0.08)
    (res,) = eng.step()
    assert (res.rid, res.finish_reason, res.tokens) == (rid, "shed", [])
    assert not eng.has_work() and eng.sched.limbo == 0
    ev = [e for e in eng.flight.events(rid=rid) if e["ev"] == "shed"]
    assert ev and ev[0]["limbo"] is True
    # Freed, not donated: nothing of the chain is cached.
    assert eng.prefix_summary()["digests"] == []
    assert eng.block_pool.free_blocks == eng.kv_pool_blocks
    eng.block_pool.check([])


def test_requeue_export_is_a_prefix_hit_with_the_same_first_token(model):
    """A fallback re-prefills over the export's own donated chain (K1 on
    the tail that did not hit) and samples the same first token; so does
    a recovery that catches the export in limbo (it exports again)."""
    prompt, kw = list(range(3, 43)), dict(temperature=0.8, top_k=7, seed=9)
    (want,) = _serve(Engine(model, **KW), [(prompt, 6, kw)])
    eng = Engine(model, role="prefill", **KW)
    rid = eng.submit(prompt, 6, migrate=True, **kw)
    while not eng.sched.limbo:
        eng.step()
    eng.recover("test")
    assert eng.sched.limbo == 0 and eng.sched.queued == 1
    while not eng.sched.limbo:
        eng.step()
    exp = eng.pop_export()
    assert exp.first_tok == want[0][0]
    eng.requeue_export(exp)
    (res,) = eng.drain()
    assert (res.rid, res.tokens, res.finish_reason) == (rid, *want)
    pre = [(e["prefix"], e["hit_tokens"]) for e in eng.flight.events(rid=rid)
           if e["ev"] == "prefill"]
    assert pre == [("miss", 0), ("hit", 32), ("hit", 32)]
    assert eng.flight.terminals(rid) == ["finish"]


def test_adoption_backpressure_returns_none_and_reparks(model):
    eng = Engine(model, role="decode", num_slots=1, max_len=64,
                 kv_pool_blocks=3, device="cpu")
    req = Request(rid=-1, prompt=tuple(range(20)), max_new_tokens=4)
    ad = eng.begin_adopt(req)
    assert ad is not None and ad.copy == [0, 1]
    assert eng.begin_adopt(req) is None              # no free slot
    eng.abort_adopt(ad)
    big = Request(rid=-1, prompt=tuple(range(40)), max_new_tokens=20)
    assert eng.begin_adopt(big) is None              # too few blocks
    stall = [e for e in eng.flight.events() if e["ev"] == "block_stall"]
    assert stall and stall[-1]["adopt"] is True
    eng.block_pool.check([])
    # In the pair: two decode slots for eight requests, so exports wait
    # in limbo and repark; the tokens are unchanged.
    reqs = _requests(seed=2)
    want = _serve(Engine(model, num_slots=2, max_len=64, device="cpu"),
                  reqs)
    pair = DisaggPair(model, num_slots=2, max_len=64, device="cpu")
    rids = [pair.submit(p, n, **kw) for p, n, kw in reqs]
    parked, got = 0, {}
    while pair.has_work():
        got.update((r.rid, (r.tokens, r.finish_reason))
                   for r in pair.step())
        parked = max(parked, pair.prefill.sched.limbo)
    assert parked > 0 and [got[r] for r in rids] == want


def _pool_ops(pool, rng, prompts):
    """A seeded mix of admit / adopt_chain / release on one BlockPool:
    the observable results, step by step."""
    live, log = [], []
    for i in range(60):
        op = int(rng.integers(0, 3))
        p = prompts[int(rng.integers(0, len(prompts)))]
        if op < 2 or not live:
            n = int(rng.integers(0, 9))
            if op == 0:
                a = pool.admit(p, n)
                got = None if a is None else (a.table, a.n_hit)
            else:
                r = pool.adopt_chain(p, n)
                a = None if r is None else r[0]
                got = None if r is None else (r[0].table, r[0].n_hit, r[1])
            if a is not None:
                live.append(a)
            log.append(got)
        else:
            a = live.pop(int(rng.integers(0, len(live))))
            log.append(pool.release(a, donate=bool(rng.integers(0, 4))))
        pool.check(live)
    st = pool.stats()
    keys = ("free", "cached", "live", "trie_blocks", "prefix_hit_tokens",
            "prefix_miss_tokens", "block_stall_steps", "evicted_blocks",
            "adoptions", "adopted_blocks")
    return log, {k: st[k] for k in keys}, sorted(pool.cache.digests())


def test_adopt_chain_ledger_matches_jax_block_pool():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 9, 48).tolist()
    prompts = [base[:n] + rng.integers(0, 9, k).tolist()
               for n, k in ((16, 3), (32, 5), (8, 20), (48, 1), (0, 30))]
    ours = _pool_ops(BlockPool(24, 8), np.random.default_rng(3), prompts)
    theirs = _pool_ops(JaxBlockPool(24, 8), np.random.default_rng(3),
                       prompts)
    assert ours == theirs
    assert ours[1]["adoptions"] > 0 and ours[1]["adopted_blocks"] > 0


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8", "int4"])
def test_wire_round_trip(model, kv):
    reqs = _requests(n=4, seed=4)
    want = _serve(Engine(model, kv_dtype=kv, **KW), reqs)
    src = Engine(model, kv_dtype=kv, role="prefill", **KW)
    dst = Engine(model, kv_dtype=kv, role="decode", **KW)
    for p, n, k in reqs:
        src.submit(p, n, migrate=True, **k)
    results = []
    while src.has_work() or dst.has_work():
        results += src.step()
        exp = src.pop_export()
        while exp is not None:
            wire = json.loads(json.dumps(export_to_wire(src, exp)))
            _, done = adopt_from_wire(dst, wire, src="prefill")
            src.complete_export(exp, dst="decode")
            if done is not None:
                results.append(done)
            exp = src.pop_export()
        results += dst.step()
    by_prompt = {r.prompt: (r.tokens, r.finish_reason) for r in results}
    assert len(results) == len(reqs) == len(by_prompt)
    assert [by_prompt[tuple(p)] for p, _, _ in reqs] == want
    assert dst.adopted >= 2 and dst.stats()["prefill_waves"] == 0


def test_a_payload_the_pool_cannot_take_unwinds(model):
    """An int8 payload offered to an fp32 pool, and a first token outside
    the vocabulary, raise and leave the adopting engine as it was (slot
    and blocks back, nothing cached)."""
    src = Engine(model, kv_dtype="int8", role="prefill", **KW)
    src.submit(list(range(2, 30)), 5, migrate=True)
    while not src.sched.limbo:
        src.step()
    wire = json.loads(json.dumps(export_to_wire(src, src.pop_export())))
    dst = Engine(model, role="decode", **KW)
    with pytest.raises(ValueError, match="payload has 8 leaves"):
        adopt_from_wire(dst, wire)
    dst8 = Engine(model, kv_dtype="int8", role="decode", **KW)
    with pytest.raises(ValueError, match="outside"):
        adopt_from_wire(dst8, dict(wire, first_tok=DIMS["vocab_size"]))
    for eng in (dst, dst8):
        assert eng.sched.free_slots == KW["num_slots"] and not eng._active
        assert eng.block_pool.free_blocks == eng.kv_pool_blocks
        eng.block_pool.check([])
    rid, _ = adopt_from_wire(dst8, wire)
    (res,) = dst8.drain()
    assert res.rid == rid and len(res.tokens) == 5


def test_leaf_wire_bits_round_trip():
    g = torch.Generator().manual_seed(0)
    for t in (torch.randn(3, 2, 4, 8, generator=g).to(torch.bfloat16),
              torch.randn(3, 2, 4, generator=g),
              torch.randint(-128, 127, (3, 2, 4, 8), dtype=torch.int8),
              torch.randint(0, 255, (3, 2, 4, 4), dtype=torch.uint8)):
        back = leaf_from_wire(json.loads(json.dumps(leaf_to_wire(t))))
        assert back.dtype == t.dtype and back.shape == t.shape
        assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    """One JAX fp32 engine (its colocated tokens and its export) and the
    port model on the same weights (x 8 matrices)."""
    jcfg = JaxGPTConfig(**DIMS, dropout=0.0, compute_dtype="float32",
                        attention_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a * 8 if a.ndim == 2 else a, params)
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    tmodel = GPT(cfg)
    tmodel.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return JaxEngine(jmodel, params, num_slots=2, max_len=64), tmodel


PROMPT, NEW = [7, 1, 22, 5, 9, 40, 3, 3, 17, 60, 2, 11, 4, 8, 30, 31, 5, 6,
               19, 27, 44], 10


def _export_one(eng):
    rid = eng.submit(PROMPT, NEW, migrate=True)
    while not eng.sched.limbo:
        assert eng.step() == []
    exp = eng.pop_export()
    assert exp.rid == rid
    return exp


def test_jax_payload_adopted_by_port_and_back(jax_pair):
    jeng, tmodel = jax_pair
    jeng.submit(PROMPT, NEW)
    (want,) = [r.tokens for r in jeng.drain()]
    assert len(set(want)) > 1
    jexp = _export_one(jeng)
    jwire = json.loads(json.dumps(jax_export(jeng, jexp)))
    jeng.complete_export(jexp, dst="decode")
    # The JAX payload, adopted by a port decode engine.
    dst = Engine(tmodel, num_slots=2, max_len=64, role="decode",
                 device="cpu")
    rid, done = adopt_from_wire(dst, jwire, src="jax")
    assert done is None
    (res,) = dst.drain()
    assert res.rid == rid and res.tokens == want
    # The port's payload for the same request: JAX's keys, shapes, dtype
    # names and first token; its values within fp32 rounding of JAX's.
    src = Engine(tmodel, num_slots=2, max_len=64, role="prefill",
                 device="cpu")
    texp = _export_one(src)
    twire = json.loads(json.dumps(export_to_wire(src, texp)))
    assert set(twire) == set(jwire)
    assert twire["first_tok"] == jwire["first_tok"] == want[0]
    assert twire["chain_blocks"] == jwire["chain_blocks"]
    assert ([(e["shape"], e["dtype"]) for e in twire["leaves"]]
            == [(e["shape"], e["dtype"]) for e in jwire["leaves"]])
    for t, j in zip(twire["leaves"], jwire["leaves"]):
        np.testing.assert_allclose(leaf_from_wire(t).numpy(),
                                   leaf_from_wire(j).numpy(),
                                   rtol=1e-5, atol=1e-5)
    # ... which the JAX engine adopts and decodes to its own tokens.
    got = jax_adopt(jeng, twire, src="torch")
    assert got is not None
    jrid, done = got
    assert done is None
    (jres,) = jeng.drain()
    assert jres.rid == jrid and jres.tokens == want
