"""The port's scheduling endgame against the JAX package's.

The host-side pieces operation by operation: the port's SlotScheduler
beside the JAX one on a seeded sequence of about 300 operations (mixed
priorities, waves capped by max_items and gated by an admit callback,
deadline sweeps, requeues, peeks, pops, slot takes and releases), every
result and queue view equal; the SLO ledger and the brownout controller
beside JAX's, driven by the same scripted finishes and sheds (JAX's
controller on a stub engine carrying its MetricRegistry and
FlightRecorder), levels and knobs equal after every poll.

Then the engine, on tests/test_torch_dispatch.py's model (2 layers,
n_embd 32, block_size 64, fp32 weights carried over from the JAX init,
on the CPU): chunked prefill at prefill_chunk 16, paged and dense,
gives the JAX Engine's unchunked tokens and finish reasons on
tests/test_sched.py's mixed workload; a prefix hit shortens the chunk
pipeline; a chunk that is not a bucket raises; decode tokens land
between a long prompt's chunks. Preemption, paged and dense, with the
same victim preempted twice, gives the JAX Engine's tokens without
preemption, leaks no resume record and no block. Then tests/test_sched.py's
wall-clock cases (the natural deadline preemption with donation, a
victim shed before its resume, priority defaults), the brownout ladder
on a live engine, and the serve CLI's new flags with the HTTP 429 path.
One JAX Engine serves every reference workload (the _WANT_CACHE pattern
of tests/test_sched.py).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.obs import FlightRecorder, MetricRegistry
from nanosandbox_tpu.obs.slo import SLOLedger as JaxSLOLedger
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu.serve.brownout import \
    BrownoutController as JaxBrownoutController
from nanosandbox_tpu.serve.scheduler import SlotScheduler as JaxScheduler
from nanosandbox_tpu_torch.checkpoint import save_for_serving
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.obs import FlightRecorder as TFlightRecorder
from nanosandbox_tpu_torch.obs import MetricRegistry as TMetricRegistry
from nanosandbox_tpu_torch.obs.slo import SLOLedger
from nanosandbox_tpu_torch.serve.__main__ import build_parser, build_server
from nanosandbox_tpu_torch.serve.brownout import LEVELS, BrownoutController
from nanosandbox_tpu_torch.serve.engine import PRIORITY_BY_CLASS, Engine
from nanosandbox_tpu_torch.serve.scheduler import SlotScheduler

DIMS = dict(n_layer=2, n_head=2, n_embd=32, block_size=64, vocab_size=50)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the scheduler, the SLO ledger and the brownout controller, op by op
# ---------------------------------------------------------------------------

class _Item:
    def __init__(self, rid, priority, plen):
        self.rid, self.priority, self.prompt = rid, priority, (0,) * plen


class _Bare:
    """An item without .priority: the scheduler's default class."""

    def __init__(self, rid, plen):
        self.rid, self.prompt = rid, (0,) * plen


def _rids(items):
    return [it.rid for it in items]


def test_scheduler_matches_jax_op_by_op():
    rng = np.random.default_rng(0)
    buckets = [8, 16, 32, 64]
    ours, theirs = SlotScheduler(4, buckets), JaxScheduler(4, buckets)
    popped, taken = [], []
    rid = 0

    def views(s):
        head = s.peek_head()
        return (s.queued, s.free_slots, _rids(s.queued_items()),
                None if head is None else head.rid,
                [s.queue_mass(p) for p in (-1, 0, 1, 2, 3, 5, 6)])

    for step in range(300):
        op = rng.choice(["enqueue"] * 4 + ["wave", "wave", "expire",
                                           "requeue", "pop", "take",
                                           "release"])
        if op == "enqueue":
            plen = int(rng.integers(1, 65))
            item = (_Bare(rid, plen) if rng.random() < 0.1 else
                    _Item(rid, int(rng.choice([0, 1, 2, 5])), plen))
            rid += 1
            got = [s.enqueue(item) for s in (ours, theirs)]
        elif op == "wave":
            max_items = [None, 1, 2, 3][int(rng.integers(4))]
            kw = {}
            if rng.random() < 0.5:      # a prefix hit of 8 tokens
                kw["bucket_of"] = lambda it: ours.bucket_for(
                    max(1, len(it.prompt) - 8))
            if rng.random() < 0.5:
                gate = int(rng.integers(2, 5))
                kw["admit"] = lambda it, g=gate: it.rid % g != 0
            waves = [s.next_admission_wave(max_items, **kw)
                     for s in (ours, theirs)]
            got = [None if w is None else (_rids(w[0]), w[1], w[2])
                   for w in waves]
            if waves[0] is not None:
                taken += waves[0][1]
                popped += waves[0][0]
        elif op == "expire":
            k, r = int(rng.integers(2, 6)), int(rng.integers(0, 6))
            got = [_rids(s.drain_expired(lambda it: it.rid % k == r))
                   for s in (ours, theirs)]
        elif op == "requeue":
            n = min(len(popped), int(rng.integers(0, 3)))
            back = popped[len(popped) - n:]
            del popped[len(popped) - n:]
            got = [s.requeue_front(back) for s in (ours, theirs)]
        elif op == "pop":
            if not ours.queued:
                continue
            a, b = ours.pop_head(), theirs.pop_head()
            assert a is b
            popped.append(a)
            got = [a.rid, b.rid]
        elif op == "take":
            if not ours.free_slots:
                continue
            got = [ours.take_slot(), theirs.take_slot()]
            taken.append(got[0])
        else:
            if not taken:
                continue
            slot = taken.pop(int(rng.integers(len(taken))))
            got = [s.release(slot) for s in (ours, theirs)]
        assert got[0] == got[1], (step, op, got)
        assert views(ours) == views(theirs), (step, op)
    assert rid > 60


def _finishes(rng, n, *, burn):
    """n scripted terminals: (kind, class, tokens, elapsed, deadline)."""
    out = []
    for _ in range(n):
        cls = str(rng.choice(["default", "batch", "interactive"]))
        deadline = None if rng.random() < 0.15 else 1.0
        late = rng.random() < (0.8 if burn else 0.02)
        if rng.random() < (0.3 if burn else 0.02):
            out.append(("shed", cls, 0, 0.0, deadline))
        else:
            out.append(("finish", cls, int(rng.integers(0, 20)),
                        1.5 if late else 0.5, deadline))
    return out


def _apply(ledger, event):
    kind, cls, tokens, elapsed, deadline = event
    if kind == "shed":
        return ledger.record_shed(cls)
    return ledger.record_finish(cls, tokens=tokens, elapsed_s=elapsed,
                                deadline_s=deadline)


def test_slo_ledger_matches_jax():
    rng = np.random.default_rng(1)
    ours_reg, theirs_reg = TMetricRegistry(), MetricRegistry()
    ours, theirs = SLOLedger(ours_reg), JaxSLOLedger(theirs_reg)
    for burn in (False, True, False):
        for event in _finishes(rng, 80, burn=burn):
            assert _apply(ours, event) == _apply(theirs, event)
            assert ours.totals() == theirs.totals()
            assert ours.stats() == theirs.stats()
        # The registry mirror renders the same text.
        assert ours_reg.prometheus_text() == theirs_reg.prometheus_text()
    ours.reset()
    theirs.reset()
    assert ours.stats() == theirs.stats() and ours.totals() == (0, 0, 0)
    assert ours_reg.prometheus_text() == theirs_reg.prometheus_text()


class _StubEngine:
    """What a controller reads and writes on an Engine, with the registry
    and flight recorder it publishes on."""

    def __init__(self, slo, scan_k, metrics, flight):
        self.slo, self.scan_k = slo, scan_k
        self.steps = self.brownout_sheds = 0
        self.scan_cap = self.brownout_min_priority = None
        self.spec_suspended = False
        self.metrics, self.flight = metrics, flight


@pytest.mark.parametrize("scan_k,kw", [
    (8, {}), (1, {}), (4, dict(check_interval_steps=2, min_window_events=1)),
    (4, dict(check_interval_steps=3, min_window_events=2, clear_checks=1,
             escalate_below=0.6, clear_above=0.9))])
def test_brownout_controller_matches_jax(scan_k, kw):
    rng = np.random.default_rng(scan_k + len(kw))
    reg, treg = MetricRegistry(), TMetricRegistry()
    ours = _StubEngine(SLOLedger(treg), scan_k, treg, TFlightRecorder())
    theirs = _StubEngine(JaxSLOLedger(reg), scan_k, reg, FlightRecorder())
    c_ours = BrownoutController(ours, **kw)
    c_theirs = JaxBrownoutController(theirs, **kw)
    seen = set()
    # Phases of burn and health, long enough to climb to the top and to
    # walk back down.
    for burn, steps in ((True, 120), (False, 260), (True, 60),
                        (False, 40), (True, 200), (False, 400)):
        for _ in range(steps):
            for eng in (ours, theirs):
                eng.steps += 1
            for event in _finishes(rng, int(rng.integers(0, 3)), burn=burn):
                for eng in (ours, theirs):
                    _apply(eng.slo, event)
                if event[0] == "shed" and rng.random() < 0.5:
                    for eng in (ours, theirs):
                        eng.brownout_sheds += 1
            c_ours.on_step()
            c_theirs.on_step()
            assert c_ours.level == c_theirs.level
            assert ((ours.scan_cap, ours.spec_suspended,
                     ours.brownout_min_priority)
                    == (theirs.scan_cap, theirs.spec_suspended,
                        theirs.brownout_min_priority))
            assert c_ours.stats() == c_theirs.stats()
            seen.add(c_ours.level)
    assert seen == set(range(len(LEVELS))), seen
    assert c_ours.transitions == c_theirs.transitions >= len(LEVELS) - 1
    # The level gauge, the transition counter and the flight events.
    assert treg.prometheus_text() == reg.prometheus_text()

    def events(eng):
        return [{k: v for k, v in e.items() if k not in ("t", "wall")}
                for e in eng.flight.events()]

    assert events(ours) == events(theirs)


# ---------------------------------------------------------------------------
# the engine against the JAX Engine
# ---------------------------------------------------------------------------

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


def _mixed(eng, n=6, seed=3, long_every=2, budget=None, long_len=60):
    """tests/test_sched.py's greedy mix with long prompts (the chunked
    lane's food), classes alternating interactive / batch."""
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(n):
        L = long_len if i % long_every == 0 else int(rng.integers(1, 40))
        mnt = budget if budget is not None else int(rng.integers(2, 5))
        cls = "interactive" if i % 2 == 0 else "batch"
        rids.append(eng.submit(rng.integers(0, DIMS["vocab_size"],
                                            L).tolist(), mnt, slo_class=cls))
    return rids


_WANT_CACHE: dict = {}
_JAX_ENGINE: list = []


def _want(models, **kw):
    """[(prompt, tokens, finish reason)] in submit order, from one JAX
    Engine (4 slots, no chunking, no preemption) shared by every
    workload of the module."""
    key = tuple(sorted(kw.items()))
    if key not in _WANT_CACHE:
        jmodel, params, _ = models
        if not _JAX_ENGINE:
            _JAX_ENGINE.append(JaxEngine(jmodel, params, num_slots=4,
                                         max_len=64))
        eng = _JAX_ENGINE[0]
        rids = _mixed(eng, **kw)
        done = {r.rid: (r.prompt, r.tokens, r.finish_reason)
                for r in eng.drain()}
        _WANT_CACHE[key] = [done[r] for r in rids]
    return _WANT_CACHE[key]


def _got(eng, rids, results):
    done = {r.rid: (r.prompt, r.tokens, r.finish_reason) for r in results}
    return [done[r] for r in rids]


def _no_leaks(eng):
    assert not eng._active and not eng._chunking and eng._inflight is None
    assert eng._resumed == {} and eng.sched.free_slots == eng.num_slots
    if eng.paged:
        eng.block_pool.check([])
        assert not eng._table.ne(eng.kv_pool_blocks).any()
    assert not eng._live.any()


@pytest.mark.parametrize("paged", [True, False])
def test_chunked_prefill_matches_jax_unchunked(models, paged):
    model = models[2]
    eng = Engine(model, num_slots=4, max_len=64, paged=paged,
                 prefill_chunk=16, device="cpu")
    rids = _mixed(eng, n=8)
    assert _got(eng, rids, eng.drain()) == _want(models, n=8)
    if paged:
        # Every 60-token prompt chunked: 3 x 16 + a 12-token piece.
        assert eng.prefill_chunks >= 4 * 4
    else:
        assert eng.prefill_chunks == 0      # dense paces whole waves
    _no_leaks(eng)
    plain = Engine(model, num_slots=4, max_len=64, paged=paged,
                   device="cpu")
    assert eng.tracecheck.counts() == plain.tracecheck.counts()
    assert len(eng._graphs) == len(plain._graphs)
    st = eng.stats()
    assert st["prefill_chunk"] == 16 and st["chunking"] == 0
    assert st["prefill_chunks"] == eng.prefill_chunks


def test_prefix_hit_shrinks_the_chunk_pipeline(models):
    """A resident prefix skips its pieces: a prompt sharing one 16-token
    block with a finished one chunks from position 16 (3 pieces against
    4), and the same prompt again prefills its 12-token suffix as one
    wave; outputs equal an engine's without chunking or cache."""
    model = models[2]
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 50, 60).tolist()
    shares = prompt[:16] + rng.integers(0, 50, 44).tolist()
    eng = Engine(model, num_slots=2, max_len=64, prefill_chunk=16,
                 device="cpu")
    pieces, out = [], []
    for p in (prompt, shares, prompt):
        n = eng.prefill_chunks
        eng.submit(p, 3)
        out.append(eng.drain()[0].tokens)
        pieces.append(eng.prefill_chunks - n)
    assert pieces == [4, 3, 0]
    st = eng.block_pool.stats()
    assert st["prefix_hit_requests"] == 2
    assert st["prefix_hit_tokens"] == 16 + 48
    ref = Engine(model, num_slots=2, max_len=64, prefix_cache=False,
                 device="cpu")
    for p in (prompt, shares):
        ref.submit(p, 3)
    assert [r.tokens for r in ref.drain()] == out[:2] and out[2] == out[0]


def test_chunk_must_be_a_bucket(models):
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(models[2], num_slots=2, max_len=64, prefill_chunk=17,
               device="cpu")


def test_chunks_interleave_with_decode(models):
    """While a 60-token prompt prefills in 16-token pieces, a decoding
    row takes tokens between its first piece and its last."""
    eng = Engine(models[2], num_slots=2, max_len=64, prefill_chunk=16,
                 device="cpu")
    dec = eng.submit([1, 2, 3], 30)
    for _ in range(4):
        eng.step()
    storm = eng.submit(np.random.default_rng(0).integers(0, 50, 60).tolist(),
                       2)
    trace = []              # (pieces so far, the decoding row's tokens)
    done = {}
    while eng.has_work():
        for r in eng.step():
            done[r.rid] = r
        row = next((st for st in eng._active.values()
                    if st.req.rid == dec), None)
        trace.append((eng.prefill_chunks,
                      len(row.tokens) if row else len(done[dec].tokens)))
    firsts = [i for i, (c, _) in enumerate(trace) if c >= 1]
    lasts = [i for i, (c, _) in enumerate(trace) if c == trace[-1][0]]
    first, last = firsts[0], lasts[0]
    assert trace[-1][0] >= 4 and last - first >= 3, trace
    assert trace[last][1] > trace[first][1], trace
    assert done[storm].finish_reason == "length"


def test_preemption_resumes_match_jax_unpreempted(models):
    """The same victim preempted twice, paged and dense: every request's
    prompt, tokens and finish reason equal the JAX Engine's run without
    preemption, the resume record is gone, no block leaks."""
    want = _want(models, n=4, seed=5, budget=12, long_len=48)
    for paged in (True, False):
        eng = Engine(models[2], num_slots=4, max_len=64, paged=paged,
                     device="cpu")
        rids = _mixed(eng, n=4, seed=5, budget=12, long_len=48)
        results, victim, steps = [], None, 0
        while eng.has_work():
            steps += 1
            if steps in (3, 6):
                if victim is None:      # JAX's storm rule: lowest first
                    victim = min(eng._active.values(), key=lambda s: (
                        s.req.priority, s.req.rid)).req.rid
                st = next(s for s in eng._active.values()
                          if s.req.rid == victim)
                eng._preempt(st)
                assert victim in eng._resumed
            results += eng.step()
        assert eng.preemptions == 2
        assert _got(eng, rids, results) == want, paged
        _no_leaks(eng)
        if paged:
            assert eng.block_pool.stats()["prefix_hit_requests"] >= 2


def test_natural_deadline_preemption_and_donation(models):
    """tests/test_sched.py's policy case: a deadline-carrying interactive
    head blocked on slots evicts a batch victim, whose generated blocks
    are donated and whose resume is a prefix hit; all three finish with
    the tokens of an unpreempted twin."""
    model = models[2]
    eng = Engine(model, num_slots=2, max_len=64, kv_page_size=4,
                 device="cpu")
    v1 = eng.submit(list(range(1, 9)), 40, slo_class="batch")
    v2 = eng.submit(list(range(2, 10)), 40, slo_class="batch")
    for _ in range(8):
        eng.step()
    donated = []                # blocks each preemption donated
    release = eng.block_pool.release

    def counted(alloc, **kw):
        n = release(alloc, **kw)
        if kw.get("generated"):
            donated.append(n)
        return n

    eng.block_pool.release = counted
    hi = eng.submit([7, 8, 9], 4, slo_class="interactive", deadline_s=0.05)
    res = {}
    while eng.has_work():
        res.update((r.rid, r) for r in eng.step())
    assert eng.preemptions >= 1
    # 8-token prompt + >= 8 generated at page 4: full blocks donated.
    assert donated[0] >= 1
    assert eng.block_pool.stats()["prefix_hit_requests"] >= 1
    twin = Engine(model, num_slots=4, max_len=64, device="cpu")
    t1 = twin.submit(list(range(1, 9)), 40)
    t2 = twin.submit(list(range(2, 10)), 40)
    t3 = twin.submit([7, 8, 9], 4)
    tw = {r.rid: r.tokens for r in twin.drain()}
    assert [res[v].tokens for v in (v1, v2, hi)] == [tw[t1], tw[t2], tw[t3]]
    assert res[v1].prompt == tuple(range(1, 9))
    assert eng.stats()["slo"]["classes"]["interactive"]["met"] \
        + eng.stats()["slo"]["classes"]["interactive"]["missed"] == 1
    _no_leaks(eng)


def test_preempted_victim_shed_before_readmission(models):
    """A preempted victim whose deadline expires before its resume sheds
    with its original prompt and the tokens it had; no resume record
    remains."""
    eng = Engine(models[2], num_slots=1, max_len=64, device="cpu")
    prompt = [3, 4, 5]
    victim = eng.submit(prompt, 30, slo_class="batch", deadline_s=0.25)
    for _ in range(6):
        eng.step()
    pre_tokens = list(next(iter(eng._active.values())).tokens)
    assert pre_tokens
    hi = eng.submit([6, 7], 24, slo_class="interactive", deadline_s=0.05)
    n = 0
    while eng.preemptions == 0 and n < 4000:
        eng.step()
        n += 1
    assert eng.preemptions >= 1 and victim in eng._resumed
    time.sleep(0.3)
    res = {}
    while eng.has_work():
        res.update((r.rid, r) for r in eng.step())
    assert res[victim].finish_reason == "shed"
    assert res[victim].prompt == tuple(prompt)
    assert res[victim].tokens[:len(pre_tokens)] == pre_tokens
    assert eng._resumed == {}
    assert res[hi].finish_reason in ("length", "shed")
    assert eng.stats()["shed"] >= 1
    assert eng.stats()["slo"]["classes"]["batch"]["shed"] == 1
    _no_leaks(eng)


def test_priority_defaults_from_class_and_override(models):
    eng = Engine(models[2], num_slots=1, max_len=64, device="cpu")
    eng.submit([1, 2], 30)                  # occupy the only slot
    eng.step()
    eng.submit([1, 3], 2, slo_class="batch")
    eng.submit([1, 4], 2, slo_class="interactive")
    eng.submit([1, 5], 2, slo_class="batch", priority=9)
    assert [it.priority for it in eng.sched.queued_items()] == [9, 2, 0]
    assert PRIORITY_BY_CLASS["interactive"] > PRIORITY_BY_CLASS["batch"]
    eng.submit([1, 6], 2, slo_class="bulk9")    # unknown: the default
    assert eng.sched.queued_items()[-2].priority == 1
    for bad, reason in (({"deadline_s": 0}, "bad_deadline"),
                        ({"slo_class": "no spaces"}, "bad_slo_class")):
        with pytest.raises(ValueError):
            eng.submit([1], 2, **bad)
        assert eng.rejected[reason] == 1
    assert eng.retry_after_s(slo_class="batch") \
        > eng.retry_after_s(slo_class="interactive") >= eng.retry_after_s()
    eng.drain()
    _no_leaks(eng)


def test_brownout_escalates_sheds_and_clears(models):
    """Sustained deadline burn climbs to shed_batch: a batch submission
    sheds at submit and a queued batch request sheds; the cap picks
    shorter chunks with the same tokens; healthy windows walk back to
    normal and the knobs reset."""
    model = models[2]
    eng = Engine(model, num_slots=2, max_len=64, scan_k=4, brownout=True,
                 device="cpu")
    ctl = eng.brownout
    ctl.check_interval_steps = 2
    ctl.min_window_events = 1
    rng = np.random.default_rng(0)
    for _ in range(12):
        eng.submit(rng.integers(0, 50, 5).tolist(), 6, deadline_s=1e-4,
                   slo_class="interactive")
        eng.drain()
        if ctl.level >= 3:
            break
    assert ctl.level >= 3, ctl.stats()
    assert (eng.scan_cap, eng.spec_suspended,
            eng.brownout_min_priority) == (2, True, 1)
    rid = eng.submit([1, 2], 4, slo_class="batch")
    out = eng.step()
    assert [(r.rid, r.finish_reason) for r in out] == [(rid, "shed")]
    # Under the cap (the controller detached, so that it cannot step
    # down meanwhile): chunks of at most 2 steps, the uncapped tokens.
    ctl._set(1)
    eng.brownout = None
    ks = []
    dispatch = eng._dispatch
    eng._dispatch = lambda k, f: ks.append(k) or dispatch(k, f)
    capped = eng.submit([5, 6, 7], 20, deadline_s=30.0,
                        slo_class="interactive")
    tokens = {r.rid: r.tokens for r in eng.drain()}[capped]
    assert ks and max(ks) == 2
    ref = Engine(model, num_slots=2, max_len=64, scan_k=4, device="cpu")
    ref.submit([5, 6, 7], 20)
    assert ref.drain()[0].tokens == tokens
    eng._dispatch, eng.brownout = dispatch, ctl
    # A batch request queued while the floor is down sheds once it is up.
    ctl._set(0)
    blocker = eng.submit([1, 2], 20)
    eng.step()
    eng.submit([9, 9], 30)                  # fill the second slot
    eng.step()
    queued = eng.submit([2, 3], 4, slo_class="batch")
    ctl._set(3)
    res = {}
    while eng.has_work():
        res.update((r.rid, r) for r in eng.step())
    assert res[queued].finish_reason == "shed"
    assert res[blocker].finish_reason == "length"
    for _ in range(80):
        eng.submit([3, 4], 2, slo_class="interactive", deadline_s=30.0)
        eng.drain()
        if ctl.level == 0:
            break
    assert ctl.level == 0, ctl.stats()
    assert (eng.scan_cap, eng.spec_suspended,
            eng.brownout_min_priority) == (None, False, None)
    st = eng.stats()
    assert st["brownout"]["name"] == "normal" and st["shed"] >= 2
    assert st["slo"]["overall"]["met"] >= 1
    assert st["slo"]["overall"]["missed"] + st["slo"]["overall"]["shed"] >= 3
    _no_leaks(eng)


def test_serve_cli_flags_and_http_429(models, tmp_path):
    """The serve CLI's new flags and their defaults (JAX's), then a
    server with --prefill_chunk: requests carrying slo_class, priority
    and deadline_s answer 200, one queued behind busy slots with a
    deadline of 1e-4 s answers 429 with Retry-After, a bad deadline or
    class 400, and /stats carries the scheduling keys."""
    args = build_parser().parse_args([])
    assert (args.prefill_chunk, args.no_preemption, args.brownout,
            args.deadline_s) == (0, False, "on", 0.0)
    model = models[2]
    save_for_serving(str(tmp_path), model.cfg, model.state_dict())
    server, loop, engine = build_server([
        f"--out_dir={tmp_path}", "--host=127.0.0.1", "--port=0",
        "--num_slots=2", "--max_len=64", "--prefill_chunk=16",
        "--warmup=buckets", "--device=cpu"])
    assert engine.prefill_chunk == 16 and engine.preemption
    assert engine.brownout is not None and engine.default_deadline_s is None
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(body):
        req = urllib.request.Request(base + "/generate",
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    try:
        answers = [None, None]

        def blocker(i):
            answers[i] = post(dict(
                prompt_tokens=list(range(1 + i, 41 + i)),
                max_new_tokens=20, temperature=0.0,
                slo_class=["interactive", "batch"][i], priority=i + 1,
                deadline_s=30.0))

        ths = [threading.Thread(target=blocker, args=(i,)) for i in (0, 1)]
        for t in ths:
            t.start()
        t0 = time.monotonic()
        while engine.stats()["active"] + engine.stats()["chunking"] < 2:
            assert time.monotonic() - t0 < 30
            time.sleep(0.001)
        code, headers, body = post(dict(prompt_tokens=[4, 5],
                                        max_new_tokens=4, deadline_s=1e-4))
        for t in ths:
            t.join(timeout=60)
        assert code == 429 and body["finish_reason"] == "shed", body
        assert int(headers["Retry-After"]) >= 1
        assert [a[0] for a in answers] == [200, 200], answers
        assert all(len(a[2]["tokens"]) == 20 for a in answers)
        for bad in (dict(deadline_s=-1), dict(slo_class="a b")):
            code, _, _ = post(dict(prompt_tokens=[1, 2], max_new_tokens=2,
                                   **bad))
            assert code == 400
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        for key in ("shed", "preemptions", "prefill_chunk", "spec_suspended",
                    "brownout", "slo", "retry_after_s"):
            assert key in st, key
        assert st["shed"] == 1 and st["prefill_chunk"] == 16
        assert st["slo"]["overall"]["shed"] == 1
        assert st["brownout"]["name"] == "normal"
    finally:
        server.shutdown()
        server.server_close()
        loop.stop()
        loop.join(timeout=10)
        th.join(timeout=10)
    assert not loop.is_alive() and not th.is_alive()
    ref = Engine(model, num_slots=2, max_len=64, device="cpu")
    ref.submit(list(range(1, 41)), 20)
    assert answers[0][2]["tokens"] == ref.drain()[0].tokens


def test_chip_smoke_scheduling_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py phase 15 on the CPU at a tiny width: the chunked
    fp32 engine's tokens equal the unchunked one's with decode tokens
    between the long prompt's pieces, the paged and dense preemptions
    give their twins' tokens (the paged one donating blocks, resuming on
    them and shedding the expired request), and the chunked server
    answers 200s and the 429; the launch check then refuses each part,
    because on the CPU no kernel launched."""
    import sys
    from pathlib import Path

    from nanosandbox_tpu_torch.ops import attention as at
    from nanosandbox_tpu_torch.ops import flash_decode as fd

    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    monkeypatch.chdir(repo)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MODEL", dict(
        n_layer=2, n_head=2, n_embd=64, block_size=1024, vocab_size=256))
    model, prompts = chip_smoke.fp32_model_and_prompts()
    for part in (
            lambda: chip_smoke.check_chunked_fp32(fd, at, model, prompts),
            lambda: chip_smoke.check_preemption_fp32(fd, at, model, True),
            lambda: chip_smoke.check_preemption_fp32(fd, at, model, False),
            lambda: chip_smoke.check_sched_server(fd, "cpu",
                                                  [[0] * 64] * 6)):
        with pytest.raises(SystemExit, match="bypassed a kernel"):
            part()
