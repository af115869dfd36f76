"""Fault injection, quarantine and recovery of the port's serving engine.

The counterparts of tests/test_faults.py on the port, on the tiny fp32
model (2 layers, n_embd 64, vocab 65; JAX-initialised weights carried
across by models/convert.py):

  * the port's FaultPlan fires at the same (site, step, visit) as the
    JAX package's for the same plan text and seed, and parses, rearms
    and describes the same;
  * supervised recovery is token-identical to a no-fault run: a poisoned
    decode step (paged and dense), a prefill that raises (the pool
    flushed, in place), a corrupted admission scatter, a stalled step
    caught by the watchdog, chaos-smoke on a plain and a spec engine,
    two poisons stitched into one Result; every request ends exactly
    once under a seeded fuzz of faults and preemptions;
  * graceful degradation: a drafter fault streak disables spec and the
    engine serves on; alloc_fail is backpressure; a recovery that never
    converges drains every request 'failed' and refuses submissions;
    real non-finite logits end rows 'failed' without a supervisor;
  * the supervisor's backoff ladder and settle; HTTP readiness red (503,
    Retry-After) while quarantined, 503 once failed, and clients riding
    through a recovery see only their answers.
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
from nanosandbox_tpu.serve.faults import FaultPlan as JaxFaultPlan
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.serve.drafters import NGramDrafter
from nanosandbox_tpu_torch.serve.engine import Engine, EngineFailedError
from nanosandbox_tpu_torch.serve.faults import (CANNED, FaultInjected,
                                                FaultPlan)
from nanosandbox_tpu_torch.serve.http import EngineLoop, make_server
from nanosandbox_tpu_torch.serve.recovery import EngineSupervisor

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = JaxGPTConfig(**DIMS, compute_dtype="float32",
                        attention_impl="xla")
    params = jax.jit(JaxGPT(jcfg).init)(jax.random.key(0),
                                        jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    m = GPT(cfg)
    m.load_state_dict(state_dict_from_jax_params(jax.device_get(params),
                                                 cfg))
    return m


def _engine(model, **kw):
    return Engine(model, num_slots=kw.pop("num_slots", 4), max_len=64,
                  device="cpu", **kw)


def _workload(eng, n=6, seed=3, budget=None, eos_id=None):
    """tests/test_faults.py's greedy mix: 1-23 prompt tokens, 4-9 new
    (or ``budget``), every third with ``eos_id``."""
    rng = np.random.default_rng(seed)
    rids = []
    for i in range(n):
        L = int(rng.integers(1, 24))
        mnt = budget if budget is not None else int(rng.integers(4, 10))
        kw = {"eos_id": eos_id} if eos_id is not None and i % 3 == 0 else {}
        rids.append(eng.submit(rng.integers(0, 65, L).tolist(), mnt, **kw))
    return rids


def _drive(sup, limit=3000):
    """Step a supervised engine to idle; Results by rid, each rid once."""
    got = {}
    n = 0
    while sup.engine.has_work() and n < limit:
        for r in sup.step():
            assert r.rid not in got, f"rid {r.rid} ended twice"
            got[r.rid] = r
        n += 1
    assert n < limit, "supervised engine failed to drain"
    return got


def _clean(model, n=6, seed=3, budget=None, **kw):
    eng = _engine(model, **kw)
    _workload(eng, n=n, seed=seed, budget=budget)
    return {r.rid: (r.prompt, r.tokens, r.finish_reason)
            for r in eng.drain()}


def _faulted(model, plan, n=6, seed=3, budget=None, **kw):
    eng = _engine(model, faults=FaultPlan.parse(plan), **kw)
    sup = EngineSupervisor(eng, backoff_base_s=0.0)
    _workload(eng, n=n, seed=seed, budget=budget)
    got = {rid: (r.prompt, r.tokens, r.finish_reason)
           for rid, r in _drive(sup).items()}
    return got, eng, sup


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("text,seed", [
    ("nan_logits@4x2,slow_step@10:0.25,alloc_fail@0x3", 0),
    ("chaos-smoke", 0), ("chaos-full", 0),
    ("drafter_fault@p0.3,nan_logits@p0.1", 7),
    ("prefill_exc@18,preempt_storm@22x3,replica_down@5", 3)])
def test_fault_plan_fires_as_jax_does(text, seed):
    """The same visits (site, step) in the same order, with a rearm in
    the middle, fire the same specs at the same visits as JAX's plan."""
    ours, theirs = FaultPlan.parse(text, seed), JaxFaultPlan.parse(text, seed)
    assert ours.describe() == theirs.describe()
    rng = np.random.default_rng(seed)
    sites = ("nan_logits", "slow_step", "alloc_fail", "drafter_fault",
             "scatter_corrupt", "prefill_exc", "preempt_storm",
             "replica_down")
    visits = [(sites[int(rng.integers(len(sites)))], step)
              for step in range(60) for _ in range(int(rng.integers(1, 4)))]
    for i, (site, step) in enumerate(visits):
        if i == len(visits) // 2:
            ours.rearm(step)
            theirs.rearm(step)
        a, b = ours.fire(site, step), theirs.fire(site, step)
        assert (a is None) == (b is None), (site, step)
        if a is not None:
            assert (a.site, a.stall_s) == (b.site, b.stall_s)
    assert ours.fired_log == theirs.fired_log
    assert ours.stats() == theirs.stats()
    assert CANNED["chaos-smoke"] == "nan_logits@6,alloc_fail@10x6," \
        "prefill_exc@18,preempt_storm@22x3"
    with pytest.raises(ValueError):
        FaultPlan.parse("warp_core_breach@3")


# ------------------------------------------------ recovery correctness

@pytest.mark.parametrize("paged", [True, False])
def test_poisoned_step_recovery_token_identical(model, paged):
    want = _clean(model, paged=paged)
    got, eng, sup = _faulted(model, "nan_logits@4", paged=paged)
    assert eng.faults.fired_log and eng.recoveries == 1
    assert sup.recoveries == 1 and sup.state == "ok"
    assert got == want
    st = eng.stats()["recovery"]
    assert st["recoveries"] == 1 and st["poisoned_steps"] >= 1
    assert not eng.quarantined and sup.stats()["ttfrt_s"] is not None


def test_prefill_exception_recovers_with_an_in_place_flush(model):
    """A prefill that raises mid-admission (blocks reserved, the wave in
    limbo) recovers on the exception path: the prefix cache dropped and
    every pool tensor zeroed in place (the same storage the graphs point
    at), the block pool consistent, tokens token-identical."""
    want = _clean(model, n=10)
    eng = _engine(model, faults=FaultPlan.parse("prefill_exc@2"))
    ptrs = [buf.data_ptr() for layer in eng._pool for buf in layer]
    state = [t.data_ptr() for t in (eng._pos, eng._tok, eng._table)]
    flushed = []
    recover = eng.recover

    def spy(cause, flush_cache=False):
        out = recover(cause, flush_cache=flush_cache)
        flushed.append((cause, flush_cache, all(
            int(buf.abs().sum()) == 0 for layer in eng._pool
            for buf in layer)))
        return out

    eng.recover = spy
    sup = EngineSupervisor(eng, backoff_base_s=0.0)
    _workload(eng, n=10)
    got = {rid: (r.prompt, r.tokens, r.finish_reason)
           for rid, r in _drive(sup).items()}
    assert got == want
    assert flushed == [("step_error:FaultInjected", True, True)]
    assert [buf.data_ptr() for layer in eng._pool for buf in layer] == ptrs
    assert [t.data_ptr() for t in (eng._pos, eng._tok, eng._table)] == state
    eng.block_pool.check([])


def test_scatter_corrupt_and_double_poison(model):
    """A corrupted admission scatter is caught at the wave's readback;
    two poisons in the same requests still stitch one Result each."""
    want = _clean(model)
    got, eng, _ = _faulted(model, "scatter_corrupt@1")
    assert eng.faults.fired_log and eng.recoveries >= 1 and got == want
    want = _clean(model, budget=16)
    got, eng, _ = _faulted(model, "nan_logits@3,nan_logits@9", budget=16)
    assert len(eng.faults.fired_log) == 2 and eng.recoveries == 2
    assert got == want and eng._resumed == {}


def test_stalled_step_watchdog_triggers_recovery(model):
    """An injected slow step trips the stalled_step watchdog and the
    supervisor recovers, token-identical. As tests/test_faults.py does,
    the engine first runs the workload clean (the plan disabled) and the
    limit is set well above the slowest warm clean step measured here,
    with the injected stall well past the limit: the one trip comes from
    the stall, however loaded the host is."""
    want = _clean(model)
    eng = _engine(model)
    _workload(eng)
    eng.drain()
    eng.reset_prefix_cache()
    _workload(eng)
    slowest = 0.0
    while eng.has_work():
        t0 = time.monotonic()
        eng.step()
        slowest = max(slowest, time.monotonic() - t0)
    eng.reset_prefix_cache()
    limit = max(0.5, 10 * slowest)
    eng.watchdog.stalled_step_s = limit
    plan = FaultPlan.parse(f"slow_step@3:{2 * limit:.3f}")
    plan.rearm(eng.steps)
    eng.faults = plan
    sup = EngineSupervisor(eng, backoff_base_s=0.0)
    _workload(eng)
    got = [(r.prompt, r.tokens, r.finish_reason)
           for _, r in sorted(_drive(sup).items())]
    assert plan.fired_log
    assert eng.watchdog.trips.get("stalled_step", 0) == 1
    assert eng.recoveries >= 1 and sup.last_cause == "stalled_step"
    assert got == [want[rid] for rid in sorted(want)]


@pytest.mark.parametrize("spec", [False, True])
def test_chaos_smoke_supervised_is_token_identical(model, spec):
    """The canned chaos-smoke plan (a poison, an alloc_fail burst, a
    prefill crash, a preemption storm) on a plain and an NGram spec
    engine: every request ends once, with the no-fault tokens."""
    # Spec steps emit several tokens: two slots keep it stepping long
    # enough to reach every site.
    kw = {"spec": NGramDrafter(k=3), "num_slots": 2} if spec else {}
    want = _clean(model, n=16, budget=24)
    got, eng, sup = _faulted(model, "chaos-smoke", n=16, budget=24, **kw)
    assert got == want
    sites = {f["site"] for f in eng.faults.fired_log}
    assert sites == {"nan_logits", "alloc_fail", "prefill_exc",
                     "preempt_storm"}, sites
    assert eng.recoveries >= 2 and sup.state == "ok"


def test_exactly_once_terminals_under_a_fault_fuzz(model):
    """tests/test_faults.py's fuzz: paged, dense and spec engines under
    poisons, a prefill crash and a preemption burst, with eos rows and a
    zero-token request: every rid ends exactly once."""
    preempts = 0
    for i, case in enumerate([dict(paged=True), dict(paged=False),
                              dict(paged=True, spec=NGramDrafter(k=3))]):
        eng = _engine(model, faults=FaultPlan.parse(
            "nan_logits@3,prefill_exc@9,preempt_storm@12x2,nan_logits@15"),
            **case)
        sup = EngineSupervisor(eng, backoff_base_s=0.0)
        rids = _workload(eng, n=10, seed=20 + i, eos_id=1)
        rids.append(eng.submit([2, 3], 0))
        got = _drive(sup)
        assert eng.faults.fired_log, case
        assert sorted(got) == sorted(rids), case
        assert eng._resumed == {} and not eng._submit_meta, case
        preempts += eng.preemptions
    assert preempts >= 1


# ------------------------------------------------ graceful degradation

def test_drafter_fault_streak_disables_spec_not_engine(model):
    want = {rid: t for rid, (_, t, _) in _clean(model, budget=20).items()}
    eng = _engine(model, spec=NGramDrafter(k=3),
                  faults=FaultPlan.parse("drafter_fault@2x99"),
                  spec_fault_tolerance=3)
    _workload(eng, budget=20)
    assert {r.rid: r.tokens for r in eng.drain()} == want
    assert eng.drafter_faults == 3 and eng._spec is None
    st = eng.stats()
    assert st["recovery"]["spec_disabled"] is not None
    assert st["drafter_faults"] == 3 and st["spec"] == {"enabled": False}
    assert st["host_dispatches"]["decode"] > 0
    # One blip below the tolerance only degrades its own step.
    eng = _engine(model, spec=NGramDrafter(k=3),
                  faults=FaultPlan.parse("drafter_fault@2"))
    _workload(eng, budget=20)
    eng.drain()
    assert eng.drafter_faults == 1 and eng._spec is not None


def test_alloc_fail_is_backpressure_not_a_crash(model):
    want = _clean(model)
    eng = _engine(model, faults=FaultPlan.parse("alloc_fail@0x12"))
    _workload(eng)
    got = {r.rid: (r.prompt, r.tokens, r.finish_reason) for r in eng.drain()}
    assert got == want
    assert eng.block_pool.stall_steps >= 12 and eng.recoveries == 0


def test_permanent_failure_drains_cleanly(model):
    eng = _engine(model, faults=FaultPlan.parse("nan_logits@0x99"))
    sup = EngineSupervisor(eng, max_consecutive=2, backoff_base_s=0.0)
    rids = _workload(eng, n=8)
    results = []
    for _ in range(500):
        results.extend(sup.step())
        if sup.state == "failed" and not eng.has_work():
            break
    assert sup.state == "failed" and eng.failed
    assert sorted(r.rid for r in results) == sorted(rids)
    assert all(r.finish_reason == "failed" for r in results)
    assert any(r.tokens for r in results)
    with pytest.raises(EngineFailedError):
        eng.submit([1, 2], 3)
    assert eng.rejected.get("engine_failed") == 1
    assert sup.step() == []


def test_real_nan_logits_fail_rows_without_a_supervisor(model):
    """NaN weights: the prefill's and every step's sentinel (decode and
    verify) mark the row poisoned; without a supervisor it ends 'failed'
    after POISON_STRIKE_LIMIT strikes, with no garbage token."""
    bad = GPT(model.cfg)
    bad.load_state_dict({k: v * float("nan")
                         for k, v in model.state_dict().items()})
    for spec in (None, NGramDrafter(k=3)):
        eng = _engine(bad, num_slots=2, spec=spec)
        rid = eng.submit([1, 2, 3], 6)
        results = eng.drain()
        assert [(r.rid, r.finish_reason, r.tokens) for r in results] == [
            (rid, "failed", [])]
        assert eng.poisoned_steps >= 1 and not eng.failed


def test_supervisor_backoff_ladder_and_settle(model):
    eng = _engine(model, num_slots=2)
    sleeps = []
    sup = EngineSupervisor(eng, backoff_base_s=0.1, backoff_max_s=0.5,
                           settle_s=0.05, sleep=sleeps.append)
    for expect in (0.1, 0.2, 0.4, 0.5):
        sup._last_fault_t = time.monotonic()
        sup._handle_fault("poisoned_step", flush_cache=False)
        assert sleeps[-1] == pytest.approx(expect)
    sup._last_fault_t = time.monotonic() - 1.0
    sup._handle_fault("poisoned_step", flush_cache=False)
    assert sleeps[-1] == pytest.approx(0.1)
    assert sup.stats()["recoveries"] == 5 and sup.state == "ok"
    with pytest.raises(FaultInjected):
        raise FaultInjected("prefill_exc", 3)


# ------------------------------------------------------------- HTTP

def _serve(eng, sup):
    loop = EngineLoop(eng, supervisor=sup)
    loop.start()
    srv = make_server("127.0.0.1", 0, loop)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, loop, th, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(base, body):
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_readiness_recovery_and_failure(model):
    """Readiness is red (503 + Retry-After, reason 'quarantined') while
    the supervisor backs off inside a recovery, liveness stays green,
    and the clients riding through it get their no-fault tokens; after
    permanent failure readiness and liveness are red and /generate is a
    503 with Retry-After."""
    plain = _engine(model)
    prompts = [[3 + i, 4, 5 + i] for i in range(3)]
    want = [t for t in _run_prompts(plain, prompts)]
    eng = _engine(model, faults=FaultPlan.parse("nan_logits@3"))
    inside, release = threading.Event(), threading.Event()

    def sleep(_):
        inside.set()
        release.wait(30)

    sup = EngineSupervisor(eng, backoff_base_s=0.01, sleep=sleep)
    srv, loop, th, base = _serve(eng, sup)
    try:
        assert _get(base + "/healthz?ready=1")[:2] == (
            200, {"ok": True, "ready": True, "draining": False})
        out = {}
        ths = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _post(base, {"prompt_tokens": prompts[i],
                            "max_new_tokens": 8, "temperature": 0.0})))
               for i in range(3)]
        for t in ths:
            t.start()
        assert inside.wait(30), "the fault never fired"
        code, body, headers = _get(base + "/healthz?ready=1")
        assert code == 503 and body["ready"] is False
        assert body["reason"].startswith("quarantined")
        assert int(headers["Retry-After"]) >= 1
        assert _get(base + "/healthz")[:2] == (200, {"ok": True})
        release.set()
        for t in ths:
            t.join(60)
        assert [out[i][0] for i in range(3)] == [200] * 3
        assert [out[i][1]["tokens"] for i in range(3)] == want
        stats = _get(base + "/stats")[1]
        assert stats["recovery"]["recoveries"] == 1
        assert stats["loop"]["supervisor"]["state"] == "ok"
        assert _get(base + "/healthz?ready=1")[0] == 200
        sup.max_consecutive = 0
        sup._handle_fault("forced", flush_cache=False)
        assert eng.failed
        code, body, headers = _get(base + "/healthz?ready=1")
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert _get(base + "/healthz")[0] == 503
        code, body = _post(base, {"prompt_tokens": [1, 2],
                                  "max_new_tokens": 2})
        assert code == 503 and "permanently failed" in body["error"]
    finally:
        release.set()
        srv.shutdown()
        srv.server_close()
        loop.stop()
        loop.join(timeout=30)
        th.join(timeout=30)


def _run_prompts(eng, prompts):
    rids = [eng.submit(p, 8) for p in prompts]
    done = {r.rid: r.tokens for r in eng.drain()}
    return [done[r] for r in rids]
