"""The port's observability against the JAX package's.

* The metric registry: the same sequence of operations renders
  byte-identical Prometheus text and an equal JSON snapshot on both
  (tests/test_obs.py's golden-format and label-hygiene cases, and a
  seeded mix of counters, gauges and labelled histograms with collectors
  and resets), and both refuse the same misuse with the same message.
* The span tracer's Chrome export and the flight recorder's JSONL,
  counts, terminals and stats match for the same operations, timestamps
  left out. A flight record stays under 50 us.
* The watchdog panel: on a stub engine both panels trip the same kinds
  for the same feeds; on the port's engine each of the six kinds trips
  on tests/test_flight.py's scenario and dumps the flight ledger, the
  span ring and the stats.
* The engine: for the same requests the tiny fp32 engine (JAX-
  initialised weights, on the CPU) gives the JAX Engine's tokens, the
  same per-request flight event names in the same order, and the same
  schedule counters; its families are JAX's but for a named list. The
  debug views, the telemetry-off engine, and the trainer's registry.
* The HTTP surface: /metrics, /trace, /debug/*, /profile (a CPU
  torch.profiler window) and /drain on a live server.
* obs/ imports no torch.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu import obs as jobs
from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu_torch import obs as tobs
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT
from nanosandbox_tpu_torch.serve.engine import Engine
from nanosandbox_tpu_torch.serve.http import EngineLoop, make_server

REPO = Path(__file__).resolve().parent.parent
DIMS = dict(n_layer=2, n_head=2, n_embd=32, block_size=64, vocab_size=50)

# Families of the JAX Engine the port does not publish, each with the
# ROADMAP item that owns it (none left).
JAX_ONLY_FAMILIES: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _golden(o):
    """tests/test_obs.py's golden-format case."""
    reg = o.MetricRegistry()
    reg.counter("req_total", "Total requests.", labelnames=("route",)
                ).labels(route='/gen"x"\\y').inc(3)
    reg.gauge("depth", "Depth\nwith newline.").set(2)
    h = reg.histogram("ttft_seconds", "TTFT.", buckets=(0.01, 0.1))
    h.observe(0.05)
    h.observe(0.05)
    return reg.prometheus_text()


def _unset(o):
    """An unset gauge and a family with no children emit nothing."""
    reg = o.MetricRegistry()
    reg.gauge("never_set", "Unset.")
    reg.counter("never_touched", "No children.", labelnames=("k",))
    return reg.prometheus_text()


def _reads(o):
    """Reads (peek, value, mean, percentiles) create no series; a write
    does."""
    reg = o.MetricRegistry()
    h = reg.histogram("h_seconds", "H.", labelnames=("k",))
    g = reg.gauge("g_val", "G.")
    c = reg.counter("c_total", "C.")
    reads = [h.peek(k="x"), g.value, c.value, c.mean(), c.percentiles()]
    before = reg.prometheus_text()
    h.labels(k="x").observe(0.1)
    return json.dumps([repr(reads), before, reg.prometheus_text()])


def _seeded(o):
    """A seeded mix: labelled counters, gauges (inf, nan, huge, tiny
    values) and histograms with custom buckets and windows, a collector
    mirroring totals, resets; text and snapshot after each phase."""
    rng = np.random.default_rng(7)
    reg = o.MetricRegistry()
    c = reg.counter("ops_total", "Ops by kind.", labelnames=("kind", "shard"))
    g = reg.gauge("level", "A level.", unit="x", labelnames=("name",))
    h = reg.histogram("lat_seconds", "Latency.", labelnames=("route",),
                      buckets=(0.001, 0.01, 0.1, 1.0), window=8)
    h2 = reg.histogram("steps", "Steps.", buckets=(0, 1, 2, 4, 8))
    mirrored = reg.counter("mirrored_total", "Mirrored.")
    state = {"n": 0}
    reg.add_collector(lambda: mirrored._set_total(state["n"]))
    out = []
    for phase in range(3):
        for _ in range(120):
            op = int(rng.integers(0, 5))
            if op == 0:
                c.labels(kind=str(rng.choice(["a", "b", 'q"\\'])),
                         shard=int(rng.integers(0, 3))).inc(
                    float(rng.choice([1, 2.5, 1e16])))
            elif op == 1:
                g.labels(name=str(rng.choice(["x", "y\nz"]))).set(
                    float(rng.choice([0.1, -3.0, np.inf, -np.inf, 1e-9,
                                      7, 1e20])))
            elif op == 2:
                h.labels(route=str(rng.choice(["/g", "/s"]))).observe(
                    float(rng.exponential(0.05)))
            elif op == 3:
                h2.observe(int(rng.integers(0, 12)))
            else:
                state["n"] += int(rng.integers(0, 4))
        out.append(reg.prometheus_text())
        out.append(json.dumps(reg.snapshot(), sort_keys=True, default=str))
        if phase == 1:
            h.labels(route="/g").reset()
            g.reset()
    g.labels(name="nan").set(float("nan"))
    out.append(reg.prometheus_text())
    return "\n----\n".join(out)


def _multi(o):
    """render_prometheus over several registries, and its refusal of a
    family in two of them."""
    a, b = o.MetricRegistry(), o.MetricRegistry()
    a.counter("a_total", "A.").inc()
    b.gauge("b_val", "B.").set(1.5)
    text = o.render_prometheus(a, b)
    b.counter("a_total").inc()
    try:
        o.render_prometheus(a, b)
    except ValueError as e:
        return text + str(e)
    return text


def _misuse(o):
    """Bad names, kinds, labels and values raise the same errors."""
    reg = o.MetricRegistry()
    fam = reg.counter("hits_total", "Hits.", labelnames=("route",))
    msgs = []
    for fn in (lambda: reg.gauge("hits_total"),
               lambda: reg.counter("hits_total", labelnames=("x",)),
               lambda: reg.counter("bad name"),
               lambda: reg.counter("ok_total", labelnames=("9bad",)),
               lambda: reg._family("k", "summary", "", "", ()),
               lambda: fam.inc(),
               lambda: fam.labels(other="x"),
               lambda: fam.labels(route="a").inc(-1),
               lambda: fam.labels(route="a").set(1),
               lambda: fam.labels(route="a").observe(1)):
        try:
            fn()
            msgs.append("no error")
        except (ValueError, TypeError) as e:
            msgs.append(f"{type(e).__name__}: {e}")
    return "\n".join(msgs)


@pytest.mark.parametrize("case", [_golden, _unset, _reads, _seeded, _multi,
                                  _misuse], ids=lambda f: f.__name__[1:])
def test_registry_matches_jax_byte_for_byte(case):
    assert case(tobs) == case(jobs)


def test_registry_golden_text_details():
    text = _golden(tobs)
    assert r'route="/gen\"x\"\\y"' in text
    assert "# HELP depth Depth\\nwith newline." in text
    assert 'ttft_seconds_window{quantile="0.5"} 0.05' in text
    assert text.endswith("\n")
    assert _unset(tobs) == ""


# ---------------------------------------------------------------------------
# the tracer and the flight recorder
# ---------------------------------------------------------------------------

def _tracer_ops(tracers):
    """The same seeded begin / end / instant sequence on every tracer,
    interleaved so that their clocks see the same order."""
    rng = np.random.default_rng(11)
    open_ = [[] for _ in tracers]
    for i in range(200):
        op = int(rng.integers(0, 3))
        if op == 0 or not open_[0]:
            rid = None if rng.random() < 0.4 else int(rng.integers(0, 5))
            name = str(rng.choice(["queued", "generate", "decode_step",
                                   "prefill_wave"]))
            args = {"i": i, "rows": int(rng.integers(0, 8))}
            for t, o in zip(tracers, open_):
                o.append(t.begin(name, cat="engine" if rid is None
                                 else "request", rid=rid, args=args))
        elif op == 1:
            j = int(rng.integers(0, len(open_[0])))
            extra = {"live_tokens": i} if rng.random() < 0.5 else None
            for t, o in zip(tracers, open_):
                t.end(o.pop(j), extra)
        else:
            rid = int(rng.integers(0, 5))
            for t in tracers:
                t.instant("marker", rid=rid, args={"i": i})
    return open_


def _no_times(trace: dict) -> list:
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace["traceEvents"]]


def test_tracer_export_matches_jax():
    ours, theirs = tobs.SpanTracer(capacity=64), jobs.SpanTracer(capacity=64)
    _tracer_ops([ours, theirs])
    assert ours.open_count() == theirs.open_count() > 0
    for kw in ({}, {"rid": 2}, {"rid": 3}, {"rid": 99}):
        a, b = ours.export_chrome(**kw), theirs.export_chrome(**kw)
        assert _no_times(a) == _no_times(b), kw
        assert set(a) == set(b) == {"traceEvents", "displayTimeUnit"}
    assert (len(ours.spans(rid=1)) == len(theirs.spans(rid=1)))
    ours.clear()
    assert ours.spans() == [] and ours.open_count() > 0
    off = tobs.SpanTracer(enabled=False)
    assert off.begin("x") == 0 and off.export_chrome()["traceEvents"] == []


def _flight_ops(recs):
    rng = np.random.default_rng(5)
    for i in range(150):
        ev = str(rng.choice(["submit", "queue", "admit", "retire",
                             "finish", "shed", "reject", "fault"]))
        rid = None if ev == "reject" else int(rng.integers(0, 9))
        fields = {"n": int(rng.integers(1, 4))} if ev == "retire" else {}
        if ev == "fault":
            fields = {"site": "nan_logits"}
        for r in recs:
            r.record(ev, rid=rid, step=i, **fields)
    for r in recs:
        r.record("finish", rid="other:3", step=999, reason="length")


@pytest.mark.parametrize("kw", [{}, {"capacity": 40},
                                {"namespace": "replica0"}])
def test_flight_recorder_matches_jax(kw):
    ours, theirs = tobs.FlightRecorder(**kw), jobs.FlightRecorder(**kw)
    _flight_ops([ours, theirs])

    def lines(rec, **q):
        out = [json.loads(ln) for ln in rec.to_jsonl(**q).splitlines()]
        for e in out:
            assert e["wall"] > 1e9 and e["t"] >= 0
            del e["t"], e["wall"]
        return out

    for q in ({}, {"rid": 3}, {"rid": "other:3"}, {"last_s": 60.0}):
        assert lines(ours, **q) == lines(theirs, **q)
    assert ours.counts() == theirs.counts()
    assert ours.stats() == theirs.stats()
    for rid in range(9):
        assert ours.terminals(rid) == theirs.terminals(rid)
    ours.clear()
    theirs.clear()
    assert ours.stats() == theirs.stats()


def test_flight_dump_disabled_and_overhead(tmp_path):
    rec = tobs.FlightRecorder(capacity=8)
    rec.record("submit", rid=1, step=0, prompt_len=3)
    rec.record("finish", rid=1, step=4, reason="length", tokens=4)
    assert rec.dump(str(tmp_path / "f.jsonl")) == 2
    off = tobs.FlightRecorder(enabled=False)
    off.record("submit", rid=1)
    assert off.events() == [] and off.stats()["recorded"] == 0
    with pytest.raises(ValueError, match="capacity"):
        tobs.FlightRecorder(capacity=0)
    # One record is a dict build and a deque append: < 50 us (median of
    # 5 runs of 2000), the JAX recorder's pin.
    runs = []
    for _ in range(5):
        r = tobs.FlightRecorder()
        t0 = time.perf_counter()
        for i in range(2000):
            r.record("retire", rid=i, step=i, n=1)
        runs.append((time.perf_counter() - t0) / 2000)
    assert sorted(runs)[2] < 50e-6, f"record {sorted(runs)[2] * 1e6:.1f}us"


# ---------------------------------------------------------------------------
# the watchdog panel
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, rid):
        self.rid = rid


class _Row:
    def __init__(self, rid, last_t):
        self.req, self.last_t, self.tokens = _Req(rid), last_t, [1, 2]


class _Pool:
    def __init__(self):
        self.stall_steps = self.evicted_blocks = 0
        self.free_blocks, self.num_blocks = 3, 10


class _Sched:
    queued = 2


class _StubEngine:
    """What a WatchdogPanel reads: counts, slots, the pool, the
    telemetry objects and stats; the program count under both packages'
    names (JAX's tracecheck counts, the port's program_counts)."""

    def __init__(self, o):
        self.metrics, self.flight = o.MetricRegistry(), o.FlightRecorder()
        self.tracer = o.SpanTracer()
        self.steps, self._active = 0, {}
        self.block_pool, self.sched = _Pool(), _Sched()
        self.programs = 0
        self.tracecheck = self

    def counts(self):
        return {"decode": self.programs}

    def program_counts(self):
        return {"graph_captures": self.programs}

    def stats(self):
        return {"steps": self.steps}


def _drive(kind, eng, wd):
    """One scenario a kind; every poll at a fixed clock."""
    wd.check_interval_steps = 1
    poll = [0.0]

    def step(n=1):
        for _ in range(n):
            eng.steps += 1
            poll[0] += 1.0
            wd.check(now=poll[0])

    if kind == "ttft_spike":
        wd.ttft_min_samples, wd.ttft_min_s = 4, 0.0
        for _ in range(8):
            wd.on_ttft(0.010)
        wd.on_ttft(0.500)
        wd.on_ttft(0.011)
    elif kind == "admission_stall":
        wd.stall_trip_steps = 3
        for _ in range(5):
            eng.block_pool.stall_steps += 1
            step()
        step()
        eng.block_pool.stall_steps = 0          # a ledger reset: resync
        step()
    elif kind == "pool_thrash":
        step()
        eng.block_pool.evicted_blocks += 11
        step()
        eng.block_pool.evicted_blocks += 5
        step()
    elif kind == "post_freeze_retrace":
        eng.programs = 3
        wd.mark_steady()
        step(2)
        eng.programs = 4
        step(2)
    elif kind == "stuck_slot":
        wd.stuck_slot_s = 5.0
        eng._active = {0: _Row(7, last_t=0.0), 1: _Row(8, last_t=100.0)}
        step(3)
        step(5)
    else:
        wd.stalled_step_s = 1.0
        for dt in (0.2, 3.0, 0.5, 1.5):
            wd.on_step_time(dt)


def _trip_view(wd, eng):
    last = {k: v for k, v in (wd.last_trip or {}).items()
            if k not in ("wall", "dump")}
    text = eng.metrics.prometheus_text()
    return wd.trips, last, text


@pytest.mark.parametrize("kind", tobs.WatchdogPanel.KINDS)
def test_watchdog_panel_trips_as_jax(kind, tmp_path):
    assert tobs.WatchdogPanel.KINDS == jobs.WatchdogPanel.KINDS
    got = []
    for o, sub in ((tobs, "torch"), (jobs, "jax")):
        eng = _StubEngine(o)
        wd = o.WatchdogPanel(eng, dump_dir=str(tmp_path / sub))
        _drive(kind, eng, wd)
        got.append(_trip_view(wd, eng))
        dumps = sorted(os.listdir(tmp_path / sub))
        assert dumps and all(d.startswith(kind) for d in dumps), dumps
        files = sorted(os.listdir(tmp_path / sub / dumps[0]))
        assert files == [f"flight-{kind}.jsonl", f"meta-{kind}.json",
                         f"trace-{kind}.json"]
        got[-1] += (len(dumps),)
    assert got[0] == got[1]
    assert got[0][0].get(kind, 0) >= 1, got[0]


# ---------------------------------------------------------------------------
# the engine
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


def _workload(eng):
    """Six greedy requests over 2 slots: queueing, waves of two, two
    sharing a 32-token prefix (a prefix hit once the first finishes),
    deadlines on some, a zero-token request and two rejects."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, DIMS["vocab_size"], 32).tolist()
    prompts = [shared + [1, 2, 3], rng.integers(0, 50, 5).tolist(),
               rng.integers(0, 50, 20).tolist(), shared + [4, 5],
               rng.integers(0, 50, 9).tolist(), [7, 8]]
    rids = []
    for i, p in enumerate(prompts):
        kw = {"deadline_s": 600.0, "slo_class": "interactive"} \
            if i % 2 == 0 else {}
        rids.append(eng.submit(p, 4 + i % 3, **kw))
    rids.append(eng.submit([1, 2], 0))
    for bad in ([], [DIMS["vocab_size"]]):
        with pytest.raises(ValueError):
            eng.submit(bad, 2)
    done = {}
    # The second shared-prefix request waits for the first's donation.
    while eng.has_work():
        done.update((r.rid, r) for r in eng.step())
    return [(done[r].tokens, done[r].finish_reason) for r in rids]


def _schedule_counters(snap: dict) -> dict:
    def total(name):
        return sum(s["value"] for s in snap[name]["series"])

    out = {name: total(name) for name in (
        "serve_requests_submitted_total", "serve_tokens_generated_total",
        "serve_prefill_waves_total", "serve_prefix_hit_tokens_total",
        "serve_prefix_miss_tokens_total", "serve_requests_admitted_total")}
    out["completed"] = {s["labels"]["reason"]: s["value"] for s in
                        snap["serve_requests_completed_total"]["series"]}
    out["rejected"] = {s["labels"]["reason"]: s["value"] for s in
                       snap["serve_requests_rejected_total"]["series"]}
    out["slo"] = sorted((tuple(s["labels"].values()), s["value"]) for s in
                        snap["serve_slo_requests_total"]["series"])
    return out


_JAX_RUN: dict = {}


def _jax_run(models):
    if not _JAX_RUN:
        jmodel, params, _ = models
        eng = JaxEngine(jmodel, params, num_slots=2, max_len=64)
        _JAX_RUN["results"] = _workload(eng)
        _JAX_RUN["engine"] = eng
    return _JAX_RUN["results"], _JAX_RUN["engine"]


def _event_names(eng, rids) -> dict:
    return {rid: [e["ev"] for e in eng.flight.events(rid=rid)]
            for rid in rids}


def test_engine_flight_tokens_and_counters_match_jax(models):
    want, jeng = _jax_run(models)
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    assert _workload(eng) == want
    rids = range(len(want))
    names = _event_names(eng, rids)
    assert names == _event_names(jeng, rids)
    assert [e["prefix"] for e in eng.flight.events(rid=3)
            if e["ev"] == "prefill"] == ["hit"]
    rejects = [(e["reason"], e["rid"]) for e in eng.flight.events()
               if e["ev"] == "reject"]
    assert rejects == [(e["reason"], e["rid"]) for e in jeng.flight.events()
                       if e["ev"] == "reject"]
    for rid in rids:
        assert eng.flight.terminals(rid) == ["finish"]
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    assert _schedule_counters(snap) == _schedule_counters(jsnap)
    # The families and their kinds: JAX's, less the named list.
    ours = {n: f["type"] for n, f in snap.items()}
    theirs = {n: f["type"] for n, f in jsnap.items()}
    assert set(theirs) - set(ours) == set(JAX_ONLY_FAMILIES)
    assert set(ours) <= set(theirs)
    assert all(ours[n] == theirs[n] for n in ours)
    # Spans: one queued and one generate a request, decode steps on the
    # engine track, nothing left open after the drain.
    assert eng.tracer.open_count() == 0
    spans = eng.tracer.spans()
    for rid in (0, 1, 2, 4, 5):
        mine = [s.name for s in spans if s.rid == rid]
        assert sorted(mine) == ["generate", "queued"], (rid, mine)
    steps = [s for s in spans if s.name == "decode_step"]
    assert len(steps) == eng.steps
    # Pipelined: a step's span closes after the next one opens.
    assert any(b.t0 < a.t1 for a, b in zip(steps, steps[1:]))
    # /stats reads the same histograms the scrape does.
    st = eng.stats()
    assert st["ttft_s"] == eng._ttft.percentiles((50, 90, 99))
    assert st["flight"]["recorded"] == eng.flight.recorded
    assert st["kv_pool"]["ttft_hit_s"] is not None


def test_engine_label_hygiene(models):
    """tests/test_obs.py's label-hygiene cases on the port's engine: a
    feature off (or never exercised) renders no series, reads mint none;
    exercised, the same families render."""
    eng = Engine(models[2], num_slots=2, max_len=64, prefix_cache=False,
                 device="cpu")
    eng.submit([1, 2, 3], 4)
    eng.drain()
    eng.stats()
    text = eng.metrics.prometheus_text()
    for absent in ("serve_spec_accept_len", "serve_spec_req_accepted_tokens",
                   "serve_prefix_ttft_seconds", "serve_slo_requests_total",
                   "serve_goodput_tokens_total", "serve_slo_attainment",
                   "serve_deadline_margin_seconds",
                   "serve_requests_rejected_total", "watchdog_trips_total"):
        assert absent not in text, absent
    assert "# TYPE serve_ttft_seconds histogram" in text
    assert "# TYPE serve_requests_shed_total counter" in text
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    eng.submit([1, 2, 3], 4, deadline_s=30.0, slo_class="interactive")
    eng.drain()
    with pytest.raises(ValueError):
        eng.submit([], 4)
    text = eng.metrics.prometheus_text()
    for present in ("serve_prefix_ttft_seconds", "serve_slo_requests_total",
                    "serve_goodput_tokens_total", "serve_slo_attainment",
                    "serve_deadline_margin_seconds",
                    "serve_requests_rejected_total"):
        assert f"# TYPE {present} " in text, present
    assert 'serve_prefix_ttft_seconds_bucket{prefix="miss"' in text
    assert 'serve_prefix_ttft_seconds_bucket{prefix="hit"' not in text
    assert 'serve_requests_rejected_total{reason="empty_prompt"} 1' in text
    with pytest.raises(ValueError, match="already hosts"):
        Engine(models[2], num_slots=1, max_len=64, device="cpu",
               metrics=eng.metrics)


def _dump_files(path, kind):
    dumps = [d for d in os.listdir(path) if d.startswith(kind)]
    assert dumps, os.listdir(path)
    d = os.path.join(path, sorted(dumps)[0])
    with open(os.path.join(d, f"flight-{kind}.jsonl")) as f:
        flight = [json.loads(ln) for ln in f]
    with open(os.path.join(d, f"trace-{kind}.json")) as f:
        trace = json.load(f)
    with open(os.path.join(d, f"meta-{kind}.json")) as f:
        meta = json.load(f)
    assert "traceEvents" in trace and meta["trip"]["kind"] == kind
    assert "stats" in meta
    return flight


def _watchdog_engine(models, tmp_path, **kw):
    return Engine(models[2], num_slots=2, max_len=64, device="cpu",
                  watchdog_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("kind", tobs.WatchdogPanel.KINDS)
def test_engine_watchdog_trips_and_dumps(models, tmp_path, kind):
    """Each kind on tests/test_flight.py's scenario for it (the two it
    lacks, pool_thrash and stalled_step, on the same pattern)."""
    if kind == "ttft_spike":
        eng = _watchdog_engine(models, tmp_path)
        wd = eng.watchdog
        wd.ttft_min_samples, wd.ttft_min_s = 4, 0.0
        eng.submit([1, 2], 2)
        eng.drain()
        for _ in range(8):
            wd.on_ttft(0.010)
        wd.on_ttft(0.500)
        assert wd.trips == {"ttft_spike": 1}
        assert ('watchdog_trips_total{kind="ttft_spike"} 1'
                in eng.metrics.prometheus_text())
        assert any(e["ev"] == "finish" for e in _dump_files(tmp_path, kind))
        wd.on_ttft(0.500)               # cooldown: counted, not dumped
        assert wd.trips["ttft_spike"] == 2 and "dump" not in wd.last_trip
        return
    if kind in ("stuck_slot", "admission_stall"):
        eng = _watchdog_engine(models, tmp_path, kv_pool_blocks=5)
        wd = eng.watchdog
        wd.stuck_slot_s = 0.0
        wd.check_interval_steps = 1
        wd.stall_trip_steps = 1
        eng.submit([1] * 16, 40)        # 4 of 5 blocks
        eng.submit([2] * 16, 40)        # stalls on blocks
        eng.step()
        eng.step()
        assert wd.trips.get(kind, 0) >= 1, wd.trips
        eng.drain()
    elif kind == "post_freeze_retrace":
        eng = _watchdog_engine(models, tmp_path)
        eng.submit([1, 2], 3)
        eng.drain()
        eng.watchdog.check_interval_steps = 1
        eng.watchdog.mark_steady()
        eng.submit([1, 2], 4)
        eng.drain()
        assert "post_freeze_retrace" not in eng.watchdog.trips
        # On the card a capture after the warmup bumps the engine's
        # tracecheck registry; on the CPU nothing is captured, so a
        # capture is recorded by hand.
        eng.tracecheck.register("decode", 1)
        eng.tracecheck.bump("decode")
        eng.submit([3, 4], 4)
        eng.drain()
        assert eng.watchdog.trips.get(kind, 0) == 1
    elif kind == "pool_thrash":
        eng = _watchdog_engine(models, tmp_path, kv_pool_blocks=6)
        eng.watchdog.check_interval_steps = 1
        eng.watchdog.thrash_factor = 0.3
        rng = np.random.default_rng(0)
        for _ in range(6):              # distinct 40-token prompts: each
            eng.submit(rng.integers(0, 50, 40).tolist(), 2)   # evicts
        eng.drain()
        assert eng.block_pool.evicted_blocks > 0
        assert eng.watchdog.trips.get(kind, 0) >= 1, eng.watchdog.trips
    else:
        eng = _watchdog_engine(models, tmp_path)
        eng.watchdog.stalled_step_s = 0.0
        eng.submit([1, 2], 3)
        eng.drain()
        assert eng.watchdog.trips.get(kind, 0) >= 1
    _dump_files(tmp_path, kind)


def test_watchdog_detectors_survive_ledger_reset(models):
    eng = Engine(models[2], num_slots=2, max_len=64, kv_pool_blocks=5,
                 device="cpu")
    wd = eng.watchdog
    wd.check_interval_steps = 1
    wd.stall_trip_steps = 1
    wd.stuck_slot_s = 1e9
    eng.submit([1] * 16, 40)
    eng.submit([2] * 16, 40)
    eng.step()
    eng.step()
    before = wd.trips.get("admission_stall", 0)
    assert before >= 1
    eng.drain()
    eng.reset_latency_stats()
    assert eng.block_pool.stall_steps == 0
    eng.submit([1] * 16, 40)
    eng.submit([2] * 16, 40)
    eng.step()
    eng.step()
    assert wd.trips.get("admission_stall", 0) > before
    eng.drain()


def test_debug_views(models):
    """tests/test_flight.py's debug-view shapes, and the trie occupancy
    after a donation."""
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    eng.submit([1, 2, 3], 8, deadline_s=30.0, slo_class="interactive")
    eng.submit([4, 5], 8)
    eng.submit([6] * 5, 8, deadline_s=45.0)
    eng.step()
    slots = eng.debug_slots()
    json.dumps(slots)
    active = [s for s in slots["slots"] if s["state"] == "active"]
    assert slots["active"] == 2 and {s["rid"] for s in active} == {0, 1}
    assert active[0]["slo_class"] == "interactive"
    assert active[0]["tokens"] >= 1 and active[0]["age_s"] >= 0
    sched = eng.debug_scheduler()
    json.dumps(sched)
    q = sched["queue"][0]
    assert sched["queued"] == 1 and q["rid"] == 2
    assert q["deadline_s"] == 45.0 and q["expired"] is False
    pool = eng.debug_kvpool()
    json.dumps(pool)
    frag = pool["fragmentation"]
    assert pool["paged"] is True and 0.0 <= frag["internal"] <= 1.0
    assert frag["reserved_positions"] >= frag["used_positions"] > 0
    assert len(pool["live_requests"]) == 2 and pool["trie"]["enabled"]
    eng.drain()
    dense = Engine(models[2], num_slots=2, max_len=64, paged=False,
                   device="cpu")
    assert dense.debug_kvpool() == {"paged": False}
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 50, 40).tolist()
    eng.submit(prompt, 4)
    eng.drain()
    trie = eng.debug_kvpool()["trie"]
    assert trie["nodes"] == 2 and trie["cached_tokens"] == 32
    assert trie["max_depth"] >= 1
    assert sum(trie["depth_histogram"].values()) == 2


def test_telemetry_off_engine_runs_the_same(models):
    """Telemetry adds no program and changes no token: the same requests
    with the tracer, flight recorder and watchdogs off."""
    def run(**kw):
        eng = Engine(models[2], num_slots=2, max_len=64, device="cpu", **kw)
        rids = [eng.submit([1 + i, 2], 5, deadline_s=30.0)
                for i in range(4)]
        done = {r.rid: r.tokens for r in eng.drain()}
        return ([done[r] for r in rids], eng.program_counts(),
                eng.max_programs(), eng.steps)

    on = run()
    off = run(flight=tobs.FlightRecorder(enabled=False),
              tracer=tobs.SpanTracer(enabled=False), watchdogs=False)
    assert on == off


def test_trainer_registry_and_spans(tmp_path):
    """The trainer's gauges at a log point equal its log; eval and
    checkpoint spans exist (a 4-iteration CPU run on a byte dataset)."""
    from nanosandbox_tpu_torch.train import Trainer, load_config

    data = tmp_path / "data" / "tiny"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        rng.integers(0, 64, 4096).astype(np.uint16).tofile(
            data / f"{split}.bin")
    cfg = load_config([
        "--device=cpu", f"--data_dir={tmp_path / 'data'}", "--dataset=tiny",
        "--vocab_size=64", f"--out_dir={tmp_path / 'out'}",
        "--n_layer=1", "--n_head=2", "--n_embd=32", "--block_size=16",
        "--batch_size=2", "--max_iters=4", "--eval_interval=2",
        "--eval_iters=1", "--log_interval=1", "--warmup_iters=0",
        "--lr_decay_iters=4", "--always_save_checkpoint=True",
        "--tensorboard=False", f"--log_dir={tmp_path / 'runs'}"])
    trainer = Trainer(cfg)
    out = trainer.run()
    snap = trainer.metrics.snapshot()
    last = out["log"][-1]
    assert snap["train_loss"]["series"][0]["value"] == last["loss"]
    assert snap["train_iters_total"]["series"][0]["value"] == last["iter"] + 1
    assert {s["labels"]["split"] for s in snap["eval_loss"]["series"]} == \
        {"train", "val"}
    assert snap["checkpoint_saves_total"]["series"][0]["value"] >= 2
    names = [s.name for s in trainer.tracer.spans()]
    assert "eval" in names and "checkpoint_save" in names
    assert trainer.tracer.open_count() == 0


# ---------------------------------------------------------------------------
# the HTTP surface
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? [-+0-9.eInfNa]+$')


def _parse(text) -> dict:
    """{family: type}; every line a comment or a sample (tests/test_obs.py's
    stdlib check of the exposition grammar)."""
    types = {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            assert name not in types
            types[name] = kind
        elif not ln.startswith("# HELP "):
            assert _SAMPLE.match(ln), ln
    return types


def _metric(text, name) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def test_http_metrics_trace_debug_profile_drain(models):
    eng = Engine(models[2], num_slots=2, max_len=64, device="cpu")
    loop = EngineLoop(eng)
    loop.start()
    srv = make_server("127.0.0.1", 0, loop)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, before, _ = _get(base + "/metrics")
        assert code == 200
        for i in range(2):
            code, body = _post(base + "/generate", {
                "prompt_tokens": [1 + i, 2, 3], "max_new_tokens": 5,
                "temperature": 0.0})
            assert code == 200 and len(body["tokens"]) == 5
        code, text, headers = _get(base + "/metrics")
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        types = _parse(text)
        assert types["serve_ttft_seconds"] == "histogram"
        assert types["serve_loop_waiting"] == "gauge"
        st = json.loads(_get(base + "/stats")[1])
        assert _metric(text, "serve_requests_submitted_total") - _metric(
            before, "serve_requests_submitted_total") == 2
        assert _metric(text, "serve_tokens_generated_total") == \
            st["tokens_generated"] == 10
        # /trace: one request's spans; an unknown rid is a 404.
        code, body, _ = _get(base + "/trace?rid=0")
        names = [e["name"] for e in json.loads(body)["traceEvents"]
                 if e["ph"] == "X" and e["args"].get("rid") == 0]
        assert sorted(names) == ["generate", "queued"]
        assert _get(base + "/trace?rid=999")[0] == 404
        assert _get(base + "/trace?rid=x")[0] == 400
        code, body, _ = _get(base + "/debug/requests?rid=1")
        evs = [e["ev"] for e in json.loads(body)["events"]]
        assert evs[0] == "submit" and "finish" in evs and evs[-1] == "http"
        code, body, headers = _get(base + "/debug/requests?format=jsonl")
        assert headers["Content-Type"] == "application/x-ndjson"
        assert all(json.loads(ln) for ln in body.splitlines())
        assert _get(base + "/debug/requests?rid=999")[0] == 404
        for view in ("slots", "kvpool", "scheduler"):
            code, body, _ = _get(base + f"/debug/{view}")
            assert code == 200 and json.loads(body)
        # /profile: a CPU torch.profiler window over the next steps.
        code, body = _post(base + "/profile", {"steps": 3})
        assert code == 200 and body["steps"] == 3
        assert _post(base + "/profile", {"cancel": True}) == (
            200, {"ok": True, "cancelled": True})
        assert _post(base + "/profile", {"steps": 0})[0] == 400
        code, body = _post(base + "/profile", {"steps": 3})
        assert _post(base + "/generate", {"prompt_tokens": [5, 6],
                                          "max_new_tokens": 6})[0] == 200
        prof = json.loads(_get(base + "/stats")[1])["profile"]["last"]
        assert prof["dir"] == body["dir"] and prof["steps_profiled"] >= 1
        assert os.path.getsize(prof["trace"]) > 0
        # /drain: readiness red at once, the request in flight finishes.
        got = {}
        t = threading.Thread(target=lambda: got.update(r=_post(
            base + "/generate", {"prompt_tokens": [9], "max_new_tokens": 40,
                                 "temperature": 0.0})))
        t.start()
        while not loop._by_rid:
            time.sleep(0.001)
        code, body = _post(base + "/drain", {})
        assert code == 200 and body["draining"] is True
        code, body, _ = _get(base + "/healthz?ready=1")
        assert code == 503 and json.loads(body)["reason"] == "draining"
        assert _post(base + "/generate", {"prompt_tokens": [1]})[0] == 503
        t.join(timeout=60)
        assert got["r"][0] == 200 and len(got["r"][1]["tokens"]) == 40
        assert _get(base + "/healthz")[0] == 200
        assert _post(base + "/drain", {})[1]["drained"] is True
    finally:
        srv.shutdown()
        srv.server_close()
        loop.stop()


def test_process_vitals_and_obs_imports_no_torch():
    reg = tobs.register_process_vitals(tobs.MetricRegistry())
    assert tobs.register_process_vitals(reg) is reg
    snap = reg.snapshot()
    for name in ("process_resident_memory_bytes", "process_open_fds",
                 "process_uptime_seconds", "process_start_time_seconds"):
        assert snap[name]["series"][0]["value"] > 0, name
    if not torch.cuda.is_initialized():
        assert snap["torch_cuda_allocated_bytes"]["series"] == []
    code = ("import sys\nimport nanosandbox_tpu_torch.obs as o\n"
            "o.register_process_vitals().snapshot()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'nanosandbox_tpu')]\nprint(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=60,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
