"""Request-lifecycle flight recorder and anomaly watchdogs.

This package's own copy of nanosandbox_tpu/obs/flight.py. The metric
registry answers "how slow is it" in aggregate and the span tracer "when
did things run"; neither answers "what happened to request 4812" after
the fact, nor notices that the engine has started thrashing its KV pool.
Two host-side pieces close that gap:

  * ``FlightRecorder``: a bounded ledger of per-request lifecycle
    events. Every request leaves a track::

        submit -> queue -> [block_stall*] -> block_reserve -> admit ->
        prefill[hit|miss] -> retire* -> evict -> finish
                 (or terminal: reject at submit / shed from the queue /
                 failed on permanent-failure drain)

    A chunked prefill adds ``prefill_chunk`` events before its admit; a
    preempted request a ``preempt`` and a second ``queue`` ... ``admit``
    round. Under fault recovery a track may carry fault / poison /
    quarantine / requeue / recover events: the request re-enters the
    queue and still reaches exactly one terminal.

    Across replicas and tiers rids are namespaced (``r0:17``,
    ``prefill:7``: the recorder's ``namespace``), so the ledgers of a
    fleet or a prefill/decode pair merge into one stream in which each
    rid still ends once. A fleet's own recorder adds ``route``,
    ``failover`` and ``replica_down`` events, never a terminal. A
    migrated request's track spans two engines: ``export`` on the
    prefill side (first token sampled, the request parked in migration
    limbo with its slot freed and its blocks held), ``migrate`` there
    when the chain has moved (blocks, bytes, destination), ``adopt`` on
    the decode side (the chain admitted as a prefix hit, no prefill),
    or ``requeue`` at the source when the handoff failed and the
    request falls back to colocated decode under the same rid.

    Each event is one small dict recorded from host state the engine
    already holds (ints and floats), so the pipelined loop gains no
    device read. A record is a dict build and a deque append under a
    lock, pinned by test at < 50 us/event. Export is JSONL (one event a
    line) or the ``GET /debug/requests`` JSON view.

  * ``WatchdogPanel``: cheap per-step anomaly detectors over the
    engine's plain-int state (TTFT spike against a rolling baseline,
    admission stalled on KV blocks, prefix-cache eviction thrash, a
    program built after the warmup, stuck slot, stalled step). A trip
    increments ``watchdog_trips_total{kind=}`` and snapshots the flight
    ledger, the span ring and the engine's stats to a dump directory:
    the black box an operator opens after the incident.

Stdlib and plain Python state only; no torch import.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# Terminal lifecycle events: every submitted request must reach EXACTLY
# one of these (the no-orphan contract tests fuzz against, including
# across engine recoveries — a fault-interrupted, re-admitted request
# still terminates exactly once). 'failed' is the permanent-failure
# drain (recovery exhausted; partial tokens salvaged).
TERMINAL_EVENTS = ("finish", "reject", "shed", "failed")


class FlightRecorder:
    """Bounded ring of per-request lifecycle events.

    ``record()`` is the hot-path entry: one dict build + one deque
    append under a lock.  Queries (``events``, ``to_jsonl``, ``dump``)
    copy the ring under the same lock and filter on the copy, so an
    HTTP debug handler never races the engine thread's appends.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 namespace: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        # Fleet namespacing: with a namespace (a replica id), every
        # recorded rid becomes "<namespace>:<rid>", so N
        # replicas' ledgers merge into ONE JSONL trace that stays
        # exactly-once analyzable — replica 0's request 7 and replica
        # 1's request 7 are different tracks, not a double terminal.
        # Engine-internal int-rid lookups keep working: queries
        # normalize through the same mapping.
        self.namespace = namespace
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        # Epoch pair: events carry monotonic "t" (orderable, immune to
        # clock steps); exports add a wall-clock view computed from the
        # pairing so JSONL lines correlate with external logs.
        self._t0_mono = time.monotonic()
        self._t0_wall = time.time()
        self.recorded = 0            # total ever (ring rotation visible)
        self._cleared = 0            # events removed by clear(), not rotation

    def _rid(self, rid):
        """Apply the namespace to an engine-local int rid; strings (an
        already-namespaced id, or a caller's own scheme) pass through."""
        if rid is None or self.namespace is None or isinstance(rid, str):
            return rid
        return f"{self.namespace}:{rid}"

    # ------------------------------------------------------------ record
    def record(self, ev: str, rid: Optional[int] = None,
               step: Optional[int] = None, **fields) -> None:
        """Append one event. ``rid`` None is legal for events with no
        request id (a reject happens before one is assigned)."""
        if not self.enabled:
            return
        e: dict = {"t": time.monotonic(), "ev": ev, "rid": self._rid(rid)}
        if step is not None:
            e["step"] = step
        if fields:
            e.update(fields)
        with self._lock:
            self._ring.append(e)
            self.recorded += 1

    # ----------------------------------------------------------- queries
    def _snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def events(self, rid: Optional[int] = None,
               last_s: Optional[float] = None) -> List[dict]:
        """Event copies (oldest first) with the wall-clock view added:
        ``t`` becomes seconds since recorder start, ``wall`` the unix
        timestamp. Optionally filtered to one rid / trailing window."""
        out = self._snapshot()
        if rid is not None:
            rid = self._rid(rid)
            out = [e for e in out if e.get("rid") == rid]
        if last_s is not None:
            horizon = time.monotonic() - last_s
            out = [e for e in out if e["t"] >= horizon]
        return [{**e, "t": round(e["t"] - self._t0_mono, 6),
                 "wall": round(e["t"] - self._t0_mono + self._t0_wall, 6)}
                for e in out]

    def to_jsonl(self, rid: Optional[int] = None,
                 last_s: Optional[float] = None) -> str:
        """One JSON object per line: the dump format the watchdogs write
        on a trip."""
        lines = [json.dumps(e, sort_keys=True)
                 for e in self.events(rid=rid, last_s=last_s)]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str) -> int:
        """Write the ledger as JSONL; returns the event count."""
        text = self.to_jsonl()
        with open(path, "w") as f:
            f.write(text)
        return 0 if not text else text.count("\n")

    def terminals(self, rid: int) -> List[str]:
        """Terminal event names recorded for one rid — the no-orphan
        test asserts len == 1 for every request the engine ever saw."""
        rid = self._rid(rid)
        return [e["ev"] for e in self._snapshot()
                if e.get("rid") == rid and e["ev"] in TERMINAL_EVENTS]

    def counts(self) -> Dict[str, int]:
        """Event counts by kind over the current ring (debug view)."""
        out: Dict[str, int] = {}
        for e in self._snapshot():
            out[e["ev"]] = out.get(e["ev"], 0) + 1
        return out

    def clear(self) -> None:
        """Drop recorded events (benchmarks clear between warmup and
        the timed window, like reset_latency_stats)."""
        with self._lock:
            self._cleared += len(self._ring)
            self._ring.clear()

    def stats(self) -> dict:
        with self._lock:
            # dropped = lost to RING ROTATION only; deliberately cleared
            # events (warmup hygiene) are not capacity pressure.
            dropped = self.recorded - self._cleared - len(self._ring)
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "namespace": self.namespace,
                    "events": len(self._ring), "recorded": self.recorded,
                    "dropped": max(0, dropped)}


class WatchdogPanel:
    """Anomaly detectors over the engine's host-side state.

    The panel is event-fed (``on_ttft`` at each admission,
    ``on_step_time`` from each step) plus polled (``check`` from the
    engine step, every ``check_interval_steps``): each poll is a handful
    of int compares and an O(num_slots) scan. Detectors:

      ttft_spike          TTFT > spike_factor x rolling-median baseline
                          (and above ttft_min_s: tiny absolute TTFTs
                          never page) once >= min_samples exist.
      admission_stall     the queue head deferred on KV-block
                          availability for stall_trip_steps consecutive
                          polls: pool pressure is now user-visible
                          queueing, not a transient.
      pool_thrash         prefix-cache evictions exceeding the whole
                          pool within one poll window: allocations are
                          fighting the cache block for block.
      post_freeze_retrace a program built AFTER mark_steady(). In this
                          package the programs are the CUDA graphs the
                          engine captures and the kernel libraries built
                          at first use (Engine.program_counts), where
                          JAX's are jit traces: a capture or a build
                          past the warmup eats a live request's latency.
      stuck_slot          an active slot with no retired token for
                          stuck_slot_s: a wedged device or a dead
                          pipeline, caught before the client's timeout.
      stalled_step        ONE engine step whose wall time exceeded
                          stalled_step_s (fed by Engine.step's clock): a
                          wedged dispatch or readback that did return;
                          the recovery supervisor treats it (with
                          stuck_slot) as recoverable.

    A trip increments ``watchdog_trips_total{kind=}`` on the engine's
    registry and (rate-limited per kind by ``cooldown_s``) snapshots the
    flight ledger, the span ring and ``engine.stats()`` into
    ``dump_dir/<kind>-<n>-<unixtime>/`` (flight-<kind>.jsonl,
    trace-<kind>.json, meta-<kind>.json). Dumps are serialised by a lock
    and every file carries the trip kind, so two trips of different
    kinds racing (an HTTP-thread feed against the engine thread's poll)
    never interleave into one snapshot. Dump failures are counted, never
    raised: the serving loop outlives its black box."""

    KINDS = ("ttft_spike", "admission_stall", "pool_thrash",
             "post_freeze_retrace", "stuck_slot", "stalled_step")

    def __init__(self, engine, *, dump_dir: Optional[str] = None,
                 enabled: bool = True,
                 cooldown_s: float = 60.0,
                 check_interval_steps: int = 16,
                 ttft_spike_factor: float = 8.0,
                 ttft_min_samples: int = 32,
                 ttft_min_s: float = 0.25,
                 ttft_baseline_window: int = 128,
                 stall_trip_steps: int = 64,
                 thrash_factor: float = 1.0,
                 stuck_slot_s: float = 120.0,
                 stalled_step_s: float = 30.0):
        self.engine = engine
        self.enabled = enabled
        self.dump_dir = dump_dir
        self.cooldown_s = cooldown_s
        self.check_interval_steps = max(1, int(check_interval_steps))
        self.ttft_spike_factor = ttft_spike_factor
        self.ttft_min_samples = ttft_min_samples
        self.ttft_min_s = ttft_min_s
        self.stall_trip_steps = stall_trip_steps
        self.thrash_factor = thrash_factor
        self.stuck_slot_s = stuck_slot_s
        self.stalled_step_s = stalled_step_s
        self.trips: Dict[str, int] = {}
        self.last_trip: Optional[dict] = None
        self.dump_errors = 0
        self._ttft_ring: deque = deque(maxlen=ttft_baseline_window)
        self._last_dump: Dict[str, float] = {}
        # Dumps serialize: concurrent trips of different kinds must not
        # interleave their writes (regression-pinned).
        self._dump_lock = threading.Lock()
        self._last_check_step = -1
        self._stall_mark = 0         # block_pool.stall_steps at last poll
        self._stall_polls = 0        # consecutive polls with stall growth
        self._evict_mark = 0
        self._steady_traces: Optional[int] = None
        # The trip counter family lives on the engine registry so a
        # scrape sees trips next to the latency they explain; children
        # appear only when a kind actually trips (label hygiene).
        self._c_trips = engine.metrics.counter(
            "watchdog_trips_total",
            "Anomaly watchdog trips, by detector kind.",
            labelnames=("kind",))

    # ------------------------------------------------------------- feeds
    def on_ttft(self, ttft_s: float) -> None:
        """Called at each admission with the just-observed TTFT (an
        already-host-resident float). Baseline = rolling median."""
        if not self.enabled:
            return
        ring = self._ttft_ring
        if (len(ring) >= self.ttft_min_samples
                and ttft_s >= self.ttft_min_s):
            baseline = sorted(ring)[len(ring) // 2]
            if baseline > 0 and ttft_s > self.ttft_spike_factor * baseline:
                self._trip("ttft_spike",
                           {"ttft_s": ttft_s, "baseline_s": baseline,
                            "factor": ttft_s / baseline})
        ring.append(ttft_s)

    def on_step_time(self, dt_s: float) -> None:
        """Called by the engine with each step's wall time: one step
        past ``stalled_step_s`` is a wedged dispatch (a hung device, a
        runaway host stall), not load — load shows up as MANY normal
        steps. One float compare when healthy."""
        if not self.enabled:
            return
        if dt_s > self.stalled_step_s:
            self._trip("stalled_step",
                       {"step_s": dt_s, "limit_s": self.stalled_step_s})

    def mark_steady(self) -> None:
        """Declare the program set complete (serve __main__ calls this
        after warmup): any graph capture or kernel build past this
        point trips post_freeze_retrace."""
        self._steady_traces = sum(self.engine.program_counts().values())

    def check(self, now: Optional[float] = None) -> None:
        """Poll the cheap detectors; called once per engine step and
        self-throttled to every check_interval_steps."""
        if not self.enabled:
            return
        step = self.engine.steps
        if step - self._last_check_step < self.check_interval_steps:
            return
        self._last_check_step = step
        now = time.monotonic() if now is None else now
        # stuck slot: an active row whose last retired token is old.
        for slot, st in list(self.engine._active.items()):
            if now - st.last_t > self.stuck_slot_s:
                self._trip("stuck_slot",
                           {"slot": slot, "rid": st.req.rid,
                            "idle_s": now - st.last_t,
                            "tokens": len(st.tokens)})
                break                     # one page per poll is plenty
        pool = self.engine.block_pool
        if pool is not None:
            # admission stall: the head deferred on blocks in EVERY
            # recent poll window — a transient resets the streak. A
            # counter moving BACKWARDS means the pool ledger was reset
            # (reset_latency_stats between bench points / post-warmup):
            # resync the mark instead of comparing against a stale high
            # value that would blind the detector.
            stalls = pool.stall_steps
            if stalls < self._stall_mark:
                self._stall_mark = stalls
                self._stall_polls = 0
            if self._evict_mark > pool.evicted_blocks:
                self._evict_mark = pool.evicted_blocks
            if stalls > self._stall_mark:
                self._stall_polls += 1
                if (self._stall_polls * self.check_interval_steps
                        >= self.stall_trip_steps):
                    self._trip("admission_stall",
                               {"stall_steps": stalls,
                                "free_blocks": pool.free_blocks,
                                "queued": self.engine.sched.queued})
                    self._stall_polls = 0
            else:
                self._stall_polls = 0
            self._stall_mark = stalls
            # pool thrash: evictions within one window exceeding the
            # whole pool (x thrash_factor).
            ev = pool.evicted_blocks
            if (ev - self._evict_mark
                    > self.thrash_factor * pool.num_blocks):
                self._trip("pool_thrash",
                           {"evicted_in_window": ev - self._evict_mark,
                            "num_blocks": pool.num_blocks})
            self._evict_mark = ev
        if self._steady_traces is not None:
            total = sum(self.engine.program_counts().values())
            if total > self._steady_traces:
                self._trip("post_freeze_retrace",
                           {"traces": total,
                            "steady_traces": self._steady_traces})
                self._steady_traces = total     # page once per new trace

    # -------------------------------------------------------------- trip
    def _trip(self, kind: str, info: dict) -> None:
        self.trips[kind] = self.trips.get(kind, 0) + 1
        self._c_trips.labels(kind=kind).inc()
        now = time.monotonic()
        entry = {"kind": kind, "n": self.trips[kind], "wall": time.time(),
                 **info}
        last = self._last_dump.get(kind)
        if last is None or now - last >= self.cooldown_s:
            self._last_dump[kind] = now
            entry["dump"] = self._dump(kind, entry)
        self.last_trip = entry

    def _dump(self, kind: str, info: dict) -> Optional[str]:
        """Snapshot flight + spans + stats to the dump dir; returns the
        dump path, or None when writing failed (recorded, not raised —
        a full disk must not kill the serving loop).

        Serialized under ``_dump_lock`` and every file is suffixed with
        the trip kind: two near-simultaneous trips of DIFFERENT kinds
        (e.g. an on_ttft feed racing the per-step poll from another
        thread in tests/benches) used to be able to interleave their
        writes into one snapshot directory; now each write completes
        whole, into unambiguously-named files (regression-pinned)."""
        with self._dump_lock:
            try:
                if self.dump_dir is None:
                    # lockcheck: disable=blocking-under-lock -- the dump
                    # I/O under _dump_lock is the point: the lock
                    # serialises whole snapshots and nothing
                    # latency-sensitive takes it.
                    self.dump_dir = tempfile.mkdtemp(
                        prefix="serve-watchdog-")
                d = os.path.join(
                    self.dump_dir,
                    f"{kind}-{self.trips[kind]}-{int(time.time())}")
                # lockcheck: disable=blocking-under-lock -- the same
                # deliberate serialisation as the mkdtemp above.
                os.makedirs(d, exist_ok=True)
                self.engine.flight.dump(
                    os.path.join(d, f"flight-{kind}.jsonl"))
                with open(os.path.join(d, f"trace-{kind}.json"), "w") as f:
                    json.dump(self.engine.tracer.export_chrome(), f)
                with open(os.path.join(d, f"meta-{kind}.json"), "w") as f:
                    json.dump({"trip": info, "trips": dict(self.trips),
                               "stats": self.engine.stats()}, f,
                              default=str)
                return d
            except OSError:
                self.dump_errors += 1
                return None

    # ------------------------------------------------------------- views
    def reset(self) -> None:
        """Clear the rolling TTFT baseline (warmup samples must not
        anchor it) without forgetting trips already counted."""
        self._ttft_ring.clear()
        self._stall_polls = 0

    def stats(self) -> dict:
        return {"enabled": self.enabled,
                "trips": dict(self.trips),
                "last_trip": self.last_trip,
                "dump_dir": self.dump_dir,
                "dump_errors": self.dump_errors}
