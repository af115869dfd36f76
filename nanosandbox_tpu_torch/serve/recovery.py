"""Engine supervisor: crash-safe stepping with bounded-backoff recovery
and escalation to permanent failure.

This package's own copy of nanosandbox_tpu/serve/recovery.py. The Engine
owns the recovery mechanism (poison detection, the in-place reset of its
device state, re-admission of every victim: Engine.recover); this module
owns the policy: when to recover, how long to back off, and when to stop
trying. ``EngineSupervisor.step()`` stands in for ``Engine.step()``
(http.EngineLoop, the tests and chip_smoke.py drive it as they drive the
engine) and turns three failure classes into recoveries:

  poisoned step     the step's isfinite sentinel (or an injected fault)
                    surfaced out-of-vocab tokens at the readback:
                    quarantine and reset, KEEPING the KV pool and the
                    prefix cache (a poisoned step only wrote its rows'
                    private frontier positions), so every victim's
                    resume is a prefix hit.
  step exception    a dispatch raised (an injected prefill_exc, a device
                    error): the reset also flushes the prefix cache and
                    zeroes the pools.
  watchdog trip     stuck_slot / stalled_step: a wedge with no exception
                    to catch; the same quarantine and reset.

Attempts back off exponentially (base * 2^(n-1), capped), and more than
``max_consecutive`` faults without a clean stretch of ``settle_s``
escalate to permanent failure: every in-flight and queued request gets a
terminal 'failed' Result with its tokens so far, and submissions raise
EngineFailedError (503 upstream). On the engine's registry the
supervisor publishes, as JAX's does, the ``serve_recovery_ttfrt_seconds``
histogram (detection to the first retired token after it) and the
one-hot ``serve_supervisor_state{state=}`` gauge.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

# The watchdog kinds a reset can help (obs/flight.py).
RECOVERABLE_TRIPS = ("stuck_slot", "stalled_step")


class EngineSupervisor:
    """``step()`` like an Engine, plus quarantine / reset / backoff /
    permanent-failure policy.

    engine : the Engine to supervise.
    max_consecutive : recoveries tolerated without a ``settle_s`` clean
        stretch before escalating to permanent failure.
    backoff_base_s / backoff_max_s : the backoff between a detection and
        its reset (base * 2^(n-1), capped); tests pass base 0.
    settle_s : a fault-free stretch this long resets the count.
    sleep : injectable clock for tests.
    """

    def __init__(self, engine, *, max_consecutive: int = 4,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 5.0,
                 settle_s: float = 60.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.max_consecutive = int(max_consecutive)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.settle_s = float(settle_s)
        self._sleep = sleep
        self.state = "ok"                   # ok | failed
        self.recoveries = 0
        self.consecutive = 0
        self.last_cause: Optional[str] = None
        self.last_detail = ""
        self.last_backoff_s = 0.0
        self._last_fault_t: Optional[float] = None
        self._trip_mark = {k: engine.watchdog.trips.get(k, 0)
                           for k in RECOVERABLE_TRIPS}
        # Time to the first retired token after a quarantine (TTFRT):
        # detection to the first token of the victims' resumes.
        self._await_tok_t: Optional[float] = None
        self._tok_mark = 0
        m = engine.metrics
        self._h_ttfrt = m.histogram(
            "serve_recovery_ttfrt_seconds",
            "Quarantine detection -> first post-recovery retired token.",
            unit="seconds",
            buckets=(0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0))
        self._g_state = m.gauge(
            "serve_supervisor_state",
            "Supervisor state one-hot (ok | failed).",
            labelnames=("state",))
        self._g_state.labels(state="ok").set(1.0)

    def step(self) -> List:
        """One supervised engine step: the engine's finished Results. On
        a detected fault the recovery happens here (quarantine, backoff,
        reset, requeue) and the victims finish through later steps.
        After permanent failure this only flushes Results the engine
        already owed."""
        eng = self.engine
        if self.state == "failed":
            return eng.step()
        try:
            results = eng.step()
        except Exception as e:      # a dispatch raised: buffers suspect
            return self._handle_fault(
                f"step_error:{type(e).__name__}", flush_cache=True,
                detail=str(e))
        poison = eng.take_poison()
        cause = (poison.get("kind", "poisoned_step") if poison is not None
                 else self._watchdog_cause())
        if cause is not None:
            results = list(results)
            results.extend(self._handle_fault(cause, flush_cache=False))
            return results
        now = time.monotonic()
        if (self._await_tok_t is not None
                and eng.tokens_generated > self._tok_mark):
            self._h_ttfrt.observe(now - self._await_tok_t)
            self._await_tok_t = None
        if (self.consecutive and self._last_fault_t is not None
                and now - self._last_fault_t > self.settle_s):
            self.consecutive = 0
        return results

    def drain(self) -> List:
        """step() until idle: the supervised Engine.drain()."""
        out: List = []
        while self.engine.has_work() and self.state != "failed":
            out.extend(self.step())
        out.extend(self.engine.step())      # flush any stragglers
        return out

    def _watchdog_cause(self) -> Optional[str]:
        trips = self.engine.watchdog.trips
        for kind, seen in self._trip_mark.items():
            cur = trips.get(kind, 0)
            if cur > seen:
                self._trip_mark[kind] = cur
                return kind
        return None

    def _handle_fault(self, cause: str, *, flush_cache: bool,
                      detail: str = "") -> List:
        eng = self.engine
        now = time.monotonic()
        if (self._last_fault_t is not None
                and now - self._last_fault_t > self.settle_s):
            self.consecutive = 0
        self._last_fault_t = now
        self.consecutive += 1
        self.last_cause = cause
        self.last_detail = detail
        eng.quarantine(cause)
        if self.consecutive > self.max_consecutive:
            # Recovery is not converging: drain cleanly instead of
            # burning the ladder forever on the same poison.
            self.state = "failed"
            self._g_state.labels(state="ok").set(0.0)
            self._g_state.labels(state="failed").set(1.0)
            return eng.abort_all(
                f"{cause} x{self.consecutive} (recovery exhausted)")
        backoff = min(self.backoff_base_s * (2 ** (self.consecutive - 1)),
                      self.backoff_max_s)
        self.last_backoff_s = backoff
        if backoff > 0:
            self._sleep(backoff)
        self._tok_mark = eng.tokens_generated
        self._await_tok_t = now
        eng.recover(cause, flush_cache=flush_cache)
        self.recoveries += 1
        return []

    def stats(self) -> dict:
        return {"state": self.state,
                "recoveries": self.recoveries,
                "consecutive": self.consecutive,
                "max_consecutive": self.max_consecutive,
                "last_cause": self.last_cause,
                "last_detail": self.last_detail,
                "last_backoff_s": self.last_backoff_s,
                "ttfrt_s": self._h_ttfrt.percentiles((50, 90, 99))}
