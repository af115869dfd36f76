"""Anomaly watchdogs over the serving engine's host-side state.

This package's own copy of the two detectors of
nanosandbox_tpu/obs/flight.py's WatchdogPanel that recovery acts on
(serve/recovery.py RECOVERABLE_TRIPS):

  stuck_slot    an active slot with no retired token for stuck_slot_s:
                a wedged device or a dead pipeline, caught before the
                client's timeout.
  stalled_step  ONE engine step whose wall time exceeded stalled_step_s
                (fed by Engine.step's own clock): a wedged dispatch or
                readback that did return in the end.

A trip counts in ``trips`` by kind and is kept as ``last_trip``. The
JAX panel's four other detectors (ttft_spike, admission_stall,
pool_thrash, post_freeze_retrace), its dumps of the flight ledger, span
ring and stats, the flight recorder itself and the trip counter's
metric family are a later slice of the port.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class WatchdogPanel:
    """The stuck_slot and stalled_step detectors. ``on_step_time`` is
    fed each step's wall time; ``check`` polls the active slots, every
    ``check_interval_steps`` engine steps."""

    KINDS = ("stuck_slot", "stalled_step")

    def __init__(self, engine, *, check_interval_steps: int = 16,
                 stuck_slot_s: float = 120.0,
                 stalled_step_s: float = 30.0):
        self.engine = engine
        self.check_interval_steps = max(1, int(check_interval_steps))
        self.stuck_slot_s = stuck_slot_s
        self.stalled_step_s = stalled_step_s
        self.trips: Dict[str, int] = {}
        self.last_trip: Optional[dict] = None
        self._last_check_step = -1

    def on_step_time(self, dt_s: float) -> None:
        """One step past ``stalled_step_s`` is a wedged dispatch, not
        load (load shows as many normal steps)."""
        if dt_s > self.stalled_step_s:
            self._trip("stalled_step",
                       {"step_s": dt_s, "limit_s": self.stalled_step_s})

    def check(self, now: Optional[float] = None) -> None:
        """Poll the stuck-slot detector; called once per engine step and
        self-throttled to every check_interval_steps."""
        step = self.engine.steps
        if step - self._last_check_step < self.check_interval_steps:
            return
        self._last_check_step = step
        now = time.monotonic() if now is None else now
        for slot, st in list(self.engine._active.items()):
            if now - st.last_t > self.stuck_slot_s:
                self._trip("stuck_slot",
                           {"slot": slot, "rid": st.req.rid,
                            "idle_s": now - st.last_t,
                            "tokens": len(st.tokens)})
                break                     # one trip a poll is plenty

    def _trip(self, kind: str, info: dict) -> None:
        self.trips[kind] = self.trips.get(kind, 0) + 1
        self.last_trip = {"kind": kind, "n": self.trips[kind],
                          "wall": time.time(), **info}

    def reset(self) -> None:
        """Forget the poll position (trips already counted stay)."""
        self._last_check_step = -1

    def stats(self) -> dict:
        return {"trips": dict(self.trips), "last_trip": self.last_trip}
