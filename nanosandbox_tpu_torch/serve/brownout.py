"""Brownout ladder: graceful load degradation driven by the SLO ledger.

This package's own copy of nanosandbox_tpu/serve/brownout.py. When the
engine burns its SLO (a recent window of deadline-carrying terminals
mostly missed or shed), the controller steps the engine down a ladder
of named levels, and steps back up only after a sustained healthy
stretch (hysteresis):

  level 0  ``normal``            full service.
  level 1  ``shrink_scan``       cap the decode chunk at scan_k // 2
                                 (a no-op at scan_k 1); the cap picks
                                 among the graphs already captured.
  level 2  ``no_spec``           suspend speculative decoding: a spec
                                 engine steps its plain decode graphs.
  level 3  ``shed_batch``        shed the batch class (priority < 1):
                                 queued batch requests end 'shed', and
                                 new ones shed at submit (429 upstream).
  level 4  ``interactive_only``  shed everything below interactive
                                 (priority < 2).

The controller judges a window every ``check_interval_steps`` engine
steps by its SLO attainment: it escalates at once when a window with
enough terminals attains below ``escalate_below``, and steps down one
level after ``clear_checks`` consecutive windows at or above
``clear_above`` (idle windows count as healthy). Without deadlines there
are no SLO events and it never escalates.

Each transition leaves a ``brownout`` flight event and moves the
``serve_brownout_level`` gauge and the
``serve_brownout_transitions_total{direction=}`` counter on the engine's
registry, as JAX's does.
"""

from __future__ import annotations

from typing import Optional

LEVELS = ("normal", "shrink_scan", "no_spec", "shed_batch",
          "interactive_only")


class BrownoutController:
    """SLO-burn load controller over one Engine: reads ``engine.slo``,
    ``engine.steps`` and ``engine.brownout_sheds``, writes the
    ``scan_cap`` / ``spec_suspended`` / ``brownout_min_priority`` knobs
    the engine consults.

    check_interval_steps : engine steps between window judgements.
    escalate_below / clear_above : window-attainment thresholds; the gap
        between them is the hysteresis band.
    min_window_events : deadline-carrying terminals a window needs
        before its attainment is trusted.
    clear_checks : consecutive healthy windows a step down takes.
    shed_batch_floor / interactive_floor : the priority floors of levels
        3 and 4 (requests below the floor shed).
    """

    def __init__(self, engine, *, check_interval_steps: int = 16,
                 escalate_below: float = 0.85,
                 clear_above: float = 0.95,
                 min_window_events: int = 4,
                 clear_checks: int = 3,
                 shed_batch_floor: int = 1,
                 interactive_floor: int = 2):
        self.engine = engine
        self.check_interval_steps = max(1, int(check_interval_steps))
        self.escalate_below = float(escalate_below)
        self.clear_above = float(clear_above)
        self.min_window_events = int(min_window_events)
        self.clear_checks = max(1, int(clear_checks))
        self.shed_batch_floor = int(shed_batch_floor)
        self.interactive_floor = int(interactive_floor)
        self.level = 0
        self.transitions = 0
        self._clear_streak = 0
        self._last_check_step = engine.steps
        self._mark = engine.slo.totals()
        self._bshed_mark = engine.brownout_sheds
        m = engine.metrics
        self._g_level = m.gauge(
            "serve_brownout_level",
            "Current brownout degradation level (0 = normal; see "
            "serve/brownout.py for the ladder).")
        self._c_trans = m.counter(
            "serve_brownout_transitions_total",
            "Brownout ladder transitions, by direction.",
            labelnames=("direction",))
        self._g_level.set(0.0)

    def on_step(self) -> None:
        """Called after every Engine.step(); judges one window per
        ``check_interval_steps``."""
        eng = self.engine
        if eng.steps - self._last_check_step < self.check_interval_steps:
            return
        self._last_check_step = eng.steps
        met, missed, shed = eng.slo.totals()
        bshed = eng.brownout_sheds
        m0, x0, s0 = self._mark
        b0, self._bshed_mark = self._bshed_mark, bshed
        self._mark = (met, missed, shed)
        # Sheds the controller's own floor caused are load removed, not
        # burn: counted as burn, level 3 would sustain itself on the
        # below-floor traffic it sheds and never clear. (Clamped: a
        # ledger reset can skew the two counters.)
        d_shed = max(0, (shed - s0) - (bshed - b0))
        d_met, d_events = met - m0, (met - m0) + (missed - x0) + d_shed
        # Negative deltas mean the ledger was reset: an idle window.
        if d_events >= self.min_window_events and d_met >= 0:
            attainment = d_met / d_events
            if attainment < self.escalate_below:
                self._clear_streak = 0
                if self.level < len(LEVELS) - 1:
                    self._set(self.level + 1, attainment=attainment)
                return
            if attainment < self.clear_above:
                # Hysteresis band: neither burning nor clearly healthy.
                self._clear_streak = 0
                return
        self._clear_streak += 1
        if self.level > 0 and self._clear_streak >= self.clear_checks:
            self._clear_streak = 0
            self._set(self.level - 1)

    def _set(self, level: int, attainment: Optional[float] = None) -> None:
        """Move to ``level`` and apply the cumulative effects of every
        level at or below it, so a step down reverses by the same
        assignment and the knobs never drift from the level."""
        old, self.level = self.level, level
        eng = self.engine
        eng.scan_cap = max(1, eng.scan_k // 2) if level >= 1 else None
        eng.spec_suspended = level >= 2
        eng.brownout_min_priority = (
            self.interactive_floor if level >= 4
            else self.shed_batch_floor if level >= 3 else None)
        self.transitions += 1
        direction = "up" if level > old else "down"
        self._c_trans.labels(direction=direction).inc()
        self._g_level.set(float(level))
        info = {"level": level, "name": LEVELS[level],
                "from": LEVELS[old], "direction": direction}
        if attainment is not None:
            info["window_attainment"] = round(attainment, 4)
        eng.flight.record("brownout", step=eng.steps, **info)

    def stats(self) -> dict:
        return {"level": self.level,
                "name": LEVELS[self.level],
                "transitions": self.transitions,
                "clear_streak": self._clear_streak,
                "min_priority": self.engine.brownout_min_priority,
                "levels": list(LEVELS)}
