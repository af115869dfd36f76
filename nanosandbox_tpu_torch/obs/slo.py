"""Per-request SLO accounting: deadlines, attainment, goodput.

This package's own copy of nanosandbox_tpu/obs/slo.py's ledger. Each
request may carry a ``deadline_s`` (submit-to-finish budget) and an
``slo_class`` label; at its terminal event the engine records the
outcome here: ``met`` (finished within its deadline), ``missed``
(finished late) or ``shed`` (dropped from the queue). Tokens of met
requests are goodput, those of missed ones late tokens. Requests without
a deadline are not tracked at all.

Plain ints only. The JAX ledger mirrors them into its metric registry
(request and goodput counters, an attainment gauge, a deadline-margin
histogram by prefix-cache outcome, hence its ``prefix`` argument) at
collection time; that mirror comes with the port's registry, a later
slice.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

# Class names become metric label values; a bounded charset keeps an
# open HTTP surface from minting unbounded series.
_CLASS_RE = re.compile(r"^[a-zA-Z0-9_.\-]{1,32}$")


def validate_slo_class(slo_class: str) -> str:
    if not _CLASS_RE.match(slo_class):
        raise ValueError(
            f"slo_class {slo_class!r} must match {_CLASS_RE.pattern}")
    return slo_class


class _ClassLedger:
    __slots__ = ("met", "missed", "shed", "goodput_tokens", "late_tokens")

    def __init__(self):
        self.met = 0
        self.missed = 0
        self.shed = 0
        self.goodput_tokens = 0
        self.late_tokens = 0


class SLOLedger:
    """Plain-int per-class deadline accounting, one per Engine. Takes no
    metric registry (module docstring)."""

    def __init__(self):
        self._classes: Dict[str, _ClassLedger] = {}

    def _cls(self, slo_class: str) -> _ClassLedger:
        led = self._classes.get(slo_class)
        if led is None:
            led = self._classes[slo_class] = _ClassLedger()
        return led

    def record_finish(self, slo_class: str, *, tokens: int,
                      elapsed_s: float,
                      deadline_s: Optional[float]) -> Optional[bool]:
        """Terminal accounting for a finished request. Returns whether
        the deadline was met (None when the request carried none: such
        requests are not tracked)."""
        if deadline_s is None:
            return None
        led = self._cls(slo_class)
        met = elapsed_s <= deadline_s
        if met:
            led.met += 1
            led.goodput_tokens += tokens
        else:
            led.missed += 1
            led.late_tokens += tokens
        return met

    def record_shed(self, slo_class: str) -> None:
        """A deadline-carrying request dropped from the queue: counts
        against attainment with zero good tokens."""
        self._cls(slo_class).shed += 1

    def totals(self) -> tuple:
        """(met, missed, shed) across every class: the brownout
        controller differences this between its windows."""
        met = missed = shed = 0
        for led in list(self._classes.values()):
            met += led.met
            missed += led.missed
            shed += led.shed
        return met, missed, shed

    def stats(self) -> dict:
        """The Engine.stats()["slo"] view: per-class dicts and the
        cross-class rollup."""
        classes = {}
        met = missed = shed = goodput = late = 0
        for name, led in sorted(list(self._classes.items())):
            total = led.met + led.missed + led.shed
            classes[name] = {
                "met": led.met, "missed": led.missed, "shed": led.shed,
                "goodput_tokens": led.goodput_tokens,
                "late_tokens": led.late_tokens,
                "attainment": (led.met / total) if total else None,
            }
            met += led.met
            missed += led.missed
            shed += led.shed
            goodput += led.goodput_tokens
            late += led.late_tokens
        total = met + missed + shed
        return {"classes": classes,
                "overall": {"met": met, "missed": missed, "shed": shed,
                            "goodput_tokens": goodput,
                            "late_tokens": late,
                            "attainment": (met / total) if total else None}}

    def reset(self) -> None:
        """Zero the ledger (after a warmup)."""
        self._classes.clear()
