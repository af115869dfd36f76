"""Per-request SLO accounting: deadlines, attainment, goodput.

This package's own copy of nanosandbox_tpu/obs/slo.py's ledger. Each
request may carry a ``deadline_s`` (submit-to-finish budget) and an
``slo_class`` label; at its terminal event the engine records the
outcome here: ``met`` (finished within its deadline), ``missed``
(finished late) or ``shed`` (dropped from the queue). Tokens of met
requests are goodput, those of missed ones late tokens. Requests without
a deadline are not tracked at all.

Terminal events update plain ints (and observe one histogram). On the
engine's metric registry the ledger publishes, as JAX's does:

  * ``serve_slo_requests_total{slo_class=,outcome=}`` (met, missed, shed);
  * ``serve_goodput_tokens_total{slo_class=}``;
  * ``serve_slo_attainment{slo_class=}``: met / (met + missed + shed);
  * ``serve_deadline_margin_seconds{slo_class=,prefix=}``: a histogram of
    deadline - end-to-end latency at finish, by prefix-cache outcome.

The counters and the gauge are mirrored by a collector per scrape, so a
terminal costs the hot loop a few int adds. Classes that never saw a
deadline-carrying request mint no series.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

# Margin buckets (seconds): symmetric around 0, the miss boundary.
MARGIN_BUCKETS = (-60.0, -10.0, -5.0, -1.0, -0.5, -0.1, 0.0,
                  0.1, 0.5, 1.0, 5.0, 10.0, 60.0)

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
    """Plain-int per-class deadline accounting, one per Engine, mirrored
    into ``registry`` (an obs.MetricRegistry, the engine's) at
    collection time."""

    def __init__(self, registry):
        self._classes: Dict[str, _ClassLedger] = {}
        self._c_req = registry.counter(
            "serve_slo_requests_total",
            "Deadline-carrying requests by terminal outcome.",
            labelnames=("slo_class", "outcome"))
        self._c_goodput = registry.counter(
            "serve_goodput_tokens_total",
            "Tokens of requests that finished within their deadline.",
            labelnames=("slo_class",))
        self._g_attain = registry.gauge(
            "serve_slo_attainment",
            "met / (met + missed + shed) per SLO class.",
            labelnames=("slo_class",))
        self._h_margin = registry.histogram(
            "serve_deadline_margin_seconds",
            "deadline_s minus end-to-end latency at finish (negative = "
            "missed), by class and prefix-cache outcome.",
            unit="seconds", labelnames=("slo_class", "prefix"),
            buckets=MARGIN_BUCKETS)
        registry.add_collector(self._collect)

    def _cls(self, slo_class: str) -> _ClassLedger:
        led = self._classes.get(slo_class)
        if led is None:
            led = self._classes[slo_class] = _ClassLedger()
        return led

    def record_finish(self, slo_class: str, *, tokens: int,
                      elapsed_s: float, deadline_s: Optional[float],
                      prefix: str = "miss") -> Optional[bool]:
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
        self._h_margin.labels(slo_class=slo_class,
                              prefix=prefix).observe(deadline_s - elapsed_s)
        return met

    def record_shed(self, slo_class: str) -> None:
        """A deadline-carrying request dropped from the queue: counts
        against attainment with zero good tokens."""
        self._cls(slo_class).shed += 1

    def _collect(self) -> None:
        for name, led in list(self._classes.items()):
            for outcome in ("met", "missed", "shed"):
                self._c_req.labels(slo_class=name, outcome=outcome
                                   )._set_total(getattr(led, outcome))
            self._c_goodput.labels(slo_class=name)._set_total(
                led.goodput_tokens)
            total = led.met + led.missed + led.shed
            self._g_attain.labels(slo_class=name).set(
                led.met / total if total else 0.0)

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
        """Zero the ledger (after a warmup). The mirrored series reset
        too: a cleared class would otherwise keep its last totals on the
        scrape."""
        self._classes.clear()
        for fam in (self._c_req, self._c_goodput, self._g_attain,
                    self._h_margin):
            fam.reset()
