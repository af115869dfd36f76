"""Deterministic fault injection for the serving engine.

This package's own copy of nanosandbox_tpu/serve/faults.py: the same
plan text and seed fire at the same (site, step) as there. A
``FaultPlan`` is a pure, seeded schedule over named *sites* in the
engine's hot path: the engine asks ``plan.fire(site, step)`` at each
site visit, and the answer is a deterministic function of (plan, step,
visit count), so the same plan against the same workload fails at the
same place every run.

Sites (where the port's Engine consults the plan):

  nan_logits      the dispatched decode or verify step's readback tokens
                  are replaced by the out-of-vocab sentinel: what
                  non-finite logits produce (the step's own isfinite
                  guard maps real ones to the same sentinel, so the
                  detection under test is the production one).
  slow_step       ``stall_s`` seconds of host stall at the decode
                  dispatch, caught by the ``stalled_step`` watchdog.
  alloc_fail      BlockPool.admit reports exhaustion (the request stays
                  queued; counted as a stall step); paged engines only.
  drafter_fault   the speculative drafter raises at propose / draft
                  time: the step degrades to plain decode, and
                  ``spec_fault_tolerance`` faults in a row disable spec.
  scatter_corrupt an admission wave's first tokens are replaced by the
                  sentinel, detected at the wave's readback.
  prefill_exc     the prefill dispatch raises ``FaultInjected``: a crash
                  mid-admission with blocks already reserved.
  preempt_storm   the scheduler preempts its lowest-priority active
                  request whatever the deadlines; repeated firings keep
                  evicting it as it re-admits.
  replica_down    a fleet-level site, consulted by serve/fleet.py's Fleet
                  once a step (the busiest live replica is killed) and
                  by serve/disagg.py's DisaggPair inside a migration's
                  window (the decode engine is killed); no Engine
                  consults it.

With no plan attached every site check is one ``is None`` branch.
Stdlib only.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SITES = ("nan_logits", "slow_step", "alloc_fail", "drafter_fault",
         "scatter_corrupt", "prefill_exc", "preempt_storm",
         "replica_down")

# Named plans for CI smoke jobs and drills: steps are RELATIVE to the
# last (re)arm, so `plan.rearm(engine.steps)` after warmup aims the
# whole schedule at the measured window.
CANNED = {
    # One poisoned decode step, a burst of allocation failures, a
    # mid-admission prefill crash, and a repeated-preemption storm —
    # the three recovery classes (poison rebuild, backpressure-no-
    # rebuild, exception rebuild-with-flush) plus preemption-resume,
    # early enough that short --quick runs hit all of them.
    "chaos-smoke": ("nan_logits@6,alloc_fail@10x6,prefill_exc@18,"
                    "preempt_storm@22x3"),
    # Every class incl. a drafter failure streak and a second poison —
    # for manual drills against a spec-enabled engine.
    "chaos-full": ("nan_logits@6,drafter_fault@10x4,prefill_exc@20,"
                   "alloc_fail@28x8,preempt_storm@34x3,nan_logits@40"),
}


class FaultInjected(RuntimeError):
    """Raised at exception-type fault sites (``prefill_exc``,
    ``drafter_fault``) so tests and the supervisor can tell an injected
    crash from an organic one."""

    def __init__(self, site: str, step: int):
        super().__init__(f"injected fault: {site} at step {step}")
        self.site = site
        self.step = step


@dataclass
class FaultSpec:
    """One scheduled fault: fire at site visits once the engine step
    counter reaches ``step`` (relative to the plan's arm point), up to
    ``count`` times; or, with ``prob`` set, fire each visit with that
    probability (deterministic in the plan seed and visit index)."""
    site: str
    step: int = 0
    count: int = 1
    stall_s: float = 0.05          # slow_step only
    prob: Optional[float] = None
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if self.step < 0 or self.count < 1:
            raise ValueError(f"bad fault schedule {self.site}@"
                             f"{self.step}x{self.count}")
        if self.prob is not None and not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")


class FaultPlan:
    """A seeded, deterministic schedule of :class:`FaultSpec`\\ s.

    ``fire(site, step)`` is the engine-side hook: returns the spec that
    fires at this visit, or None.  Visits are counted per site, so
    count-based specs drain even when the engine step counter is not
    advancing (e.g. allocation stalls with no decode dispatch).
    ``rearm(step0)`` resets firing state and re-bases relative steps —
    benchmarks arm the plan at the start of the measured window so
    warmup and capacity probes run clean."""

    def __init__(self, faults: List[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self.enabled = True
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for f in faults:
            self._by_site.setdefault(f.site, []).append(f)
        self._step0 = 0
        self._visits: Dict[str, int] = {}
        self.fired_log: List[dict] = []

    # ------------------------------------------------------------ build
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from its compact flag syntax::

            site@STEP[xCOUNT][:PARAM]   fire at relative step >= STEP,
                                        COUNT times (default 1); PARAM
                                        is stall seconds for slow_step
            site@pPROB[:PARAM]          fire each visit with prob PROB
                                        (seeded, deterministic)

        entries comma-separated; a canned plan name (see ``CANNED``)
        expands first.  Examples: ``nan_logits@40``,
        ``slow_step@20:0.5``, ``alloc_fail@10x30``,
        ``drafter_fault@p0.05``, ``chaos-smoke``."""
        text = CANNED.get(text.strip(), text)
        specs: List[FaultSpec] = []
        for entry in text.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "@" not in entry:
                raise ValueError(
                    f"fault entry {entry!r}: expected site@step (or a "
                    f"canned plan: {', '.join(sorted(CANNED))})")
            site, sched = entry.split("@", 1)
            stall = 0.05
            if ":" in sched:
                sched, param = sched.split(":", 1)
                stall = float(param)
            prob: Optional[float] = None
            count = 1
            step = 0
            if sched.startswith("p"):
                prob = float(sched[1:])
                # "fire each visit with prob PROB" means EVERY visit
                # flips the coin — an uncapped count (count=1 would
                # silently stop after the first hit).
                count = 1 << 30
            else:
                if "x" in sched:
                    sched, n = sched.split("x", 1)
                    count = int(n)
                step = int(sched)
            specs.append(FaultSpec(site=site.strip(), step=step,
                                   count=count, stall_s=stall, prob=prob))
        if not specs:
            raise ValueError(f"empty fault plan: {text!r}")
        return cls(specs, seed=seed)

    # ---------------------------------------------------------- runtime
    def arm(self, step0: int) -> None:
        """Base relative steps at ``step0`` (idempotent; Engine calls
        this once at construction)."""
        self._step0 = int(step0)

    def rearm(self, step0: int) -> None:
        """Re-base AND reset all firing state — aim the schedule at a
        fresh window (bench points, post-warmup serving)."""
        self._step0 = int(step0)
        self._visits = {}
        self.fired_log = []
        for specs in self._by_site.values():
            for f in specs:
                f.fired = 0

    def fire(self, site: str, step: int) -> Optional[FaultSpec]:
        """The engine-side site check. Deterministic: a pure function
        of (plan state, step, per-site visit count)."""
        if not self.enabled:
            return None
        specs = self._by_site.get(site)
        if not specs:
            return None
        visit = self._visits.get(site, 0)
        self._visits[site] = visit + 1
        rel = step - self._step0
        for f in specs:
            if f.fired >= f.count:
                continue
            if f.prob is not None:
                # Seeded per-visit coin: same plan + same visit index
                # -> same outcome, run after run.
                coin = random.Random(f"{self.seed}:{site}:{visit}")
                if coin.random() >= f.prob:
                    continue
            elif rel < f.step:
                continue
            f.fired += 1
            self.fired_log.append({"site": site, "step": step,
                                   "visit": visit})
            return f
        return None

    # ------------------------------------------------------------ views
    def describe(self) -> List[dict]:
        return [{"site": f.site, "step": f.step, "count": f.count,
                 "prob": f.prob, "stall_s": f.stall_s}
                for specs in self._by_site.values() for f in specs]

    def stats(self) -> dict:
        return {"enabled": self.enabled, "seed": self.seed,
                "armed_at": self._step0,
                "specs": self.describe(),
                "fired": list(self.fired_log)}
