"""Prefix-affinity request routing over N engine replicas.

This package's own copy of nanosandbox_tpu/serve/router.py (stdlib only,
the same scores, reasons and phase dimension). The radix prefix cache
makes a hit's TTFT a fraction of a miss's, but the cache is per engine:
two requests sharing a system prompt sent to two replicas pay the
prefill twice and cache the prefix twice. The router closes that gap
from above the engines:

  * Every replica fingerprints its resident prefix chains
    (``paged.prefix_digests``' chained per-block hashes), reported on
    each Result, flight ``finish`` event and HTTP ``/generate`` body
    (``prefix_digest``) and summarised by ``/debug/prefix_summary``.

  * The router keeps an APPROXIMATE per-replica index of those digests
    (a bounded LRU membership set, _PrefixIndex), fed by per-request
    reports and replaced wholesale by the periodic authoritative summary
    (its staleness eviction).

  * ``route()`` scores the READY replicas by
        est_prefix_hit_tokens
          - load_weight   * (queued + active)
          - brownout_weight * brownout_level
    and picks the max: affinity wins while a warm replica's queue is not
    disproportionately deep, else the choice degrades to least-loaded
    (reason ``load``). A draining, quarantined or failed replica is not
    a candidate; a re-route around a failure (``failover=True``) or an
    exclusion that changed the choice is tagged ``fallback``.

Host bookkeeping only: no torch import, no device state, nothing on an
engine's hot loop. The in-process harness (serve/fleet.py) and the
asyncio HTTP front tier (serve/http.py RouterFrontend) drive this one
class.

Thread safety: the HTTP front tier calls one router from three contexts
at once (route() and stats() on the asyncio loop thread, update_replica
and refresh_summary from health-poll executor threads, add_replica and
remove_replica from discovery), and ``self.replicas`` is a plain dict,
so every public method serialises on ``self._lock`` (an RLock:
update_replica re-enters through add_replica). Nothing under the lock
blocks.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

# Decision reasons (the serve_router_decisions_total{reason=} label
# set): ``affinity`` — a prefix-warm replica won; ``load`` — no usable
# affinity signal, least-loaded pick; ``fallback`` — the preferred
# choice was unavailable (failover re-route, exclusion, or the best
# affinity candidate was not ready) and traffic was redirected.
REASONS = ("affinity", "load", "fallback")


class NoReadyReplicaError(RuntimeError):
    """Every replica is excluded, draining, quarantined, or failed —
    the fleet cannot take this request (503 upstream)."""


@dataclass
class RouteDecision:
    replica: str
    reason: str                  # one of REASONS
    est_hit_tokens: int          # prefix tokens the chosen replica skips
    candidates: int              # ready replicas considered


class _PrefixIndex:
    """Bounded LRU membership set of prefix-chain digests — the
    router's approximate picture of ONE replica's radix cache.

    Membership is all matching needs: a request's own digest chain
    (prefix_digests) is walked in order and the hit depth is the last
    contiguous member — the same longest-prefix semantics the replica's
    trie applies, without the router holding a single token id. The cap
    bounds router memory per replica; the authoritative summary refresh
    (replace()) clears any stale survivors the cap kept too long."""

    def __init__(self, cap: int = 8192):
        if cap < 1:
            raise ValueError(f"index cap must be >= 1, got {cap}")
        self.cap = cap
        self._set: "OrderedDict[str, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._set)

    def add_chain(self, digests: Iterable[str]) -> None:
        for d in digests:
            if d in self._set:
                self._set.move_to_end(d)
            else:
                self._set[d] = None
                while len(self._set) > self.cap:
                    self._set.popitem(last=False)

    def replace(self, digests: Iterable[str]) -> None:
        """Authoritative refresh from /debug/prefix_summary: the
        replica's trie IS this set now (capped), nothing else."""
        fresh: "OrderedDict[str, None]" = OrderedDict()
        for d in digests:
            fresh[d] = None
            if len(fresh) > self.cap:
                fresh.popitem(last=False)
        self._set = fresh

    def clear(self) -> None:
        self._set = OrderedDict()

    def match_blocks(self, chain: Sequence[str]) -> int:
        """Contiguous leading blocks of ``chain`` present here — the
        estimated radix hit depth (digests chain parent-to-child, so a
        missing link means everything deeper is unreachable too)."""
        hit = 0
        for d in chain:
            if d not in self._set:
                break
            self._set.move_to_end(d)
            hit += 1
        return hit


@dataclass
class ReplicaView:
    """The router's picture of one replica — health + load refreshed
    every interval, the prefix index fed by result reports and summary
    refreshes."""
    name: str
    ready: bool = False
    reason: str = "unknown"
    queued: int = 0
    active: int = 0
    brownout: int = 0
    retry_after_s: Optional[float] = None
    last_update_t: float = 0.0
    index: _PrefixIndex = field(default_factory=_PrefixIndex)
    # Serving tier: "both" (colocated, the default),
    # "prefill", or "decode". route(phase=...) only considers replicas
    # whose role covers the request's phase — the phase dimension that
    # turns the router into a two-tier dispatcher. Sticky: set at
    # add_replica (the k8s tier annotation) and only changed by an
    # explicit update.
    role: str = "both"

    @property
    def load(self) -> int:
        return self.queued + self.active


class PrefixAffinityRouter:
    """Score-and-pick routing over named replicas (module docstring has
    the policy). ``affinity=False`` routes SEEDED-UNIFORM-RANDOM over
    the ready set: the honest affinity-blind baseline the bench twin is
    measured against. (Not least-loaded-with-rotation: that is
    quasi-deterministic, and on a grouped arrival pattern its rotation
    can alias into accidental affinity — or anti-affinity — flipping
    the comparison with the workload's phase instead of its policy.)

    ``metrics`` (an obs.MetricRegistry) hosts the router families:
    serve_router_decisions_total{reason=}, the
    serve_router_prefix_hit_est_tokens histogram, and per-replica
    serve_router_replica_ready / serve_router_replica_load gauges.
    All recording happens at route/update time on host ints — there is
    no hot loop here to stay off."""

    def __init__(self, replicas: Iterable[str], *, page: int = 16,
                 index_cap: int = 8192, load_weight: float = 8.0,
                 brownout_weight: float = 64.0, affinity: bool = True,
                 metrics=None, seed: int = 0,
                 roles: Optional[Dict[str, str]] = None):
        import random as _random

        self._lock = threading.RLock()
        self.page = int(page)
        self._rng = _random.Random(seed)
        self.load_weight = float(load_weight)
        self.brownout_weight = float(brownout_weight)
        self.affinity = bool(affinity)
        self.index_cap = int(index_cap)
        self.replicas: Dict[str, ReplicaView] = {}  # guarded-by: _lock
        roles = roles or {}
        for name in replicas:
            self.add_replica(name, role=roles.get(name, "both"))
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        self.decisions: Dict[str, int] = {r: 0 for r in REASONS}  # guarded-by: _lock
        self._rr = int(seed)         # rotates load-tie picks
        self._m_decisions = None
        self._m_hit_est = None
        self._m_ready = None
        self._m_load = None
        if metrics is not None:
            self._m_decisions = metrics.counter(
                "serve_router_decisions_total",
                "Routing decisions by reason "
                "(affinity | load | fallback).", labelnames=("reason",))
            self._m_hit_est = metrics.histogram(
                "serve_router_prefix_hit_est_tokens",
                "Estimated prefix-hit tokens at the chosen replica.",
                unit="tokens",
                buckets=(0, 16, 32, 64, 128, 256, 512, 1024))
            self._m_ready = metrics.gauge(
                "serve_router_replica_ready",
                "1 while the replica is in rotation, else 0.",
                labelnames=("replica",))
            self._m_load = metrics.gauge(
                "serve_router_replica_load",
                "Queued + active requests at the replica, as of its "
                "last health refresh.", labelnames=("replica",))

    # ------------------------------------------------------------ updates
    def add_replica(self, name: str, *, role: str = "both") -> None:
        """Register a replica (headless-Service discovery may grow the
        set at runtime); idempotent. ``role`` is the tier annotation
        ("both" | "prefill" | "decode") — see ReplicaView.role."""
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill' or "
                             f"'decode', got {role!r}")
        with self._lock:
            if name not in self.replicas:
                self.replicas[name] = ReplicaView(
                    name=name, role=role,
                    index=_PrefixIndex(self.index_cap))

    def remove_replica(self, name: str) -> None:
        """Deregister (scale-down, DNS churn). The label children a
        registry already minted persist in the exposition, so zero the
        gauges on the way out — a pod that left must not keep
        exporting ready=1 to the dashboards forever."""
        with self._lock:
            if name in self.replicas and self._m_ready is not None:
                self._m_ready.labels(replica=name).set(0.0)
                self._m_load.labels(replica=name).set(0.0)
            self.replicas.pop(name, None)

    def update_replica(self, name: str, *, ready: bool,
                       reason: str = "", queued: int = 0, active: int = 0,
                       brownout: int = 0,
                       retry_after_s: Optional[float] = None,
                       role: Optional[str] = None) -> None:
        """One health-interval refresh: readiness (drain / quarantine /
        failure take the replica out of rotation HERE, which is why the
        rotation reacts within one interval), queue depth, brownout
        level, and the replica's own retry estimate. ``role`` is sticky
        (None leaves the tier annotation untouched)."""
        with self._lock:
            self.add_replica(name)
            r = self.replicas[name]
            if role is not None:
                if role not in ("both", "prefill", "decode"):
                    raise ValueError(f"role must be 'both', 'prefill' or "
                                     f"'decode', got {role!r}")
                r.role = role
            r.ready = bool(ready)
            r.reason = reason
            r.queued = int(queued)
            r.active = int(active)
            r.brownout = int(brownout)
            r.retry_after_s = retry_after_s
            r.last_update_t = time.monotonic()
            if self._m_ready is not None:
                self._m_ready.labels(replica=name).set(
                    1.0 if r.ready else 0.0)
                self._m_load.labels(replica=name).set(float(r.load))

    def observe_digests(self, name: str, digests: Sequence[str]) -> None:
        """Opportunistic index update from one finished request's
        prefix_digest report: replica ``name`` now caches this chain."""
        with self._lock:
            if digests and name in self.replicas:
                self.replicas[name].index.add_chain(digests)

    def refresh_summary(self, name: str, digests: Sequence[str]) -> None:
        """Authoritative replacement from the replica's
        /debug/prefix_summary — the staleness/eviction path: digests
        the replica LRU-evicted since the last refresh disappear from
        the router's index with it."""
        with self._lock:
            if name in self.replicas:
                self.replicas[name].index.replace(digests)

    def forget(self, name: str) -> None:
        """Drop a replica's index (it died, recovered with a flushed
        cache, or reset) without deregistering it."""
        with self._lock:
            if name in self.replicas:
                self.replicas[name].index.clear()

    # ------------------------------------------------------------ routing
    def match_tokens(self, name: str, chain: Sequence[str]) -> int:
        with self._lock:
            r = self.replicas.get(name)
            if r is None:
                return 0
            return r.index.match_blocks(chain) * self.page

    def route(self, chain: Sequence[str] = (), *,
              exclude: Iterable[str] = (),
              failover: bool = False,
              phase: Optional[str] = None) -> RouteDecision:
        """Pick a replica for a request whose prompt's digest chain is
        ``chain`` (empty = no affinity signal: dense engines, text-only
        HTTP requests). ``exclude`` removes replicas the caller already
        tried this request; ``failover=True`` marks the decision as a
        re-route (reason ``fallback``) regardless of what wins.
        ``phase`` restricts candidates to the matching tier:
        "prefill" routes an arriving request into the prefill tier,
        "decode" picks the adoption target for a parked export —
        colocated ("both") replicas serve either phase, so a mixed
        fleet degrades gracefully to single-tier routing. Raises
        NoReadyReplicaError when no candidate remains."""
        if phase is not None and phase not in ("prefill", "decode"):
            raise ValueError(f"phase must be 'prefill' or 'decode', "
                             f"got {phase!r}")
        excluded = set(exclude)
        with self._lock:
            ready = [r for r in self.replicas.values()
                     if r.ready and r.name not in excluded
                     and (phase is None or r.role in ("both", phase))]
            if not ready:
                raise NoReadyReplicaError(
                    ("no ready replica" if phase is None
                     else f"no ready {phase}-tier replica") + " (of "
                    f"{len(self.replicas)}: "
                    + ", ".join(f"{r.name}[{r.role}]="
                                f"{r.reason or 'excluded'}"
                                for r in self.replicas.values()) + ")")
            ready.sort(key=lambda r: r.name)
            if not self.affinity:
                # The affinity-blind baseline: seeded uniform-random
                # over the ready set (class docstring explains why not
                # least-loaded-with-rotation).
                best = self._rng.choice(ready)
                reason = "fallback" if (failover or excluded) else "load"
                self.decisions[reason] += 1
                if self._m_decisions is not None:
                    self._m_decisions.labels(reason=reason).inc()
                    self._m_hit_est.observe(0)
                return RouteDecision(replica=best.name, reason=reason,
                                     est_hit_tokens=0,
                                     candidates=len(ready))
            # Stable candidate rotation: ties (fresh fleet, equal load)
            # spread round-robin instead of piling the whole warmup on
            # one replica; the rotation point advances per decision.
            self._rr += 1
            ready = (ready[self._rr % len(ready):]
                     + ready[:self._rr % len(ready)])
            hits = {r.name: (r.index.match_blocks(chain) * self.page
                             if chain else 0)
                    for r in ready}

            def score(r: ReplicaView) -> float:
                return (hits[r.name] - self.load_weight * r.load
                        - self.brownout_weight * r.brownout)

            best = max(ready, key=score)
            est = hits[best.name]
            if failover or excluded:
                reason = "fallback"
            elif est > 0:
                reason = "affinity"
            else:
                # No affinity among the READY set — if a non-ready/
                # excluded replica held the prefix, this is traffic
                # redirected off its warm home, which an operator reads
                # differently from plain cold load-balancing.
                warm_elsewhere = any(
                    self.affinity and chain
                    and r.index.match_blocks(chain) > 0
                    for r in self.replicas.values()
                    if not r.ready or r.name in excluded)
                reason = "fallback" if warm_elsewhere else "load"
            self.decisions[reason] += 1
            if self._m_decisions is not None:
                self._m_decisions.labels(reason=reason).inc()
                self._m_hit_est.observe(est)
            return RouteDecision(replica=best.name, reason=reason,
                                 est_hit_tokens=est,
                                 candidates=len(ready))

    # ------------------------------------------------------------- views
    def ready_replicas(self) -> List[str]:
        with self._lock:
            return sorted(r.name for r in self.replicas.values()
                          if r.ready)

    def stats(self) -> dict:
        with self._lock:
            return {
                "affinity": self.affinity,
                "page": self.page,
                "index_cap": self.index_cap,
                "load_weight": self.load_weight,
                "brownout_weight": self.brownout_weight,
                "decisions": dict(self.decisions),
                "replicas": {
                    r.name: {
                        "ready": r.ready,
                        "role": r.role,
                        "reason": r.reason,
                        "queued": r.queued,
                        "active": r.active,
                        "brownout": r.brownout,
                        "retry_after_s": r.retry_after_s,
                        "index_digests": len(r.index),
                        "age_s": (round(
                            time.monotonic() - r.last_update_t, 6)
                            if r.last_update_t else None),
                    } for r in self.replicas.values()
                },
            }
