"""In-process N-replica serving fleet behind the prefix-affinity router.

This package's own copy of nanosandbox_tpu/serve/fleet.py. ``Fleet``
owns N independent Engines ("r0".."rN-1", each with its own metrics
registry and a replica-namespaced flight recorder) and one
PrefixAffinityRouter, behind an Engine-shaped submit()/step()/drain()
surface, so routing, drain and failover can be driven in one process.
The HTTP front tier (serve/http.py RouterFrontend) drives the same
router class over replica servers.

  * Routing: submit() fingerprints the prompt (paged.prefix_digests),
    routes by prefix affinity with load, brownout and readiness
    fallback, and forwards every scheduling field (deadline_s,
    slo_class, priority) untouched.

  * Identity: a fleet request's id is its first attempt's namespaced
    engine rid ("r0:17"). The engines' ledgers merge into one JSONL
    (merged_flight_jsonl); the fleet's own recorder adds ``route``,
    ``failover`` and ``replica_down`` events, never a terminal: one
    terminal a namespaced rid, across a failover too.

  * Failure: the ``replica_down`` fault site (serve/faults.py) kills a
    replica mid-traffic (Engine.abort_all: its requests come back as
    terminal 'failed' Results). The fleet salvages each victim's tokens
    and re-routes it to a surviving replica as prompt' = prompt + the
    tokens so far with the remaining budget: (seed, position) sampling
    keys make the outputs those of an undisturbed run, and every fleet
    request still reaches exactly one fleet Result.

  * Backoff: retry_after_s() is the minimum over ready replicas of each
    replica's (queue-mass-weighted) estimate, since a retrying client is
    routed to the best replica; retry_info() adds the ready set's size.

Host orchestration only: the replicas' programs are a solo engine's.
The replicas share the one model (its weights) on one device; a
tensor-parallel replica (``tp`` > 1) is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from nanosandbox_tpu_torch.obs import FlightRecorder, MetricRegistry
from nanosandbox_tpu_torch.serve.engine import (Engine, EngineFailedError,
                                                Result)
from nanosandbox_tpu_torch.serve.paged import prefix_digests
from nanosandbox_tpu_torch.serve.router import (NoReadyReplicaError,
                                                PrefixAffinityRouter)


@dataclass
class _FleetReq:
    """One client request's fleet-side journal across attempts."""
    fleet_rid: str               # first attempt's namespaced rid
    replica: str                 # current replica name
    engine_rid: int              # current engine-local rid
    prompt: tuple                # the ORIGINAL prompt
    max_new: int                 # the ORIGINAL budget
    kwargs: dict                 # sampling/SLO fields, re-sent on failover
    tokens: List[int] = field(default_factory=list)  # salvaged so far
    submit_t: float = 0.0
    deadline_s: Optional[float] = None
    attempts: int = 1


class Fleet:
    """N engine replicas + a prefix-affinity router, submit/step/drain.

    ``model`` is the GPT every replica serves; ``engine_kw`` (num_slots,
    max_len, paged, kv_page_size, kv_dtype, scan_k, prefill_chunk,
    device, ...) applies to every replica alike: interchangeable
    replicas are what make outputs replica-independent.

    n_replicas : engines to build ("r0".."rN-1").
    tp : per-replica tensor-parallel degree (Engine's ``tp``). JAX gives
        replica i its own devices [i*tp, (i+1)*tp); here every replica's
        shards live on its engine's device, so on one card every
        replica's shards share it.
    affinity : False = affinity-blind routing, seeded uniform-random over
        the ready set (the comparison baseline).
    faults : a FaultPlan consulted for the fleet-level ``replica_down``
        site once per step (engine-level plans go through engine_kw).
    failover : re-route a dead replica's in-flight requests (default);
        False turns a replica loss into client-visible 'failed'
        Results, the pre-router behavior.
    max_failovers : re-routes ONE request may consume (default 2).
        The cap is a poison-pill fence: if some request reliably kills
        whatever replica serves it (engine.submit rejects the known
        vector — out-of-vocab ids — but the class is open-ended),
        unbounded failover would walk it through the whole fleet,
        converting one bad request into a total outage. Past the cap
        the request surfaces as 'failed' and the fleet keeps serving.
    summary_interval : steps between authoritative router-index
        refreshes from each replica's prefix_summary() (staleness
        eviction); per-request digest reports flow continuously.
    metrics : registry for the ROUTER families + fleet counters
        (default: fresh). Replica engines always get their own (one
        engine a registry).
    """

    def __init__(self, model, *, n_replicas: int = 2,
                 tp: int = 1, affinity: bool = True, faults=None,
                 failover: bool = True, max_failovers: int = 2,
                 summary_interval: int = 8,
                 load_weight: float = 8.0, brownout_weight: float = 64.0,
                 index_cap: int = 8192, metrics: Optional[MetricRegistry]
                 = None, seed: int = 0, **engine_kw):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = int(n_replicas)
        self.failover = bool(failover)
        self.max_failovers = int(max_failovers)
        self.summary_interval = max(1, int(summary_interval))
        self.faults = faults
        if faults is not None:
            faults.arm(0)
        self.tp = int(tp)
        names = [f"r{i}" for i in range(self.n_replicas)]
        self.replicas: Dict[str, Engine] = {
            name: Engine(model, metrics=MetricRegistry(), tp=self.tp,
                         flight=FlightRecorder(namespace=name), **engine_kw)
            for name in names}
        eng0 = self.replicas[names[0]]
        self.paged = eng0.paged and eng0.block_pool.cache is not None
        self.page = eng0.kv_page_size if self.paged else 0
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.router = PrefixAffinityRouter(
            names, page=self.page or 16, index_cap=index_cap,
            load_weight=load_weight, brownout_weight=brownout_weight,
            affinity=affinity, metrics=self.metrics, seed=seed)
        self._c_failovers = self.metrics.counter(
            "serve_fleet_failovers_total",
            "In-flight requests re-routed off a failed replica.")
        self._c_downs = self.metrics.counter(
            "serve_fleet_replica_down_total",
            "Replicas hard-killed (the replica_down fault site).")
        # The fleet's OWN flight recorder: route/failover/replica_down
        # events over already-namespaced rids; terminals stay with the
        # engines (one per namespaced rid, even across failover).
        self.flight = FlightRecorder()
        self._requests: Dict[str, _FleetReq] = {}
        self._by_engine: Dict[Tuple[str, int], str] = {}
        self._draining: Dict[str, bool] = {n: False for n in names}
        self.steps = 0
        self.submitted = 0
        self.completed = 0
        self.failovers = 0
        self.replica_downs = 0
        self._refresh_health()

    # ------------------------------------------------------------ health
    def _replica_state(self, name: str) -> Tuple[bool, str]:
        eng = self.replicas[name]
        if eng.failed:
            return False, f"failed: {eng.quarantine_cause or 'unknown'}"
        if eng.quarantined:
            return False, f"quarantined: {eng.quarantine_cause}"
        if self._draining[name]:
            return False, "draining"
        return True, "ok"

    def _refresh_health(self) -> None:
        """One in-process health interval: every step() refreshes, so
        a drain/quarantine/failure leaves the rotation within one step
        — the 'one health interval' contract the HTTP tier honors with
        its poll period."""
        for name, eng in self.replicas.items():
            ready, reason = self._replica_state(name)
            level = eng.brownout.level if eng.brownout is not None else 0
            self.router.update_replica(
                name, ready=ready, reason=reason,
                queued=eng.sched.queued, active=len(eng._active),
                brownout=level)

    def drain_replica(self, name: str) -> None:
        """Take one replica out of rotation (the in-process twin of
        POST /drain): no new routes, in-flight work keeps stepping to
        completion. Idempotent."""
        self._draining[name] = True
        self._refresh_health()

    def undrain_replica(self, name: str) -> None:
        self._draining[name] = False
        self._refresh_health()

    # ------------------------------------------------------------ submit
    def _chain(self, prompt: Sequence[int]) -> List[str]:
        return (prefix_digests(prompt, self.page) if self.paged else [])

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               **kwargs) -> str:
        """Route + submit one request; returns its fleet id (the
        namespaced engine rid of the first attempt, "rN:M"). Raises
        NoReadyReplicaError when the whole fleet is out of rotation
        (503 upstream) and propagates the engine's admission
        ValueErrors (400)."""
        prompt = tuple(int(t) for t in prompt)
        self._refresh_health()
        chain = self._chain(prompt)
        dec = self.router.route(chain)
        eng = self.replicas[dec.replica]
        rid = eng.submit(prompt, max_new_tokens, **kwargs)
        # Optimistic index insert: the routed prompt's chain WILL be
        # resident at this replica once its prefill lands, so a
        # same-prefix follower in the same burst must route here too —
        # without this, affinity only forms after the first request
        # FINISHES, and a burst of shared-prefix traffic sprays across
        # the fleet by load. The index is approximate by contract; the
        # periodic summary refresh corrects any optimism a shed/failed
        # request left behind.
        if chain:
            self.router.observe_digests(dec.replica, chain)
        fleet_rid = f"{dec.replica}:{rid}"
        self.submitted += 1
        self.flight.record("route", rid=fleet_rid, replica=dec.replica,
                           reason=dec.reason,
                           est_hit_tokens=dec.est_hit_tokens,
                           candidates=dec.candidates)
        self._requests[fleet_rid] = _FleetReq(
            fleet_rid=fleet_rid, replica=dec.replica, engine_rid=rid,
            prompt=prompt, max_new=int(max_new_tokens),
            kwargs=dict(kwargs), submit_t=time.monotonic(),
            deadline_s=kwargs.get("deadline_s"))
        self._by_engine[(dec.replica, rid)] = fleet_rid
        return fleet_rid

    # -------------------------------------------------------------- step
    def has_work(self) -> bool:
        return any(eng.has_work() for eng in self.replicas.values())

    def step(self) -> List[Result]:
        """Step every replica once, collect finished engine Results,
        re-route failures, and return the FLEET-terminal Results
        (rid = fleet id, prompt = the original prompt, tokens stitched
        across attempts)."""
        out: List[Result] = []
        if self.faults is not None:
            f = self.faults.fire("replica_down", self.steps)
            if f is not None:
                self._kill_one(out)
        for name, eng in self.replicas.items():
            for res in eng.step():
                self._absorb(name, res, out)
        self.steps += 1
        self._refresh_health()
        if self.steps % self.summary_interval == 0:
            for name, eng in self.replicas.items():
                if not eng.failed:
                    self.router.refresh_summary(
                        name, eng.prefix_summary()["digests"])
            # The summary is the DONATED set; chains still in flight
            # (queued or decoding — their blocks are private until
            # release) are nonetheless committed to this replica, so
            # the optimistic submit-time entries are restored on top of
            # the authoritative base.
            for fr in self._requests.values():
                if not self.replicas[fr.replica].failed:
                    self.router.observe_digests(
                        fr.replica, self._chain(fr.prompt))
        return out

    def drain(self) -> List[Result]:
        out: List[Result] = []
        while self.has_work():
            out.extend(self.step())
        return out

    def _kill_one(self, out: List[Result]) -> None:
        """The replica_down site: hard-kill the busiest live replica
        (deterministic — max active requests, name as tie-break) via
        abort_all, then absorb its terminal 'failed' Results so the
        failover path re-routes them THIS step."""
        live = [(len(self.replicas[n]._active), n)
                for n in self.replicas
                if not self.replicas[n].failed]
        if not live:
            return
        _, victim = max(live, key=lambda t: (t[0], t[1]))
        self.replica_downs += 1
        self._c_downs.inc()
        self.flight.record("replica_down", replica=victim,
                           step=self.steps)
        eng = self.replicas[victim]
        results = eng.abort_all("replica_down")
        self.router.update_replica(victim, ready=False,
                                   reason="failed: replica_down")
        self.router.forget(victim)
        for res in results:
            self._absorb(victim, res, out)

    def _absorb(self, name: str, res: Result, out: List[Result]) -> None:
        """Map one engine Result back to its fleet request: terminal,
        or a failover re-route when the replica died under it."""
        fleet_rid = self._by_engine.pop((name, res.rid), None)
        if fleet_rid is None:
            return                       # warmup traffic / direct submits
        fr = self._requests[fleet_rid]
        if (res.finish_reason == "failed" and self.failover
                and self._try_failover(fr, res, out)):
            return
        del self._requests[fleet_rid]
        self.completed += 1
        out.append(Result(
            rid=fleet_rid, prompt=fr.prompt,
            tokens=fr.tokens + list(res.tokens),
            finish_reason=res.finish_reason,
            prefix_digest=res.prefix_digest))
        if res.prefix_digest:
            self.router.observe_digests(name, list(res.prefix_digest))

    def _try_failover(self, fr: _FleetReq, res: Result,
                      out: List[Result]) -> bool:
        """Re-route one dead replica's victim: salvage its tokens,
        resubmit prompt' = prompt + tokens-so-far with the remaining
        budget on a surviving replica ((seed, position) sampling keys
        make the resumed stream token-identical: the recovery restitch
        argument, one replica over). May resolve the
        request to a terminal itself (deadline expired mid-failover,
        budget already met) — those land in ``out`` directly. False =
        no failover possible (caller emits the 'failed' terminal)."""
        salvaged = fr.tokens + list(res.tokens)
        remaining = fr.max_new - len(salvaged)
        now = time.monotonic()
        if fr.attempts > self.max_failovers:
            # Poison-pill fence (constructor docstring): this request
            # has already consumed its re-routes — surface the failure
            # instead of walking it through the rest of the fleet.
            return False
        if fr.deadline_s is not None and now - fr.submit_t >= fr.deadline_s:
            # The client stopped waiting mid-failover: terminal 'shed'
            # at the FLEET level (429 upstream), no engine resubmit.
            # The dead replica's 'failed' is the rid's one terminal;
            # this event is fleet bookkeeping, not a second one.
            self.flight.record("failover_shed", rid=fr.fleet_rid,
                               step=self.steps, tokens=len(salvaged))
            del self._requests[fr.fleet_rid]
            self.completed += 1
            out.append(Result(
                rid=fr.fleet_rid, prompt=fr.prompt, tokens=salvaged,
                finish_reason="shed"))
            return True
        if remaining <= 0:
            # Budget already met by salvage: nothing to resubmit — the
            # request is DONE, just unlucky about where its last token
            # was computed.
            del self._requests[fr.fleet_rid]
            self.completed += 1
            out.append(Result(
                rid=fr.fleet_rid, prompt=fr.prompt, tokens=salvaged,
                finish_reason="length"))
            return True
        self._refresh_health()
        try:
            dec = self.router.route(
                self._chain(fr.prompt + tuple(salvaged)),
                exclude=(fr.replica,), failover=True)
        except NoReadyReplicaError:
            return False
        kwargs = dict(fr.kwargs)
        if fr.deadline_s is not None:
            kwargs["deadline_s"] = max(fr.deadline_s
                                       - (now - fr.submit_t), 0.001)
        eng = self.replicas[dec.replica]
        try:
            rid = eng.submit(fr.prompt + tuple(salvaged), remaining,
                             **kwargs)
        except (ValueError, EngineFailedError):
            return False
        self.failovers += 1
        self._c_failovers.inc()
        self.flight.record(
            "failover", rid=fr.fleet_rid, step=self.steps,
            dead=fr.replica, replica=dec.replica,
            new_rid=f"{dec.replica}:{rid}", tokens=len(salvaged),
            reason=dec.reason, est_hit_tokens=dec.est_hit_tokens)
        fr.tokens = salvaged
        fr.replica = dec.replica
        fr.engine_rid = rid
        fr.attempts += 1
        self._by_engine[(dec.replica, rid)] = fr.fleet_rid
        return True

    # ------------------------------------------------------------- views
    def retry_after_s(self, slo_class: Optional[str] = None) -> float:
        """Fleet backoff hint: the MIN over ready replicas of the
        per-replica queue-mass-weighted estimate (each replica already
        scales its own hint by the backlog at-or-above the class) —
        the retrying client gets routed to the best replica, so the
        minimum is the binding number, not whichever replica shed."""
        ready = self.router.ready_replicas()
        if not ready:
            return 1.0
        return min(self.replicas[n].retry_after_s(slo_class=slo_class)
                   for n in ready)

    def retry_info(self, slo_class: Optional[str] = None) -> dict:
        """The 429/503 body fields: the aggregate hint plus the size of
        the ready replica set it was computed over."""
        ready = self.router.ready_replicas()
        return {"retry_after_s": self.retry_after_s(slo_class),
                "replica_set": len(ready)}

    def stats(self) -> dict:
        return {
            "n_replicas": self.n_replicas,
            "router": self.router.stats(),
            "steps": self.steps,
            "submitted": self.submitted,
            "completed": self.completed,
            "in_flight": len(self._requests),
            "failovers": self.failovers,
            "replica_downs": self.replica_downs,
            "retry": self.retry_info(),
            "replicas": {
                name: {
                    "ready": self._replica_state(name)[0],
                    "reason": self._replica_state(name)[1],
                    "active": len(eng._active),
                    "queued": eng.sched.queued,
                    "completed": eng.completed,
                    "tokens_generated": eng.tokens_generated,
                    "prefix_hit_tokens": (
                        eng.block_pool.hit_tokens
                        if eng.block_pool is not None else 0),
                    "prefix_miss_tokens": (
                        eng.block_pool.miss_tokens
                        if eng.block_pool is not None else 0),
                } for name, eng in self.replicas.items()
            },
        }

    def merged_flight_events(self) -> List[dict]:
        """Every replica's ledger plus the fleet's own, one stream
        ordered by wall clock — rids are replica-namespaced, so the
        merge stays exactly-once analyzable."""
        events: List[dict] = []
        for eng in self.replicas.values():
            events.extend(eng.flight.events())
        events.extend(self.flight.events())
        events.sort(key=lambda e: e["wall"])
        return events

    def merged_flight_jsonl(self) -> str:
        import json

        lines = [json.dumps(e, sort_keys=True)
                 for e in self.merged_flight_events()]
        return "\n".join(lines) + ("\n" if lines else "")

    def reset_latency_stats(self) -> None:
        """Engine.reset_latency_stats on every replica, and the fleet's
        flight ring cleared."""
        for eng in self.replicas.values():
            eng.reset_latency_stats()
        self.flight.clear()

    def reset_prefix_caches(self) -> None:
        """Cold-cache baseline: flush every replica's radix cache AND
        the router's picture of them (idle replicas only, the engine
        contract)."""
        for name, eng in self.replicas.items():
            eng.reset_prefix_cache()
            self.router.forget(name)
