"""Disaggregated prefill/decode serving: paged KV block chains as the
migration wire format.

This package's own copy of nanosandbox_tpu/serve/disagg.py. Chunked
prefill paces the prefill storm inside one engine; disaggregation
removes it. ``DisaggPair`` splits serving into a prefill tier and a
decode tier with the paged block chain as the handoff:

  1. the prefill engine (``role="prefill"``) runs admission waves at
     full tilt (no decode traffic to protect, so no chunking);
  2. at the first-token readback a request EXPORTS instead of going
     active: its prompt's K/V sits in its block chain, its first token
     was sampled with the (seed, true_len) key, and the record parks in
     migration limbo (engine._Export);
  3. the pump moves the chain: ``BlockPool.adopt_chain`` reserves the
     destination's footprint, ``read_pool_blocks`` /
     ``write_pool_blocks`` copy the blocks the destination's radix cache
     lacks (device to device, in place), and ``commit_adopt`` writes the
     row's slot state: no prefill runs on the decode tier, ever.

Decode continues at pos = true_len with (seed, pos + 1) keys, the stream
a colocated engine would have produced, so tokens, greedy and sampled,
equal the colocated engine's.

Exactly once across the handoff: a migrating request is owned by one
record at a time, the export until ``complete_export``, the active row
after ``commit_adopt``. Every failure in between unwinds to the export
and resolves through one of ``complete_export`` (outcome ``ok``),
``requeue_export`` (the decode tier is dead or refused the payload: the
request re-enters the prefill engine colocated, a prefix hit resampling
the same first token; ``fallback``), the limbo shed (deadline expired
while parked, blocks freed without donation; ``shed``), or the source's
own failure (abort_all drains limbo as ``failed``).

The ``replica_down`` fault site (serve/faults.py), consulted inside the
migration window (destination blocks reserved, nothing committed),
kills the decode engine mid-handoff: the adoption unwinds
(``abort_adopt``), the export falls back, and the dead tier's requests
restitch onto the prefill engine colocated (prompt' = prompt + the
tokens so far).

``export_to_wire`` / ``adopt_from_wire`` are the HTTP twins of the
in-process transfer: one JSON payload with the request, the first token
and the prompt chain's blocks, one base64 entry a pool leaf in the JAX
package's order and with its dtype names (int8/int4 as codes and
scales, never dequantized; bf16 encoded through torch, as numpy has no
bfloat16), so a payload one package writes, the other adopts.
"""

from __future__ import annotations

import base64
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nanosandbox_tpu_torch.obs import FlightRecorder, MetricRegistry
from nanosandbox_tpu_torch.serve.engine import (DEFAULT_PRIORITY, Engine,
                                                EngineFailedError, Request,
                                                Result)
from nanosandbox_tpu_torch.serve.paged import blocks_for
from nanosandbox_tpu_torch.utils import tracecheck as _tracecheck

PREFILL, DECODE = "prefill", "decode"


@dataclass
class _PairReq:
    """One client request's pair-side journal across tiers/attempts."""
    pair_rid: str                # "prefill:N" — first attempt's rid
    tier: str                    # tier currently owning the request
    engine_rid: int              # rid on that tier's engine
    prompt: tuple
    max_new: int
    kwargs: dict                 # sampling/SLO fields, re-sent on failover
    tokens: List[int] = field(default_factory=list)  # salvaged so far
    submit_t: float = 0.0
    deadline_s: Optional[float] = None
    attempts: int = 1


class DisaggPair:
    """A prefill engine and a decode engine in one process, the migration
    pump between them, and an Engine-shaped submit()/step()/drain()
    surface: the in-process form of the two-tier deployment. The HTTP
    tier (RouterFrontend and the wire helpers below) drives the same
    engine calls across processes.

    ``model`` is the GPT both engines serve (one set of weights).
    ``engine_kw`` (num_slots, max_len, kv_page_size, kv_dtype, scan_k,
    device, ...) applies to both engines alike: the same pool geometry
    is what makes a migrated chain fit the destination pool.

    prefill_chunk : chunked prefill on the PREFILL tier only (decode
        never prefills). Default off — a dedicated prefill tier has no
        decode traffic to protect, which is the point.
    faults : a FaultPlan consulted for ``replica_down`` once per
        migration, INSIDE the handoff window (destination blocks
        reserved, nothing committed) — the hardest exactly-once case.
        Engine-level plans go through ``engine_kw``.
    fallback : re-admit work colocated on the prefill engine when the
        decode tier dies (default). False surfaces tier loss as
        'failed' Results.
    metrics : registry for the PAIR families (migrations, migration
        latency, limbo depth). Each engine always gets its own registry
        (one engine a registry); per-tier role gauges live there as
        ``serve_engine_role{role=}``.
    prefill_tp : the PREFILL tier's tensor-parallel degree (default:
        engine_kw's ``tp``, the decode tier's). The payload is tp 1's
        layout whatever either tier's degree (Engine.read_pool_blocks).
    """

    def __init__(self, model, *,
                 prefill_chunk: Optional[int] = None,
                 prefill_tp: Optional[int] = None,
                 faults=None, fallback: bool = True,
                 metrics: Optional[MetricRegistry] = None,
                 **engine_kw):
        if not engine_kw.get("paged", True):
            raise ValueError("disaggregation needs paged=True: the "
                             "block chain is the migration wire format")
        for k in ("role", "metrics", "flight"):
            if k in engine_kw:
                raise ValueError(f"{k!r} is owned by DisaggPair; pass "
                                 f"pair-level options instead")
        self.fallback = bool(fallback)
        self.faults = faults
        if faults is not None:
            faults.arm(0)
        prefill_kw = dict(engine_kw)
        if prefill_tp is not None:
            prefill_kw["tp"] = prefill_tp
        self.prefill = Engine(
            model, role=PREFILL, metrics=MetricRegistry(),
            flight=FlightRecorder(namespace=PREFILL),
            prefill_chunk=prefill_chunk, **prefill_kw)
        self.decode = Engine(
            model, role=DECODE, metrics=MetricRegistry(),
            flight=FlightRecorder(namespace=DECODE), **engine_kw)
        self.engines: Dict[str, Engine] = {PREFILL: self.prefill,
                                           DECODE: self.decode}
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._c_migrations = self.metrics.counter(
            "serve_migrations_total",
            "Prefill->decode handoffs by outcome (ok | fallback | "
            "shed | failed).", labelnames=("outcome",))
        self._h_migration = self.metrics.histogram(
            "serve_migration_seconds",
            "Export-parked -> adoption-committed seconds (limbo wait "
            "+ block transfer + admit scatter).")
        self._g_limbo = self.metrics.gauge(
            "serve_migration_limbo_depth",
            "Exports parked on the prefill tier awaiting adoption.")
        # The pair's OWN recorder: migrate_fallback / replica_down /
        # failover events over pair rids; terminals stay with the
        # engines (one per namespaced rid, even across the handoff).
        self.flight = FlightRecorder()
        self._requests: Dict[str, _PairReq] = {}
        self._by_engine: Dict[Tuple[str, int], str] = {}
        self.steps = 0
        self.submitted = 0
        self.completed = 0
        self.migrations = 0
        self.fallbacks = 0
        self.replica_downs = 0

    # ------------------------------------------------------------ submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               **kwargs) -> str:
        """Submit one request to the PREFILL tier with migrate intent;
        returns its pair id ("prefill:N"). Propagates the engine's
        admission ValueErrors (400) and EngineFailedError (503)."""
        prompt = tuple(int(t) for t in prompt)
        kwargs.pop("migrate", None)      # the pair owns migrate intent
        rid = self.prefill.submit(prompt, max_new_tokens,
                                  migrate=True, **kwargs)
        pair_rid = f"{PREFILL}:{rid}"
        self.submitted += 1
        self._requests[pair_rid] = _PairReq(
            pair_rid=pair_rid, tier=PREFILL, engine_rid=rid,
            prompt=prompt, max_new=int(max_new_tokens),
            kwargs=dict(kwargs), submit_t=time.monotonic(),
            deadline_s=kwargs.get("deadline_s"))
        self._by_engine[(PREFILL, rid)] = pair_rid
        return pair_rid

    # -------------------------------------------------------------- step
    def has_work(self) -> bool:
        return any(eng.has_work() for eng in self.engines.values())

    def step(self) -> List[Result]:
        """One pair step: prefill tier steps (admissions export into
        limbo), the pump migrates every parked export it can place,
        the decode tier steps. Returns PAIR-terminal Results (rid =
        pair id, prompt = the original prompt, tokens stitched across
        tiers)."""
        out: List[Result] = []
        # Limbo membership BEFORE the step classifies this step's
        # terminals: a 'shed'/'failed' whose rid was parked is a
        # migration that never landed (outcome shed/failed), not an
        # admission-queue casualty.
        limbo_rids = {exp.rid for exp in self.prefill.sched.limbo_items()}
        for res in self.prefill.step():
            self._absorb(PREFILL, res, out, limbo_rids=limbo_rids)
        self._pump(out)
        for res in self.decode.step():
            self._absorb(DECODE, res, out)
        self.steps += 1
        self._g_limbo.set(self.prefill.sched.limbo)
        return out

    def drain(self) -> List[Result]:
        out: List[Result] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # -------------------------------------------------------------- pump
    def _pump(self, out: List[Result]) -> None:
        """Move every parked export the decode tier can adopt RIGHT
        NOW; repark on adoption backpressure (no slot / no blocks) —
        the decode tier's own finishes free capacity next step."""
        while True:
            exp = self.prefill.pop_export()
            if exp is None:
                return
            if self.decode.failed:
                self._fall_back(exp, out, cause="decode_tier_down")
                continue
            ad = self.decode.begin_adopt(exp.req)
            if ad is None:
                self.prefill.repark_export(exp)
                return
            # The mid-migration kill window: the destination's slot and
            # blocks are reserved, nothing is committed, the export
            # still owns the request. A kill here must unwind to
            # exactly one terminal.
            if (self.faults is not None
                    and self.faults.fire("replica_down", self.steps)):
                self.decode.abort_adopt(ad)
                self._kill_decode(out)
                self._fall_back(exp, out, cause="replica_down")
                continue
            src_ids = [exp.alloc.table[i] for i in ad.copy]
            payload = self.prefill.read_pool_blocks(src_ids)
            nbytes = self.decode.write_pool_blocks(ad.dst_blocks, payload)
            try:
                new_rid, done = self.decode.commit_adopt(
                    ad, exp.first_tok, submit_t=exp.submit_t,
                    src=PREFILL)
            except ValueError:
                # Corrupt first token: unwind the half-adoption and
                # fall back — the source resamples the same token from
                # its own clean chain.
                self.decode.abort_adopt(ad)
                self._fall_back(exp, out, cause="bad_first_token")
                continue
            mig_s = time.monotonic() - exp.export_t
            self.prefill.complete_export(
                exp, dst=DECODE, blocks_copied=len(ad.copy),
                bytes_moved=nbytes, migrate_s=mig_s)
            self._h_migration.observe(mig_s)
            self._c_migrations.labels(outcome="ok").inc()
            self.migrations += 1
            pair_rid = self._by_engine.pop((PREFILL, exp.req.rid), None)
            if pair_rid is not None:
                fr = self._requests[pair_rid]
                fr.tier, fr.engine_rid = DECODE, new_rid
                self._by_engine[(DECODE, new_rid)] = pair_rid
            if done is not None:
                self._absorb(DECODE, done, out)

    def _fall_back(self, exp, out: List[Result], *, cause: str) -> None:
        """Resolve one unplaceable export: requeue colocated on the
        prefill engine (the re-prefill is a prefix hit resampling the
        same first token: the tokens of the migration that never
        happened), or surface 'failed' when falling back is impossible
        or disabled."""
        if self.fallback and not self.prefill.failed:
            self.prefill.requeue_export(exp)
            self._c_migrations.labels(outcome="fallback").inc()
            self.fallbacks += 1
            self.flight.record("migrate_fallback",
                               rid=f"{PREFILL}:{exp.req.rid}",
                               step=self.steps, cause=cause)
            return
        self.prefill.block_pool.release(exp.alloc, donate=False)
        self._c_migrations.labels(outcome="failed").inc()
        pair_rid = self._by_engine.pop((PREFILL, exp.req.rid), None)
        if pair_rid is None:
            return
        fr = self._requests.pop(pair_rid)
        self.completed += 1
        out.append(Result(rid=pair_rid, prompt=fr.prompt,
                          tokens=fr.tokens + [exp.first_tok],
                          finish_reason="failed"))

    def _kill_decode(self, out: List[Result]) -> None:
        """The replica_down site: hard-kill the decode tier
        (abort_all — permanent failure; its in-flight requests come
        back terminal 'failed' and restitch onto the prefill engine
        colocated)."""
        self.replica_downs += 1
        self.flight.record("replica_down", replica=DECODE,
                           step=self.steps)
        for res in self.decode.abort_all("replica_down"):
            self._absorb(DECODE, res, out)

    # ------------------------------------------------------------ absorb
    def _absorb(self, tier: str, res: Result, out: List[Result],
                limbo_rids: frozenset = frozenset()) -> None:
        """Map one engine Result back to its pair request: terminal,
        or a colocated restitch when the decode tier died under it."""
        pair_rid = self._by_engine.pop((tier, res.rid), None)
        if pair_rid is None:
            return                       # warmup traffic / direct submits
        fr = self._requests[pair_rid]
        if res.rid in limbo_rids:
            # A terminal for a PARKED export: the migration resolved
            # without ever landing (deadline shed in limbo, or the
            # source died with the export aboard).
            outcome = "shed" if res.finish_reason == "shed" else "failed"
            self._c_migrations.labels(outcome=outcome).inc()
        if (res.finish_reason == "failed" and tier == DECODE
                and self.fallback and self._restitch(fr, res, out)):
            return
        del self._requests[pair_rid]
        self.completed += 1
        out.append(Result(
            rid=pair_rid, prompt=fr.prompt,
            tokens=fr.tokens + list(res.tokens),
            finish_reason=res.finish_reason,
            prefix_digest=res.prefix_digest))

    def _restitch(self, fr: _PairReq, res: Result,
                  out: List[Result]) -> bool:
        """Re-admit one dead decode tier's victim COLOCATED on the
        prefill engine: prompt' = prompt + salvaged tokens with the
        remaining budget: (seed, position) keys make the resumed stream
        token-identical (the fleet's failover argument, one tier over). May resolve to a terminal itself
        (deadline expired, budget met). False = no restitch possible
        (caller emits the 'failed' terminal)."""
        salvaged = fr.tokens + list(res.tokens)
        remaining = fr.max_new - len(salvaged)
        now = time.monotonic()
        if fr.attempts > 2 or self.prefill.failed:
            return False
        if (fr.deadline_s is not None
                and now - fr.submit_t >= fr.deadline_s):
            self.flight.record("failover_shed", rid=fr.pair_rid,
                               step=self.steps, tokens=len(salvaged))
            del self._requests[fr.pair_rid]
            self.completed += 1
            out.append(Result(rid=fr.pair_rid, prompt=fr.prompt,
                              tokens=salvaged, finish_reason="shed"))
            return True
        if remaining <= 0:
            del self._requests[fr.pair_rid]
            self.completed += 1
            out.append(Result(rid=fr.pair_rid, prompt=fr.prompt,
                              tokens=salvaged, finish_reason="length"))
            return True
        kwargs = dict(fr.kwargs)
        if fr.deadline_s is not None:
            kwargs["deadline_s"] = max(
                fr.deadline_s - (now - fr.submit_t), 0.001)
        try:
            rid = self.prefill.submit(fr.prompt + tuple(salvaged),
                                      remaining, **kwargs)
        except (ValueError, EngineFailedError):
            return False
        self.flight.record("failover", rid=fr.pair_rid, step=self.steps,
                           dead=DECODE, replica=PREFILL,
                           new_rid=f"{PREFILL}:{rid}",
                           tokens=len(salvaged))
        fr.tokens = salvaged
        fr.tier, fr.engine_rid, fr.attempts = PREFILL, rid, fr.attempts + 1
        self._by_engine[(PREFILL, rid)] = fr.pair_rid
        return True

    # ------------------------------------------------------------- views
    def retry_after_s(self, slo_class: Optional[str] = None) -> float:
        """Pair backoff hint: admission happens on the prefill tier,
        so its estimate is the binding one; a failed prefill tier
        falls back to the decode engine's (degenerate colocated)."""
        eng = self.prefill if not self.prefill.failed else self.decode
        return eng.retry_after_s(slo_class=slo_class)

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "submitted": self.submitted,
            "completed": self.completed,
            "in_flight": len(self._requests),
            "migrations": self.migrations,
            "fallbacks": self.fallbacks,
            "replica_downs": self.replica_downs,
            "limbo": self.prefill.sched.limbo,
            "migration_s": self._h_migration.percentiles((50, 90, 99)),
            "tiers": {name: {
                "role": eng.role,
                "active": len(eng._active),
                "queued": eng.sched.queued,
                "completed": eng.completed,
                "migrated": eng.migrated,
                "adopted": eng.adopted,
                "failed": eng.failed,
                "host_dispatches": dict(eng.host_dispatches),
                "prefill_waves": eng.waves,
                "prefill_chunks": eng.prefill_chunks,
            } for name, eng in self.engines.items()},
        }

    def merged_flight_events(self) -> List[dict]:
        """Both tiers' ledgers plus the pair's own, one stream ordered
        by wall clock: rids are tier-namespaced, so each still ends
        once in the merge."""
        events: List[dict] = []
        for eng in self.engines.values():
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
        """Engine.reset_latency_stats on both tiers, and the pair's
        flight ring cleared."""
        for eng in self.engines.values():
            eng.reset_latency_stats()
        self.flight.clear()


# ---------------------------------------------------------------- wire
# Wire dtype names (numpy's, as the JAX package writes them) and back.
WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8", torch.uint8: "uint8"}
_FROM_WIRE = {name: dtype for dtype, name in WIRE_DTYPES.items()}


def leaf_to_wire(t: torch.Tensor) -> dict:
    """One pool leaf's rows as a wire entry: shape, dtype name, base64 of
    its bytes (bf16 through a uint8 view: no numpy bfloat16 needed)."""
    t = _tracecheck.host_sync("migrate-export-readback",
                              t.detach().contiguous())
    raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return {"shape": list(t.shape), "dtype": WIRE_DTYPES[t.dtype],
            "data": base64.b64encode(raw).decode("ascii")}


def leaf_from_wire(entry: dict) -> torch.Tensor:
    """A wire entry back to a CPU tensor of its shape and dtype; KeyError
    on a dtype name the pool cannot hold."""
    dtype = _FROM_WIRE[entry["dtype"]]
    raw = bytearray(base64.b64decode(entry["data"]))
    shape = [int(d) for d in entry["shape"]]
    if not raw:
        return torch.zeros(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def export_to_wire(engine: Engine, exp) -> dict:
    """Serialise one parked export for a migration across processes: the
    request's scheduling and sampling fields, the sampled first token and
    the whole prompt chain's blocks (one entry a pool leaf). The whole
    chain travels, so the handoff is one round trip; the adopter copies
    only the rows its radix cache lacks. Wall clocks do not transfer, so
    the elapsed SLO budget rides as ``waited_s``."""
    req = exp.req
    n_chain = blocks_for(len(req.prompt), engine.kv_page_size)
    leaves = engine.read_pool_blocks(exp.alloc.table[:n_chain])
    return {
        "prompt": list(req.prompt),
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature, "top_k": req.top_k,
        "top_p": req.top_p, "seed": req.seed, "eos_id": req.eos_id,
        "deadline_s": req.deadline_s, "slo_class": req.slo_class,
        "priority": req.priority,
        "first_tok": int(exp.first_tok),
        "waited_s": round(time.monotonic() - exp.submit_t, 6),
        "chain_blocks": n_chain,
        "leaves": [leaf_to_wire(v) for v in leaves],
    }


def adopt_from_wire(engine: Engine, wire: dict, *,
                    src: str = "") -> Optional[Tuple[int, Optional[Result]]]:
    """Adopt one serialised export into ``engine``: reserve the
    footprint, write only the chain rows its radix cache lacks, and
    commit the row (no prefill). Returns (rid, the Result when the first
    token already finishes it), or None on adoption backpressure (no slot
    or blocks: the caller answers 503-retryable and the source reparks
    or falls back). ValueError or KeyError on a payload this pool cannot
    take."""
    req = Request(
        rid=-1, prompt=tuple(int(t) for t in wire["prompt"]),
        max_new_tokens=int(wire["max_new_tokens"]),
        temperature=float(wire.get("temperature", 0.0)),
        top_k=int(wire.get("top_k", 0)),
        top_p=float(wire.get("top_p", 1.0)),
        seed=int(wire.get("seed", 0)),
        eos_id=wire.get("eos_id"),
        deadline_s=wire.get("deadline_s"),
        slo_class=wire.get("slo_class", "default"),
        priority=int(wire.get("priority", DEFAULT_PRIORITY)))
    ad = engine.begin_adopt(req)
    if ad is None:
        return None
    try:
        rows = [leaf_from_wire(entry) for entry in wire["leaves"]]
        idx = torch.tensor(ad.copy, dtype=torch.int64)
        engine.write_pool_blocks(ad.dst_blocks,
                                 [r.index_select(0, idx) for r in rows])
        rid, done = engine.commit_adopt(
            ad, int(wire["first_tok"]),
            submit_t=time.monotonic() - float(wire.get("waited_s", 0.0)),
            src=src)
    except (ValueError, KeyError, IndexError, RuntimeError):
        engine.abort_adopt(ad)
        raise
    return rid, done
