"""Continuous-batching decode engine over a paged or dense KV pool.

The counterpart of nanosandbox_tpu/serve/engine.py's single-chip engine:
both pools, every --kv_dtype (fp32, bf16, int8, int4; the quantized
modes quantize on write, models/gpt.py), and its decode dispatch modes
(``pipeline``, ``scan_k``; below). The paged pool (``paged=True``, the
default):

  * One per-layer K/V pool of (kv_pool_blocks + 1) blocks of
    ``kv_page_size`` positions (models/gpt.py init_paged_cache) and a
    (num_slots, slot_blocks) block table on the device. Admission
    reserves each request's whole need (serve/paged.py BlockPool), with
    refcounted prefix reuse through the radix cache.
  * Admission WAVES: the FIFO prefix of the queue sharing one (suffix)
    prefill bucket, up to the free slots, padded up the admit ladder,
    runs as ONE prefill forward straight against the pool: each row
    writes its suffix K/V at positions [hit, hit + L) through its table
    row, and the paged prefill kernel attends over the row's chain with
    the resident prefix included. Padding rows carry all-sentinel
    tables, so their writes go to the drop block.
  * Batched decode steps over ALL slots: parked rows
    (pos 0, token 0, all-sentinel table) ride along, their writes go to
    the drop block and their tokens are never read. Per-slot decode
    operands live on the device; admission and release update them in
    place, so the decode step uploads nothing.

The dense pool (``paged=False``): one (H, max_len, D) row per slot
(models/gpt.py init_cache). An admission wave of n requests, padded up
the ladder to k rows and to its prefill bucket L, prefills a temp cache
init_cache(k, L) in the compute dtype (scalar cache_index 0: causal
attention, K4), then scatter_cache_rows writes its first n rows onto the
wave's slots (quantizing for an int8/int4 pool). JAX scatters all k rows
and drops the padding rows' by an out-of-range slot id; the host knows
n, so here they are sliced off. The decode step writes each row at its
own position and attends with K3 (flash_decode); a parked row writes
into its own row at position 0, as in JAX. There is no prefix cache.

On both pools sampling is per-row and keyed by (seed, position)
(sample.py): a request's tokens do not depend on the rest of its batch,
nor on how its steps are dispatched.

Dispatch (the JAX engine's ``pipeline`` and ``scan_k``): one dispatch
runs a CHUNK of k decode steps, k from the ``scan_rungs`` ladder (1,
powers of two below scan_k, scan_k) chosen by ``_next_chunk``. A step
body is the forward, the sample, the poison guard (a row with
non-finite logits emits the out-of-vocab sentinel and keeps its input
token) and the frontier advance, all on the device: the host reads
nothing between the steps of a chunk. The chunk's (k, S) tokens land in
a static device buffer and are copied, non-blocking, into one of two
pinned host buffers, with an event recorded after the copy. With
``pipeline`` (the default) one chunk stays in flight: the host
dispatches chunk n + 1 before it retires chunk n (``_retire``), so the
device works while the host reads back, retires and admits. Finish
detection lags by up to a chunk: a row that reached its budget or eos
rides on, its surplus tokens are cut at readback, and its writes land in
its own private positions (dense: clamped to the row's last position,
models/gpt.py write_dense_kv) or the drop block (paged, past its chain).

On CUDA each (rung, filtered) chunk is captured once, in the
constructor over the parked (idle) slot state, as a torch.cuda.CUDAGraph
of k step bodies, and a dispatch is one replay; every graph draws on one
memory pool. ``filtered`` is the host's knowledge that some live row
truncates its distribution (top_k / top_p): the sort is its own program,
as in sample_token_rows. The engine has no eager path on the card: a
capture that fails raises (only a comparison harness runs the body
eagerly there, through the private ``_replay``). The per-slot state
tensors (``_pos``, ``_tok``, ``_temp``, ``_topk``, ``_topp``, ``_seed``,
``_live``, ``_table``), the pool, the token buffer and the decode
kernels' ticket buffer keep their addresses for the engine's life;
admission and release write into them in place, ordered on the stream
behind any chunk in flight. On the CPU
the same body runs eagerly k times.

Scheduling (the JAX engine's, by its names): the queue is ordered by
priority, then FIFO (serve/scheduler.py); a request's priority defaults
from its ``slo_class`` (PRIORITY_BY_CLASS). A request may carry a
``deadline_s`` (submit to finish): a queued request past it is shed (a
terminal 'shed' Result), and every deadline-carrying terminal lands in
the SLO ledger (obs/slo.py). Each step runs, in order: the shed sweep,
the preemption check, admission, the decode dispatch, and the brownout
controller's poll (serve/brownout.py), which may cap the decode chunk
and shed low classes.

  * Chunked prefill (``prefill_chunk``, a prefill bucket): each step
    spends at most that many prefill tokens. A paged request whose
    suffix bucket exceeds it claims a slot and its full reservation,
    then prefills in bucket-shaped pieces, oldest first, one budget a
    step, at cache_index = hit + tokens done (K1 from a moving start).
    An intermediate piece writes K/V only; the last samples the first
    token with the (seed, true_len) key and commits the row. Until then
    the slot stays parked, its table row on the sentinel, so its
    ride-along decode writes go to the drop block. A piece of c tokens
    padded to its bucket writes padding K/V past start + c, into the
    request's private blocks (the next piece overwrites it) or the drop
    block, never a shared prefix block. Dense engines cannot split a
    prompt and pace whole waves.
  * Preemption (``preemption``): when the highest-priority queued
    request has a deadline, cannot be admitted for want of a slot or
    blocks, and would miss its deadline waiting, the lowest-priority
    active request (the latest admitted among equals) is evicted: its
    prompt and generated blocks are donated to the prefix cache
    (BlockPool.release(generated=...): positions below its last token's,
    which the chunk in flight never writes), and it goes back to the
    head of its class with prompt' = prompt + tokens. Its resume is a
    prefix hit, and sampling keyed by position makes its tokens those of
    an unpreempted run; every terminal reports the original prompt and
    all of its tokens (``_Resume``, ``_unstitch``). The slot is also
    dropped from the chunk in flight's snapshot, so a resume into the
    same slot does not take that chunk's tokens.

Speculative decoding (``spec``, serve/spec.py and serve/drafters.py):
each step drafts up to k tokens a live row (capped at its remaining
budget - 1, so a row never overshoots), runs ONE (num_slots, k+1) verify
(on CUDA one of two captured graphs, greedy or sampled) and retires the
accepted prefix plus one fresh token a row, truncated exactly at an eos
inside the run. A full reject rolls back by not advancing the frontier.
The verify's readback gates the next draft, so under spec the loop is
synchronous: ``pipeline`` is forced off and ``scan_k`` to 1. While the
brownout ladder suspends spec (``spec_suspended``), or after
``spec_fault_tolerance`` drafter faults in a row disable it, steps run
the plain decode graphs. A ModelDrafter's pool (its own, in the engine's
kv_dtype; paged, indexed by the engine's block ids) takes each prefill
right after the engine's, and its k+1 draft steps are one captured graph
on CUDA.

Faults and recovery (``faults``, serve/faults.py; serve/recovery.py
EngineSupervisor): the plan's sites sit where JAX's do. A non-finite row
(the sentinel at a readback, or a first token of a prefill) keeps its
clean tokens and marks the step poisoned (``take_poison``); unsupervised,
a row poisoned POISON_STRIKE_LIMIT times in a row ends 'failed'.
``recover`` requeues every active, mid-wave and mid-chunk request at the
head of its class with prompt' = prompt + tokens (a mid-chunk prefill's
blocks freed without donation), so greedy resumes are token-identical.
The graphs point at the slot state and the pools, so recovery resets
them IN PLACE, after a device sync: every slot parked (_release_row),
and under ``flush_cache`` the prefix cache dropped and every pool tensor
zeroed, drop block and drafter pool included, and the decode kernels'
ticket counters zeroed; nothing is re-captured, and no replay touches
freed memory. ``abort_all`` is the permanent failure: every request gets
one terminal 'failed' Result and submit raises EngineFailedError.
``watchdog`` (obs/flight.py) feeds the supervisor its stuck_slot and
stalled_step trips.

Telemetry (obs/, the JAX engine's names; nothing in the hot loop reads
a device tensor for it): ``metrics`` is the engine's MetricRegistry.
Counters and gauges mirror the engine's plain ints at scrape time
(``_collect_metrics``); the latency signal (TTFT, TPOT, queue wait,
prefix TTFT, accepted lengths, recovery time) lives in its histograms,
which ``stats()`` reads too. ``flight`` (a FlightRecorder) takes one
event at every lifecycle point of a request (submit, queue, block
reserve or stall, admit, prefill, prefill_chunk, retire, evict, finish;
reject, shed, preempt, fault, poison, quarantine, requeue, recover,
failed, engine_failed, brownout, drafter_fault, spec_disabled);
``tracer`` (a SpanTracer) the spans 'queued' and 'generate' of each
request, 'prefill_wave' of each admission wave, 'decode_step' of each
decode dispatch (one graph replay: opened at dispatch, closed at its
retire, so with the pipeline on it closes after the next dispatch) and
'spec_verify' of each verify. ``watchdog`` is the full WatchdogPanel
(six detectors, dumps under ``watchdog_dir``); ``request_profile`` arms
a torch.profiler window over the next steps (POST /profile). The
``debug_*`` views read host state only. JAX families this engine does
not publish: the tensor-parallel degree and the compile-trace counter.

Disaggregated prefill/decode (``role``, ``submit(migrate=True)``; the
pair and the HTTP tier that drive it are serve/disagg.py and
serve/http.py): a migrate-flagged request on a paged engine reserves its
prompt's blocks only and, at its first-token readback, EXPORTS instead
of going active: its slot is parked (host and device), and its block
chain, first token (sampled with the (seed, true_len) key) and request
wait in the scheduler's migration limbo (``_Export``), where the shed
sweep, ``recover`` and ``abort_all`` see it. ``pop_export`` claims one;
it ends in exactly one of ``complete_export`` (adopted elsewhere: the
chain is donated here), ``requeue_export`` (colocated fallback: the
re-prefill is a prefix hit over the donated chain and samples the same
first token) or ``repark_export``. The adopting engine runs
``begin_adopt`` (a slot and the full footprint, BlockPool.adopt_chain),
``write_pool_blocks`` (the source's ``read_pool_blocks``, the blocks its
radix cache lacks) and ``commit_adopt``, which writes the row's slot
state in place (pos = true_len, the first token, the seed and sampling
knobs, the table row): no prefill runs there, and decode continues at
(seed, pos + 1), the stream the source would have produced. Both pool
calls write and read the pool tensors in place, ordered on the stream
behind any chunk in flight, and neither touches the drop block.
"""

from __future__ import annotations

import gc
import itertools
import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nanosandbox_tpu_torch.config import resolve_device
from nanosandbox_tpu_torch.models.gpt import (GPT, init_cache,
                                              init_paged_cache, kv_mode,
                                              pool_shards, shard_for_serving,
                                              scatter_cache_rows)
from nanosandbox_tpu_torch.obs.flight import FlightRecorder, WatchdogPanel
from nanosandbox_tpu_torch.obs.registry import MetricRegistry
from nanosandbox_tpu_torch.obs.slo import SLOLedger, validate_slo_class
from nanosandbox_tpu_torch.obs.tracer import SpanTracer
from nanosandbox_tpu_torch.ops import _build
from nanosandbox_tpu_torch.ops import attention as at
from nanosandbox_tpu_torch.ops import flash_decode as fd
from nanosandbox_tpu_torch.sample import sample_token_rows
from nanosandbox_tpu_torch.serve.brownout import BrownoutController
from nanosandbox_tpu_torch.serve.faults import FaultInjected, FaultPlan
from nanosandbox_tpu_torch.serve.paged import (Allocation, BlockPool,
                                               prefix_digests)
from nanosandbox_tpu_torch.serve.scheduler import (SlotScheduler,
                                                   default_buckets)
from nanosandbox_tpu_torch.serve.spec import SpecRunner
from nanosandbox_tpu_torch.utils import profiler as profile_window
from nanosandbox_tpu_torch.utils import tracecheck as _tracecheck
from nanosandbox_tpu_torch.utils.metrics import warn_once
from nanosandbox_tpu_torch.utils.tracecheck import TraceBudgetRegistry

# Scheduling priority by SLO class: higher admits first and may preempt
# lower. An explicit priority overrides the class's; unknown classes take
# the default. The brownout floors (serve/brownout.py) use these numbers.
PRIORITY_BY_CLASS = {"batch": 0, "default": 1, "interactive": 2}
DEFAULT_PRIORITY = 1

# Consecutive poisoned readbacks a row survives before it ends 'failed':
# the backstop when no supervisor recovers (a supervised engine recovers
# after the first poison).
POISON_STRIKE_LIMIT = 3


class EngineFailedError(RuntimeError):
    """The engine escalated to permanent failure (recovery exhausted its
    attempts) and drained; submissions are refused until a restart. The
    HTTP layer answers 503."""


@dataclass(frozen=True)
class Request:
    """One generation request, in token-id space. ``deadline_s`` is the
    submit-to-finish budget (None: never tracked, never deadline-shed);
    ``slo_class`` labels its SLO accounting; ``priority`` orders the
    queue and decides who preempts whom."""
    rid: int
    prompt: tuple
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    slo_class: str = "default"
    priority: int = DEFAULT_PRIORITY

    @property
    def filters(self) -> bool:
        """Samples from a truncated distribution (needs the sort)."""
        return self.temperature > 0 and (self.top_k > 0 or self.top_p < 1.0)


@dataclass
class Result:
    rid: int
    prompt: tuple
    tokens: List[int]          # generated ids (includes the eos hit, if any)
    finish_reason: str         # 'length' | 'eos' | 'shed' | 'failed'
    prefix_digest: tuple = ()  # prompt blocks donated to the prefix cache


@dataclass
class _Active:
    req: Request
    slot: int
    alloc: Optional[Allocation]             # None on the dense pool
    tokens: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0
    last_t: float = 0.0                     # last retired token (watchdog)
    poison_strikes: int = 0
    spec_accepted: int = 0
    span: int = 0                           # its open 'generate' span


@dataclass
class _Resume:
    """A preempted request's original prompt and the tokens it had
    before each preemption: what its terminal Result reports."""
    prompt: tuple
    tokens: List[int]


@dataclass
class _Export:
    """A request parked in migration limbo: its prompt's K/V sits in
    ``alloc``'s chain and ``first_tok`` was sampled with the (seed,
    true_len) key, but its decode belongs to another engine. Its slot was
    released at export, so it owns {blocks, first token, request}: the
    migration's payload. A shed or abort frees its blocks without
    donation."""
    req: Request
    alloc: Allocation
    first_tok: int
    export_t: float              # wall clock at export
    submit_t: float              # wall clock at submit (deadline budget)
    submit_step: int

    # The shed sweep applies one predicate to queue items and limbo
    # records: the fields it reads.
    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def deadline_s(self) -> Optional[float]:
        return self.req.deadline_s

    @property
    def priority(self) -> int:
        return self.req.priority


@dataclass
class _Adoption:
    """The adopting side's handle between begin_adopt (slot and blocks
    reserved, nothing written) and commit_adopt or abort_adopt.
    ``copy`` lists the chain positions the caller fills from the source
    pool before the commit; ``dst_blocks`` are their block ids here."""
    req: Request
    slot: int
    alloc: Allocation
    copy: List[int]

    @property
    def dst_blocks(self) -> List[int]:
        return [self.alloc.table[i] for i in self.copy]


@dataclass
class _Chunking:
    """A request in the chunked-prefill lane: popped from the queue with
    a slot claimed and every block reserved. ``hit`` is its prefix hit
    (the first piece's start), ``done`` the suffix tokens written."""
    req: Request
    slot: int
    alloc: Allocation
    hit: int
    done: int = 0


# The JAX engine's decode_impl names. 'auto' and 'pallas' name the
# decode kernels (K2, K3), which a CUDA tensor always runs and a CPU
# tensor never does; 'pallas_interpret' and 'xla' name JAX
# implementations and are accepted but inert, as attention_impl's are.
DECODE_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")


def resolve_decode_impl(impl: Optional[str]) -> str:
    """None and 'auto' -> 'pallas'; the other names pass through."""
    impl = impl or "auto"
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode impl: {impl!r} (expected one of "
                         f"{DECODE_IMPLS})")
    return "pallas" if impl == "auto" else impl


def scan_ladder(scan_k: int) -> List[int]:
    """The chunk lengths one dispatch may run: 1, the powers of two below
    scan_k, then scan_k (JAX's scan_rungs)."""
    if scan_k < 1:
        raise ValueError(f"scan_k must be >= 1, got {scan_k}")
    rungs = [1]
    r = 2
    while r < scan_k:
        rungs.append(r)
        r *= 2
    if scan_k > 1:
        rungs.append(scan_k)
    return rungs


class Engine:
    """submit() / step() / drain() over a KV pool on ``device``.

    model : a GPT whose weights are already in their serving dtype
        (models/gpt.py cast_for_serving); moved to ``device``.
    num_slots : concurrent requests (the decode batch).
    max_len : per-request positions (prompt + new tokens); capped at
        block_size.
    kv_dtype : 'fp32' | 'bf16' | 'int8' | 'int4' (default: the compute
        dtype).
    paged : the block-paged pool (default) or, False, the dense one.
    kv_page_size / kv_pool_blocks / prefix_cache : the paged pool, as in
        the JAX engine (default pool: num_slots * max_len / page blocks);
        unused by the dense pool.
    pipeline : keep one decode chunk in flight ahead of the host
        (default); False is the synchronous loop (dispatch, read back,
        retire). Tokens are the same either way.
    scan_k : decode steps one dispatch may run (module docstring);
        tokens are the same for every value.
    decode_impl : a name of DECODE_IMPLS (default 'auto').
    default_deadline_s : the deadline of requests that give none (None:
        best-effort).
    prefill_chunk : the per-step prefill token budget, one of the prefill
        buckets (None: admit everything now); module docstring.
    preemption : evict a lower-priority row for a deadline-pressed queue
        head (default True; module docstring).
    brownout : attach a BrownoutController (default False; the serve CLI
        turns it on).
    spec : a drafter (serve/drafters.py NGramDrafter or ModelDrafter, or
        any object with ``kind`` 'host', ``k`` and ``propose``) turns on
        speculative decoding (module docstring); None (default) is off.
    spec_fault_tolerance : drafter faults in a row absorbed (each step
        degrades to plain verify of no drafts) before spec is disabled
        for the engine's life (default 3).
    faults : a serve/faults.py FaultPlan injecting failures at its sites
        (default None: each site check is one ``is None`` branch).
    metrics : the MetricRegistry to publish on (default: a new one; one
        engine a registry, a second raises).
    tracer : the SpanTracer (default: a new one).
    flight : the FlightRecorder (default: a new one).
    watchdogs : run the WatchdogPanel's detectors (default True).
    watchdog_dir : where a trip dumps (default: a temporary directory
        made at the first trip).
    role : the serving tier, 'both' (colocated, the default), 'prefill'
        or 'decode': telemetry and fleet routing, never a capability
        gate (a prefill engine whose decode tier died still decodes).
    tp : the tensor-parallel degree (default 1). tp > 1 runs ONE engine
        as a single controller over tp shards (JAX's contract): each
        shard holds its own weights, the Megatron placement of
        parallel/tensor.py (its heads of c_attn, its columns of c_proj,
        its rows of c_fc), its own slice of the pool along the heads
        (paged (N, H/tp, page, D), dense (S, H/tp, L, D), with their
        scale planes: shard i's is the pool tensors' [i]) and its own
        launches of the attention kernels over its heads. The
        row-parallel partial products are summed in shard order, then
        the bias added (models/gpt.py ShardedBlock); slot state, tables
        and sampling stay one copy. Greedy tokens equal tp 1's; the
        graphs captured do not change in number; read_pool_blocks and
        write_pool_blocks move tp 1's payload (every shard's heads in
        order), so tiers of different tp migrate both ways. Requires
        n_head % tp == 0; a device drafter raises (it would need its
        own sharded pool), as JAX's does. Every shard lives on the
        engine's device: one card holds them all.
    tp_devices : the cards the shards would live on (default: the
        engine's device for all). Naming more than one card raises
        NotImplementedError: shards across cards are not ported yet.
    device : 'auto' (the GPU; raises without one), 'cuda' or 'cpu'.
    """

    # A dispatch's fixed cost in units of one step's device time: the
    # chunk policy's rate of exchange between fewer dispatches and lane
    # steps past a row's budget (JAX's value).
    scan_dispatch_cost_steps = 2.0

    def __init__(self, model: GPT, *, num_slots: int = 8,
                 max_len: Optional[int] = None,
                 kv_dtype: Optional[str] = None, paged: bool = True,
                 kv_page_size: int = 16,
                 kv_pool_blocks: Optional[int] = None,
                 prefix_cache: bool = True, pipeline: bool = True,
                 scan_k: int = 1, decode_impl: Optional[str] = None,
                 default_deadline_s: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 preemption: bool = True, brownout: bool = False,
                 spec=None, spec_fault_tolerance: int = 3,
                 faults: Optional[FaultPlan] = None,
                 metrics: Optional[MetricRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 watchdogs: bool = True,
                 watchdog_dir: Optional[str] = None,
                 role: str = "both", tp: int = 1,
                 tp_devices: Optional[Sequence] = None,
                 device: str = "auto"):
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if model.cfg.n_head % self.tp:
            raise ValueError(
                f"tp={self.tp} must divide n_head={model.cfg.n_head}: the "
                "KV pool shards along the heads dim")
        if (self.tp > 1 and spec is not None
                and getattr(spec, "kind", "host") == "device"):
            raise ValueError(
                "tp > 1 supports host drafters only (e.g. "
                "NGramDrafter); a tensor-parallel ModelDrafter "
                "needs its own sharded pool")
        if paged and kv_page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got "
                             f"{kv_page_size}")
        # A verify's readback gates the next draft: under spec the loop
        # is synchronous, one step a dispatch (module docstring).
        if spec is not None:
            pipeline, scan_k = False, 1
        self.scan_rungs = scan_ladder(scan_k)
        self.scan_k = int(scan_k)
        self.pipeline = bool(pipeline)
        self.decode_impl = resolve_decode_impl(decode_impl)
        self.device = resolve_device(device)
        if tp_devices is not None and {
                torch.device(d) for d in tp_devices} != {self.device}:
            raise NotImplementedError(
                f"tensor-parallel shards on {list(tp_devices)}: shards "
                f"across cards, or off the engine's {self.device}, are not "
                "ported yet")
        self.model = shard_for_serving(model.to(self.device),
                                       self.tp).eval()
        cfg = self.cfg = model.cfg
        if self.tp > 1:
            print(f"[engine] tp {self.tp}: {self.tp} shards of "
                  f"{cfg.n_head // self.tp} heads, every shard on "
                  f"{self.device}", flush=True)
        self.kv_dtype = kv_mode(cfg, kv_dtype)
        self.num_slots = num_slots
        self.max_len = min(max_len or cfg.block_size, cfg.block_size)
        # Prefill buckets: the power-of-two ladder up to max_len.
        self.sched = SlotScheduler(num_slots, default_buckets(self.max_len))
        self.admit_buckets = self.sched.admit_buckets
        # A chunk is a bucket, so chunk dispatches keep the waves' shapes.
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk not in self.sched.buckets:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be one of the "
                    f"prefill buckets {self.sched.buckets} (chunk "
                    "dispatches reuse the bucket-shaped programs)")
        self.prefill_chunk = prefill_chunk
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError(f"default_deadline_s must be > 0, got "
                             f"{default_deadline_s}")
        self.default_deadline_s = default_deadline_s
        self.preemption = bool(preemption)
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill' or 'decode', "
                             f"got {role!r}")
        self.role = role
        # Requests submitted with migrate=True (still before their
        # export), and the handoffs out of and into this engine.
        self._migrate_rids: set = set()
        self.migrated = 0
        self.adopted = 0
        self.paged = bool(paged)
        self.block_pool: Optional[BlockPool] = None
        if self.paged:
            self.kv_page_size = int(kv_page_size)
            self.slot_blocks = -(-self.max_len // self.kv_page_size)
            self.kv_pool_blocks = int(kv_pool_blocks
                                      or num_slots * self.slot_blocks)
            self._pool = init_paged_cache(cfg, self.kv_pool_blocks,
                                          self.kv_page_size, kv_dtype,
                                          device=self.device, tp=self.tp)
            self.block_pool = BlockPool(self.kv_pool_blocks,
                                        self.kv_page_size,
                                        prefix_cache=prefix_cache)
        else:
            self.kv_page_size = self.slot_blocks = self.kv_pool_blocks = 0
            self._pool = init_cache(cfg, num_slots, self.max_len, kv_dtype,
                                    device=self.device, tp=self.tp)
        self._init_slot_state()

        self._active: Dict[int, _Active] = {}        # slot -> state
        self._pending: List[Result] = []    # terminal before any step
        # rid -> (decode steps, wall clock, open 'queued' span) at submit,
        # for queued requests.
        self._submit_meta: Dict[int, Tuple[int, float, int]] = {}
        self._chunking: List[_Chunking] = []     # the chunked-prefill lane
        self._prefill_spent = 0                  # this step's prefill tokens
        self._resumed: Dict[int, _Resume] = {}   # preempted rids
        self._rid = itertools.count()
        # The dispatched chunk not yet retired: (host buffer index,
        # {slot: rid} at dispatch, chunk length, injected poison, its
        # 'decode_step' span, the step count at dispatch).
        self._inflight: Optional[tuple] = None
        self.steps = 0                               # decode dispatches
        self.chunk_steps = 0            # decode steps those dispatches ran
        self.waves = 0
        self.prefill_chunks = 0         # chunked-lane prefill dispatches
        self.admitted = 0
        self.completed = 0
        self.tokens_generated = 0
        self.rejected: Dict[str, int] = {}
        self.shed = 0
        # Deadline-carrying sheds that the brownout floor caused: the
        # controller takes them out of its window (serve/brownout.py).
        self.brownout_sheds = 0
        self.preemptions = 0
        # The brownout knobs, read on the hot path.
        self.scan_cap: Optional[int] = None
        self.spec_suspended = False
        self.brownout_min_priority: Optional[int] = None
        # Capture budgets (utils/tracecheck.py): registered from
        # max_programs() before the captures; every capture bumps its
        # kind first, and past its budget (or frozen) it raises.
        self.tracecheck = TraceBudgetRegistry()
        self._init_telemetry(metrics, tracer, flight)
        self.slo = SLOLedger(self.metrics)
        # Dispatches by kind: decode chunks, and under spec verifies.
        self.host_dispatches = {"decode": 0}
        if spec is not None:
            self.host_dispatches["verify"] = 0
        # Faults and recovery (module docstring). _admitting is the wave
        # between its queue pop and its commit: (req, slot, alloc,
        # whether recover may donate its prompt blocks).
        self.faults = faults
        if faults is not None:
            faults.arm(0)
        self.spec_fault_tolerance = int(spec_fault_tolerance)
        self.quarantined = False
        self.quarantine_cause: Optional[str] = None
        self.failed = False
        self.recoveries = 0
        self.poisoned_steps = 0
        self.requeued = 0
        self.drafter_faults = 0
        self.spec_disabled_reason: Optional[str] = None
        self._drafter_fault_streak = 0
        self._poison: Optional[dict] = None
        self._admitting: List[tuple] = []
        # The open 'prefill_wave' span of the wave in _admitting, ended
        # by recover() and abort_all() when a raise skipped its close.
        self._admitting_span: Optional[int] = None
        self.watchdog = WatchdogPanel(self, dump_dir=watchdog_dir,
                                      enabled=watchdogs)
        self.metrics.add_collector(self._collect_metrics)
        # The on-demand torch.profiler window (request_profile): armed
        # from an HTTP thread, opened, advanced and closed by the one
        # stepping thread inside step().
        self._profile_lock = threading.Lock()
        self._profile: Optional[dict] = None
        self.last_profile: Optional[dict] = None
        self._spec = None
        if spec is not None:
            if spec.kind == "device":
                spec.build(target_cfg=cfg, num_slots=num_slots,
                           max_len=self.max_len, kv_dtype=self.kv_dtype,
                           paged=self.paged,
                           kv_page_size=self.kv_page_size,
                           kv_pool_blocks=self.kv_pool_blocks,
                           device=self.device)
            self._spec = SpecRunner(spec, self)
            self._spec.register_metrics(self.metrics)
        self._rate: deque = deque(maxlen=256)        # (t, tokens read back)
        # On CUDA, per (rung, filtered): the captured chunk, its replays,
        # and the kernel launches and plain-version calls its capture
        # recorded (a replay runs them again, uncounted by the wrappers);
        # and the bytes the captures reserved. Under spec the verify
        # graphs ('verify', sampled) and a ModelDrafter's ('draft',) sit
        # in _spec_graphs, with their replays and counts in the same
        # dicts.
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self._spec_graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self.graph_replays: Dict[tuple, int] = {}
        self.graph_launches: Dict[tuple, Dict[str, int]] = {}
        self.graph_plain_calls: Dict[tuple, Dict[str, int]] = {}
        self.graph_pool_bytes = 0
        self._replay = self.device.type == "cuda"
        # The budgets: the graphs the engine captures, by kind (0 on the
        # CPU, where the bodies run eagerly).
        for kind, bodies in self._program_bodies().items():
            self.tracecheck.register(kind, len(bodies) * self._replay)
        if self._replay:
            _build.library()       # build the kernels before any request
            self._capture_graphs()
        # Last, so that the controller sees the finished engine.
        self.brownout = BrownoutController(self) if brownout else None

    # ------------------------------------------------------------------
    # telemetry (module docstring)
    # ------------------------------------------------------------------
    def _init_telemetry(self, metrics, tracer, flight) -> None:
        """The registry and its families, the tracer and the flight
        recorder. The latency signal lives in histograms (a RingStat
        window for stats() and Prometheus buckets for /metrics: both read
        the same series); the counters and gauges are mirrored from plain
        ints by _collect_metrics at scrape time."""
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.flight = flight if flight is not None else FlightRecorder()
        m = self.metrics
        # One engine a registry: a second would share the unlabeled
        # families, and the two collectors would overwrite each other's
        # mirrored counters at every scrape.
        if any(f.name == "serve_ttft_seconds" for f in m.families()):
            raise ValueError(
                "metrics registry already hosts an Engine's families; "
                "give each Engine its own MetricRegistry")
        self._ttft = m.histogram(
            "serve_ttft_seconds", "Submit -> first-token seconds.",
            unit="seconds")
        self._tpot = m.histogram(
            "serve_tpot_seconds", "Per-token seconds after the first.",
            unit="seconds")
        # Decode steps each admitted request waited in the queue (the
        # retry-after hint's p50).
        self._queue_wait = m.histogram(
            "serve_queue_wait_steps",
            "Decode steps a request spent queued before admission.",
            unit="steps", buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
        self._c_submitted = m.counter(
            "serve_requests_submitted_total", "Requests accepted by submit().")
        self._c_completed = m.counter(
            "serve_requests_completed_total",
            "Requests finished, by finish reason.", labelnames=("reason",))
        self._c_waves = m.counter(
            "serve_prefill_waves_total", "Batched prefill admission waves.")
        self._c_tokens = m.counter(
            "serve_tokens_generated_total", "Generated tokens read back.")
        self._c_steps = m.counter(
            "serve_decode_steps_total",
            "Batched decode/verify step dispatches.")
        self._c_dispatches = m.counter(
            "serve_host_dispatches_total",
            "Compiled-program dispatches from the engine loop, by "
            "program kind.", labelnames=("kind",))
        self._g_toks_per_dispatch = m.gauge(
            "serve_tokens_per_dispatch",
            "Generated tokens per decode dispatch over the engine "
            "lifetime (== scan_k when every chunk retires fully).")
        self._c_admitted = m.counter(
            "serve_requests_admitted_total", "Requests admitted to slots.")
        self._c_traces = m.counter(
            "serve_compile_traces_total",
            "Observed CUDA graph captures of this engine's programs, by "
            "kind.", labelnames=("program",))
        self._g_active = m.gauge("serve_slots_active",
                                 "Slots owned by in-flight requests.")
        self._g_free = m.gauge("serve_slots_free", "Free KV-pool slots.")
        self._g_queued = m.gauge("serve_queue_depth",
                                 "Requests queued awaiting admission.")
        self._g_rate = m.gauge(
            "serve_decode_tokens_per_sec",
            "Generated tokens/sec over the recent readback window.")
        self._g_impl = m.gauge(
            "serve_decode_attention_impl",
            "Resolved cached-decode attention impl (1 = active).",
            labelnames=("impl",))
        self._g_kv = m.gauge(
            "serve_kv_dtype", "KV-pool storage mode (1 = active).",
            labelnames=("kv_dtype",))
        self._g_tp = m.gauge(
            "serve_tp_degree",
            "Tensor-parallel degree of the decode engine (model-axis "
            "shards; 1 = single chip).")
        self._g_pool_blocks = m.gauge(
            "serve_kv_pool_blocks",
            "Paged KV pool blocks by state (free | live | cached).",
            labelnames=("state",))
        self._c_prefix_hit = m.counter(
            "serve_prefix_hit_tokens_total",
            "Prompt tokens skipped via radix prefix-cache hits.")
        self._c_prefix_miss = m.counter(
            "serve_prefix_miss_tokens_total",
            "Prompt tokens prefilled from scratch.")
        self._c_block_stalls = m.counter(
            "serve_admission_block_stall_steps_total",
            "Admission attempts deferred on KV-block availability "
            "(the no-deadlock backpressure: the request stays queued).")
        self._ttft_prefix = m.histogram(
            "serve_prefix_ttft_seconds",
            "Submit -> first-token seconds by prefix-cache outcome.",
            unit="seconds", labelnames=("prefix",))
        self._c_rejected = m.counter(
            "serve_requests_rejected_total",
            "Requests rejected at submit, by reason.",
            labelnames=("reason",))
        self._c_shed = m.counter(
            "serve_requests_shed_total",
            "Queued requests shed after their deadline expired.")
        self._c_preempted = m.counter(
            "serve_preemptions_total",
            "Active requests preempted (evicted + requeued) so a "
            "higher-priority deadline could admit.")
        self._c_recoveries = m.counter(
            "serve_engine_recoveries_total",
            "Engine quarantine -> rebuild -> re-admit cycles, by cause.",
            labelnames=("cause",))
        self._h_recovery = m.histogram(
            "serve_engine_recovery_seconds",
            "Quarantine -> device state rebuilt and victims requeued.",
            unit="seconds",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0))
        self._c_poisoned = m.counter(
            "serve_poisoned_steps_total",
            "Steps whose readback carried poisoned (non-finite-logit "
            "or out-of-vocab) tokens.")
        self._c_requeued = m.counter(
            "serve_requests_requeued_total",
            "In-flight requests re-admitted after an engine recovery.")
        self._c_drafter_faults = m.counter(
            "serve_spec_drafter_faults_total",
            "Drafter faults absorbed (the step degraded to plain "
            "decode).")
        self._g_quarantined = m.gauge(
            "serve_engine_quarantined",
            "1 while the engine is quarantined for recovery, else 0.")
        # Accepted draft lengths of drafting verify rows, and each
        # request's accepted total at its finish (spec only).
        self._spec_accept_len = m.histogram(
            "serve_spec_accept_len",
            "Accepted draft length per drafting verify row.",
            unit="tokens", buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16),
            window=4096)
        self._spec_req_accepted = m.histogram(
            "serve_spec_req_accepted_tokens",
            "Draft tokens accepted over one request's lifetime.",
            unit="tokens", buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))
        # The disaggregated posture: this engine's tier (1-hot) and its
        # sides of the migration flow.
        self._g_role = m.gauge(
            "serve_engine_role",
            "Serving tier of this engine (1 = active role).",
            labelnames=("role",))
        self._g_limbo = m.gauge(
            "serve_migration_limbo_depth",
            "Exports parked awaiting adoption by the decode tier.")
        self._c_migrated = m.counter(
            "serve_migrated_out_total",
            "Requests this engine prefilled and handed to another "
            "tier (terminal accounting moves with them).")
        self._c_adopted = m.counter(
            "serve_adopted_in_total",
            "Migrated requests this engine re-admitted as pure prefix "
            "hits (zero prefill dispatches).")

    def _collect_metrics(self) -> None:
        """The scrape-time mirror of the engine's plain ints into the
        registry: runs per snapshot or scrape, never in the decode loop."""
        self._c_tokens._set_total(self.tokens_generated)
        self._c_steps._set_total(self.steps)
        for kind, n in list(self.host_dispatches.items()):
            if n:
                self._c_dispatches.labels(kind=kind)._set_total(n)
        dec = sum(self.host_dispatches.values())
        self._g_toks_per_dispatch.set(
            self.tokens_generated / dec if dec else 0.0)
        self._c_admitted._set_total(self.admitted)
        self._c_shed._set_total(self.shed)
        self._c_preempted._set_total(self.preemptions)
        for reason, n in list(self.rejected.items()):
            self._c_rejected.labels(reason=reason)._set_total(n)
        self._c_poisoned._set_total(self.poisoned_steps)
        self._c_requeued._set_total(self.requeued)
        self._c_drafter_faults._set_total(self.drafter_faults)
        self._g_quarantined.set(1.0 if self.quarantined else 0.0)
        self._g_role.labels(role=self.role).set(1.0)
        self._g_limbo.set(self.sched.limbo)
        self._c_migrated._set_total(self.migrated)
        self._c_adopted._set_total(self.adopted)
        self._g_active.set(len(self._active))
        self._g_free.set(self.sched.free_slots)
        self._g_queued.set(self.sched.queued)
        rate = self._recent_rate()
        self._g_rate.set(0.0 if rate is None else rate)
        self._g_impl.labels(impl=self.decode_impl).set(1.0)
        self._g_kv.labels(kv_dtype=self.kv_dtype).set(1.0)
        self._g_tp.set(float(self.tp))
        if self.block_pool is not None:
            ps = self.block_pool.stats()
            for state in ("free", "live", "cached"):
                self._g_pool_blocks.labels(state=state).set(ps[state])
            self._c_prefix_hit._set_total(ps["prefix_hit_tokens"])
            self._c_prefix_miss._set_total(ps["prefix_miss_tokens"])
            self._c_block_stalls._set_total(ps["block_stall_steps"])
        for name, n in self.tracecheck.counts().items():
            self._c_traces.labels(program=name)._set_total(n)

    def program_counts(self) -> dict:
        """The programs built: this engine's CUDA graph captures (its
        tracecheck registry) and the kernel libraries the process loaded
        (the global registry's 'kernel_library'). What the
        post_freeze_retrace watchdog watches, as JAX's watches its jit
        traces: either growing after the warmup is a build on a live
        request's time."""
        return {"graph_captures": sum(self.tracecheck.counts().values()),
                "kernel_builds": _tracecheck.global_registry().counts().get(
                    _build.BUDGET_NAME, 0)}

    # ------------------------------------------------------------------
    # device slot state
    # ------------------------------------------------------------------
    def _init_slot_state(self) -> None:
        """The per-slot decode operands, parked, and the chunk's token
        buffers. Every tensor here keeps its address for the engine's
        life (the graphs point at them)."""
        S, dev = self.num_slots, self.device
        self._pos = torch.zeros(S, dtype=torch.int32, device=dev)
        self._tok = torch.zeros(S, dtype=torch.int64, device=dev)
        self._temp = torch.zeros(S, dtype=torch.float32, device=dev)
        self._topk = torch.zeros(S, dtype=torch.int64, device=dev)
        self._topp = torch.ones(S, dtype=torch.float32, device=dev)
        self._seed = torch.zeros(S, dtype=torch.int64, device=dev)
        self._live = torch.zeros(S, dtype=torch.bool, device=dev)
        self._table = (torch.full((S, self.slot_blocks), self.kv_pool_blocks,
                                  dtype=torch.int32, device=dev)
                       if self.paged else None)
        self._chunk_toks = torch.zeros((self.scan_k, S), dtype=torch.int64,
                                       device=dev)
        # Two host buffers, used in turn, so the chunk in flight and the
        # one being retired never share one; each with the event recorded
        # after its copy.
        cuda = dev.type == "cuda"
        self._host_toks = [torch.zeros((self.scan_k, S), dtype=torch.int64,
                                       pin_memory=cuda) for _ in range(2)]
        self._copied = ([torch.cuda.Event() for _ in range(2)] if cuda
                        else [None, None])
        self._next_buf = 0

    def _release_row(self, slot: int) -> None:
        """Park one slot: pos 0, token 0, greedy and, paged, the whole
        table row on the sentinel, so its ride-along decode writes go to
        the drop block instead of a block the host has freed or donated.
        A parked dense row writes into its own row at position 0."""
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._seed[slot] = 0
        self._live[slot] = False
        if self.paged:
            self._table[slot] = self.kv_pool_blocks

    def _reset_device_state(self, flush_cache: bool) -> None:
        """Recovery's in-place reset (module docstring): wait for the
        device, park every slot, and under ``flush_cache`` zero every
        pool tensor (the drop block and a ModelDrafter's pool included)
        and the decode kernels' ticket counters. Every tensor keeps its
        address, so the captured graphs stay valid."""
        if self.device.type == "cuda":
            _tracecheck.host_sync("recovery-sync")
            torch.cuda.synchronize(self.device)
        for slot in range(self.num_slots):
            self._release_row(slot)
        if not flush_cache:
            return
        for layer in self._pool:
            for buf in layer:
                buf.zero_()
        if self._spec is not None and self._spec.drafter.kind == "device":
            self._spec.drafter.zero_pool()
        if self._replay:
            self._tickets.zero_()

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _reject(self, reason: str, msg: str, **fields) -> None:
        """Count a rejected submission, leave its terminal 'reject' event
        (rid None: no id was assigned) and raise the client error."""
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        self.flight.record("reject", step=self.steps, reason=reason,
                           **fields)
        raise ValueError(msg)

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               slo_class: str = "default",
               priority: Optional[int] = None,
               migrate: bool = False) -> int:
        """Queue one request; returns its id. Requests the engine can
        never serve are rejected here (ValueError), not mid-flight.
        ``deadline_s`` (default: default_deadline_s) arms SLO accounting
        and queue-time shedding; ``priority`` defaults from
        PRIORITY_BY_CLASS[slo_class]. Below an active brownout floor a
        valid request is accepted and shed at once (a 'shed' Result).
        ``migrate=True`` (paged engines) marks it for the disaggregated
        handoff: it prefills here and exports (module docstring); its
        terminal Result comes from the adopting engine, or from here when
        the first token already finishes it or the export is shed or
        falls back."""
        prompt = tuple(int(t) for t in prompt)
        plen = len(prompt)
        if self.failed:
            # Permanent failure drains; it does not queue into a void.
            self.rejected["engine_failed"] = \
                self.rejected.get("engine_failed", 0) + 1
            self.flight.record("reject", step=self.steps,
                               reason="engine_failed", prompt_len=plen)
            raise EngineFailedError(
                "engine permanently failed "
                f"({self.quarantine_cause or 'unknown cause'}); restart "
                "the process or route to another replica")
        if not prompt:
            self._reject("empty_prompt",
                         "empty prompt (encode at least one token)")
        bad = next((t for t in prompt
                    if not 0 <= t < self.cfg.vocab_size), None)
        if bad is not None:
            self._reject("token_out_of_range",
                         f"prompt token {bad} outside [0, vocab_size="
                         f"{self.cfg.vocab_size})", prompt_len=plen)
        if max_new_tokens < 0:
            self._reject("bad_max_new",
                         f"max_new_tokens must be >= 0, got {max_new_tokens}",
                         prompt_len=plen)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        else:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                self._reject("bad_deadline",
                             f"deadline_s must be > 0, got {deadline_s}",
                             prompt_len=plen)
        try:
            slo_class = validate_slo_class(str(slo_class))
        except ValueError as e:
            self._reject("bad_slo_class", str(e), prompt_len=plen)
        if plen > self.sched.buckets[-1]:
            self._reject("prompt_exceeds_bucket",
                         f"prompt length {plen} exceeds the largest prefill "
                         f"bucket {self.sched.buckets[-1]}", prompt_len=plen)
        if plen + max_new_tokens > self.max_len:
            self._reject("exceeds_max_len",
                         f"prompt ({plen}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds the per-request KV "
                         f"length {self.max_len}", prompt_len=plen)
        if self.paged:
            need = self.block_pool.blocks_needed(plen, max_new_tokens)
            if need > self.kv_pool_blocks:
                self._reject("pool_too_small",
                             f"request needs {need} KV blocks but the pool "
                             f"holds {self.kv_pool_blocks}", prompt_len=plen)
        if migrate and not self.paged:
            self._reject("migrate_unpaged",
                         "migrate=True needs a paged engine: the block chain "
                         "is the migration wire format", prompt_len=plen)
        priority = (PRIORITY_BY_CLASS.get(slo_class, DEFAULT_PRIORITY)
                    if priority is None else int(priority))
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed), eos_id=eos_id,
                      deadline_s=deadline_s, slo_class=slo_class,
                      priority=priority)
        self._c_submitted.inc()
        sub_fields = {"prompt_len": plen, "max_new": max_new_tokens,
                      "slo_class": slo_class, "priority": priority}
        if deadline_s is not None:
            sub_fields["deadline_s"] = deadline_s
        self.flight.record("submit", rid=rid, step=self.steps, **sub_fields)
        floor = self.brownout_min_priority
        if floor is not None and priority < floor:
            # Shed at submit: counted against the class's attainment,
            # nothing spent on it.
            self.shed += 1
            self.flight.record("shed", rid=rid, step=self.steps,
                               reason="brownout", slo_class=slo_class,
                               priority=priority, floor=floor)
            if deadline_s is not None:
                self.slo.record_shed(slo_class)
                self.brownout_sheds += 1
            self._pending.append(Result(rid, prompt, [], "shed"))
            return rid
        if max_new_tokens == 0:
            self.completed += 1
            self._c_completed.labels(reason="length").inc()
            self.flight.record("finish", rid=rid, step=self.steps,
                               reason="length", tokens=0, e2e_s=0.0)
            self.slo.record_finish(slo_class, tokens=0, elapsed_s=0.0,
                                   deadline_s=deadline_s)
            self._pending.append(Result(rid, prompt, [], "length"))
            return rid
        if migrate and max_new_tokens > 1:
            # A one-token request finishes at its prefill: nothing to
            # migrate, it stays colocated.
            self._migrate_rids.add(rid)
        sid = self.tracer.begin("queued", cat="request", rid=rid,
                                args={"prompt_len": plen,
                                      "max_new": max_new_tokens})
        self._submit_meta[rid] = (self.steps, time.monotonic(), sid)
        self.sched.enqueue(req)
        self.flight.record("queue", rid=rid, step=self.steps,
                           depth=self.sched.queued)
        return rid

    def has_work(self) -> bool:
        """Requests queued, chunking, active, parked in limbo (an export
        owes its client a terminal and holds blocks) or pending, or a
        chunk in flight."""
        return bool(self._active or self.sched.queued or self._chunking
                    or self.sched.limbo or self._pending
                    or self._inflight is not None)

    def step(self) -> List[Result]:
        """Shed expired queued requests, preempt for a deadline-pressed
        head, admit what fits (one batched prefill per wave, or chunks
        within the prefill budget), then either one speculative verify
        (spec on and not suspended) or one decode chunk: dispatch it,
        retire the previous chunk (pipeline) or this one, and backfill
        the slots the retire freed; with nothing left to dispatch,
        retire the chunk in flight. Then the watchdogs and the brownout
        poll. Returns the requests that finished during this call. A
        Result already terminal when a dispatch raises stays owed and
        comes with the next call."""
        if self.failed:
            # abort_all drained everything else.
            finished, self._pending = self._pending, []
            return finished
        t0 = time.monotonic()
        self._prefill_spent = 0
        built0 = sum(self.program_counts().values())
        self._profile_window_start()
        with torch.no_grad():
            finished = self._step_impl()
        self._profile_window_advance()
        # A step that built something (a capture, the kernel libraries)
        # is slow for a reason and must not read as a wedged device.
        if sum(self.program_counts().values()) == built0:
            self.watchdog.on_step_time(time.monotonic() - t0)
        self.watchdog.check()
        if self.brownout is not None:
            self.brownout.on_step()
        return finished

    def _step_impl(self) -> List[Result]:
        # ``finished`` IS self._pending until the return detaches it: an
        # exception mid-step must not strand Results already terminal.
        finished = self._pending
        self._shed_expired(finished)
        self._maybe_preempt()
        self._admit_waves(finished)
        if self._spec is not None and not self.spec_suspended:
            if self._active:
                self._spec_step(finished)
                self._admit_waves(finished)
            self._pending = []
            return finished
        retired = False
        chunk_len = self._next_chunk() if self._active else 0
        if chunk_len:
            if self.faults is not None:
                f = self.faults.fire("slow_step", self.steps)
                if f is not None:
                    self.flight.record("fault", step=self.steps,
                                       site="slow_step", stall_s=f.stall_s)
                    time.sleep(f.stall_s)
            buf = self._dispatch(chunk_len, any(
                st.req.filters for st in self._active.values()))
            self.steps += 1
            self.host_dispatches["decode"] += 1
            # An injected poison replaces the whole chunk's readback with
            # the sentinel, as non-finite logits mid-chunk would.
            poison = (self.faults is not None
                      and self.faults.fire("nan_logits", self.steps)
                      is not None)
            if poison:
                self.flight.record("fault", step=self.steps,
                                   site="nan_logits")
            snapshot = {slot: st.req.rid
                        for slot, st in self._active.items()}
            # Opened at dispatch, closed at the retire (module docstring).
            sid = self.tracer.begin("decode_step", cat="decode",
                                    args={"step": self.steps,
                                          "rows": len(snapshot),
                                          "chunk_len": chunk_len})
            prev, self._inflight = self._inflight, (
                buf, snapshot, chunk_len, poison, sid, self.steps)
            if not self.pipeline:
                prev, self._inflight = self._inflight, None
            if prev is not None:
                self._retire(prev, finished)
                retired = True
        elif self._inflight is not None:
            # Every live row's budget is covered by computed tokens:
            # drain the lagging readback.
            prev, self._inflight = self._inflight, None
            self._retire(prev, finished)
            retired = True
        if retired:
            # The slots the retire freed backfill now; their prefill
            # queues behind the chunk in flight.
            self._admit_waves(finished)
        self._pending = []
        return finished

    def _shed_expired(self, finished: List[Result]) -> None:
        """Queued requests past their deadline, or below the brownout
        floor, become terminal 'shed' Results (a resumed victim's with
        its original prompt and salvaged tokens), counted against their
        class's attainment. Exports in migration limbo past their
        deadline are shed too, their blocks freed without donation (a
        shed must not warm the cache); the brownout floor spares them,
        their prefill being paid already."""
        if not (self.sched.queued or self.sched.limbo):
            return
        now = time.monotonic()
        meta = self._submit_meta
        floor = self.brownout_min_priority

        def expired(item) -> bool:
            if isinstance(item, _Export):
                return (item.deadline_s is not None
                        and now - item.submit_t > item.deadline_s)
            return ((item.deadline_s is not None
                     and now - meta[item.rid][1] > item.deadline_s)
                    or (floor is not None and item.priority < floor))

        for req in self.sched.drain_expired(expired):
            if isinstance(req, _Export):
                self.shed += 1
                self.block_pool.release(req.alloc, donate=False)
                prompt_out, _, _ = self._unstitch(req.req, [])
                self.flight.record(
                    "shed", rid=req.rid, step=self.steps,
                    reason="deadline", limbo=True,
                    waited_s=round(now - req.submit_t, 6),
                    deadline_s=req.deadline_s,
                    slo_class=req.req.slo_class)
                self.slo.record_shed(req.req.slo_class)
                finished.append(Result(rid=req.rid, prompt=prompt_out,
                                       tokens=[], finish_reason="shed"))
                continue
            sub_step, sub_t, sid = meta.pop(req.rid)
            self.shed += 1
            self.tracer.end(sid, {"shed": True,
                                  "wait_steps": self.steps - sub_step})
            prompt_out, tokens_out, resumed = self._unstitch(req, [])
            deadline_hit = (req.deadline_s is not None
                            and now - sub_t > req.deadline_s)
            shed_fields = {"waited_s": round(now - sub_t, 6),
                           "deadline_s": req.deadline_s,
                           "slo_class": req.slo_class,
                           "reason": ("deadline" if deadline_hit
                                      else "brownout")}
            if resumed:
                shed_fields["resumed"] = True
                shed_fields["tokens"] = len(tokens_out)
            self.flight.record("shed", rid=req.rid, step=self.steps,
                               **shed_fields)
            if req.deadline_s is not None:
                self.slo.record_shed(req.slo_class)
                if not deadline_hit:
                    self.brownout_sheds += 1
            finished.append(Result(rid=req.rid, prompt=prompt_out,
                                   tokens=tokens_out, finish_reason="shed"))

    def drain(self) -> List[Result]:
        """Run step() until queue and slots are empty."""
        out: List[Result] = []
        while self.has_work():
            out.extend(self.step())
        return out

    def warm_scan_rungs(self) -> None:
        """Dispatch every rung once (each filtered variant too) over the
        parked slot state: parked rows write to their own position 0
        (dense) or the drop block (paged), keep their frontiers, and
        their tokens are never read. Idle-only: on a busy engine the
        dispatches would advance live frontiers with no readback."""
        if self._active or self._inflight is not None:
            raise RuntimeError(
                "warm_scan_rungs on a busy engine: active rows' frontiers "
                "would advance without a readback")
        with torch.no_grad():
            for r in self.scan_rungs:
                for filtered in (False, True):
                    self._copied_wait(self._dispatch(r, filtered))

    def reset_prefix_cache(self) -> None:
        """Drop every cached prefix block back to the free list (and zero
        the hit/miss ledger). Idle-only: active requests hold references
        into the radix cache. A no-op on the dense pool."""
        if not self.paged:
            return
        if self._active or self._chunking or self.sched.limbo:
            raise RuntimeError(
                "reset_prefix_cache on a busy engine: active requests hold "
                "references into the radix cache")
        self.block_pool.reset_cache()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _suffix_bucket(self, req: Request) -> int:
        """The wave key: the bucket of the prompt minus its resident
        prefix, so requests sharing a cached prefix prefill together."""
        return self.sched.bucket_for(
            len(req.prompt) - self.block_pool.match_len(req.prompt))

    def _admit_waves(self, finished: List[Result]) -> None:
        """Admit waves until the queue, the slots, the blocks or (under
        ``prefill_chunk``) this step's prefill budget run out. The
        chunked lane goes first: its requests were popped from the
        queue's head, so they are ahead of it. Under a budget a wave is
        capped so that rung x bucket fits what is left of it; a paged
        head whose suffix bucket exceeds the budget enters the chunked
        lane, and a dense one admits alone on a fresh step."""
        budget = self.prefill_chunk
        if budget is not None and self._chunking:
            self._advance_chunked(finished)
        while True:
            max_items: Optional[int] = None
            if budget is not None:
                if self._prefill_spent >= budget:
                    return
                head = self.sched.peek_head()
                if head is None:
                    return
                if self.sched.free_slots:
                    hb = (self._suffix_bucket(head) if self.paged
                          else self.sched.bucket_for(len(head.prompt)))
                    if self.paged and hb > budget:
                        # A block-starved head fences admission (FIFO).
                        if not self._start_chunked(head):
                            return
                        self._advance_chunked(finished)
                        continue
                    remaining = budget - self._prefill_spent
                    max_items = 0
                    for r in self.admit_buckets:
                        if r * hb <= remaining:
                            max_items = r
                    if max_items == 0:
                        if self._prefill_spent:
                            return          # on the next step's budget
                        max_items = 1
            if not self.paged:
                wave = self.sched.next_admission_wave(max_items=max_items)
                if wave is None:
                    return
                reqs, slots, bucket = wave
                allocs: List[Optional[Allocation]] = [None] * len(reqs)
            else:
                allocs = []

                def try_alloc(req: Request) -> bool:
                    a = self._try_alloc(req)
                    if a is not None:
                        allocs.append(a)
                    return a is not None

                wave = self.sched.next_admission_wave(
                    max_items=max_items, bucket_of=self._suffix_bucket,
                    admit=try_alloc)
                if wave is None:
                    return
                reqs, slots, bucket = wave
            k = self.sched.rung_for(len(reqs))
            if budget is not None:
                self._prefill_spent += k * bucket
            # Until the commit the wave is in limbo (popped, slots and
            # blocks taken, not active): recover() requeues it from here.
            self._admitting = [(req, slot, a, True) for req, slot, a
                               in zip(reqs, slots, allocs)]
            wave_sid = self.tracer.begin(
                "prefill_wave", cat="prefill",
                args={"bucket": bucket, "rung": k, "wave": len(reqs),
                      "rids": [r.rid for r in reqs]})
            self._admitting_span = wave_sid
            self._raise_prefill_exc(rids=[r.rid for r in reqs])
            self._prefill_wave(reqs, slots, allocs, bucket, finished)
            self._admitting_span = None
            self.tracer.end(wave_sid)

    def _try_alloc(self, req: Request) -> Optional[Allocation]:
        """Reserve one request's blocks, or None (it stays queued). The
        alloc_fail site forces None, counted as a stall step, as a real
        exhaustion is."""
        if (self.faults is not None
                and self.faults.fire("alloc_fail", self.steps) is not None):
            self.block_pool.stall_steps += 1
            self.flight.record("fault", rid=req.rid, step=self.steps,
                               site="alloc_fail")
            return None
        # A migrate-flagged request reserves its prompt's chain only: the
        # generation budget belongs to the adopting engine.
        max_new = 0 if req.rid in self._migrate_rids else req.max_new_tokens
        a = self.block_pool.admit(req.prompt, max_new)
        if a is None:
            self.flight.record(
                "block_stall", rid=req.rid, step=self.steps,
                need=self.block_pool.blocks_needed(len(req.prompt), max_new),
                free=self.block_pool.free_blocks)
            return None
        self.flight.record("block_reserve", rid=req.rid, step=self.steps,
                           blocks=len(a.table), hit_blocks=a.n_hit)
        return a

    def _start_chunked(self, head: Request) -> bool:
        """Claim the queue head into the chunked lane: its blocks (the
        full reservation) and a slot, no device work yet. False when the
        pool cannot cover it: the head stays queued."""
        alloc = self._try_alloc(head)
        if alloc is None:
            return False
        popped = self.sched.pop_head()
        assert popped is head
        self._chunking.append(_Chunking(
            req=head, slot=self.sched.take_slot(), alloc=alloc,
            hit=alloc.n_hit * self.kv_page_size))
        return True

    def _advance_chunked(self, finished: List[Result]) -> None:
        """Prefill pieces of the chunked lane's requests, oldest first,
        until this step's budget is spent. A piece is sized to what is
        left of the budget and padded to its bucket; one whose bucket
        would overshoot waits for the next step (whose fresh budget fits
        a whole piece: prefill_chunk is a bucket). The last piece of a
        request samples its first token and commits it (_prefill_wave
        from the piece's start)."""
        budget = self.prefill_chunk
        page = self.kv_page_size
        for entry in list(self._chunking):
            req, alloc = entry.req, entry.alloc
            while self._prefill_spent < budget:
                remaining = len(req.prompt) - entry.hit - entry.done
                c = min(remaining, budget - self._prefill_spent)
                bucket = self.sched.bucket_for(c)
                if bucket > budget - self._prefill_spent:
                    return
                start = entry.hit + entry.done
                # The padding past start + c lands in private blocks or
                # the drop block, never in the shared prefix.
                assert start >= alloc.n_hit * page, (start, alloc.n_hit)
                self._raise_prefill_exc(rid=req.rid)
                if c < remaining:
                    self._prefill_piece(req.prompt[start:start + c], start,
                                        alloc, bucket)
                    self._prefill_spent += bucket
                    self.prefill_chunks += 1
                    entry.done += c
                    self._record_chunk(entry, c)
                    continue
                self._prefill_spent += bucket
                self.prefill_chunks += 1
                entry.done += c
                self._record_chunk(entry, c)
                self._chunking.remove(entry)
                # A half-written chain: never donated if this raises.
                self._admitting = [(req, entry.slot, alloc, False)]
                self._prefill_wave([req], [entry.slot], [alloc], bucket,
                                   finished, start=start)
                break
            else:
                return          # budget spent; later entries wait

    def _prefill_piece(self, tokens: Sequence[int], start: int,
                       alloc: Allocation, bucket: int) -> None:
        """An intermediate piece of a chunked prefill: one row's tokens at
        positions [start, start + len) written through its chain, padded
        to ``bucket``; nothing is sampled and no slot state changes."""
        row = np.zeros((1, bucket), np.int64)
        row[0, :len(tokens)] = tokens
        table = np.full((1, self.slot_blocks), self.kv_pool_blocks, np.int32)
        table[0, :len(alloc.table)] = alloc.table
        d_row, d_table = self._to_dev(row), self._to_dev(table)
        d_start = self._to_dev(np.array([start], np.int32))
        self.model.hidden(d_row, cache=self._pool, cache_index=d_start,
                          block_table=d_table)
        if self._device_drafter():
            self._spec.drafter.prefill(d_row, cache_index=d_start,
                                       block_table=d_table)

    def _device_drafter(self) -> bool:
        return self._spec is not None and self._spec.drafter.kind == "device"

    def _record_chunk(self, entry: _Chunking, c: int) -> None:
        self.flight.record("prefill_chunk", rid=entry.req.rid,
                           step=self.steps, n=c,
                           prefilled=entry.hit + entry.done,
                           of=len(entry.req.prompt))

    def _raise_prefill_exc(self, **fields) -> None:
        """The prefill_exc site: a prefill dispatch that raises (its
        'fault' event carries the wave's rids, or the chunk's rid)."""
        if (self.faults is not None
                and self.faults.fire("prefill_exc", self.steps) is not None):
            self.flight.record("fault", step=self.steps, site="prefill_exc",
                               **fields)
            raise FaultInjected("prefill_exc", self.steps)

    def _prefill_wave(self, reqs: List[Request], slots: List[int],
                      allocs: List[Optional[Allocation]], bucket: int,
                      finished: List[Result],
                      start: Optional[int] = None) -> None:
        """One (rung, bucket) prefill forward — against the paged pool
        from each row's prefix hit on, or into a dense temp cache whose
        first n rows are scattered onto the wave's slots (module
        docstring) — then first tokens sampled from each row's last true
        position with the (seed, true_len) key the decode stream
        continues from. ``start`` makes it the last piece of a chunked
        prefill (one paged row, from that position)."""
        k, n = self.sched.rung_for(len(reqs)), len(reqs)
        page = self.kv_page_size
        tokens = np.zeros((k, bucket), np.int64)
        tables = np.full((k, self.slot_blocks), self.kv_pool_blocks,
                         np.int32)
        hits = np.zeros(k, np.int32)
        true_lens = np.ones(k, np.int32)      # padding rows: one token
        seeds = np.zeros(k, np.int64)
        temps = np.zeros(k, np.float32)
        top_ks = np.zeros(k, np.int64)
        top_ps = np.ones(k, np.float32)
        for i, (req, a) in enumerate(zip(reqs, allocs)):
            hit = (start if start is not None
                   else a.n_hit * page if a is not None else 0)
            sfx = req.prompt[hit:]
            tokens[i, :len(sfx)] = sfx
            if a is not None:
                tables[i, :len(a.table)] = a.table
            hits[i], true_lens[i] = hit, len(req.prompt)
            seeds[i], temps[i] = req.seed, req.temperature
            top_ks[i], top_ps[i] = req.top_k, req.top_p
        d_hits, d_true = self._to_dev(hits), self._to_dev(true_lens)
        d_seeds, d_temps = self._to_dev(seeds), self._to_dev(temps)
        d_topk, d_topp = self._to_dev(top_ks), self._to_dev(top_ps)
        d_tokens = self._to_dev(tokens)
        d_tables = None
        d_slots = torch.tensor(slots, device=self.device)
        if self.paged:
            d_tables = self._to_dev(tables)
            h = self.model.hidden(d_tokens, cache=self._pool,
                                  cache_index=d_hits, block_table=d_tables)
        else:
            temp = init_cache(self.cfg, k, bucket, device=self.device,
                              tp=self.tp)
            h = self.model.hidden(d_tokens, cache=temp, cache_index=0)
            for pool, rows in zip(pool_shards(self._pool, self.tp),
                                  pool_shards(temp, self.tp)):
                scatter_cache_rows(pool, [tuple(x[:n] for x in layer)
                                          for layer in rows], d_slots)
            del temp
        if self._device_drafter():
            # The drafter's pool takes the same wave (paged: through the
            # same tables, so a prefix hit skips its prefix too).
            self._spec.drafter.prefill(d_tokens, cache_index=d_hits,
                                       block_table=d_tables, slots=d_slots,
                                       n=n)
        rows = torch.arange(k, device=self.device)
        logits = self.model.head(h[rows, (d_true - d_hits - 1).long()])
        toks = sample_token_rows(
            logits, seeds=d_seeds, positions=d_true, temperature=d_temps,
            top_k=d_topk, top_p=d_topp,
            filtered=any(r.filters for r in reqs))
        ok = torch.isfinite(logits).all(dim=-1)
        # First tokens go device-to-device into the slot state; the host
        # copy is for results and finish checks. A non-finite row's token
        # becomes the out-of-vocab sentinel on the host side only.
        idx = torch.tensor(slots, device=self.device)
        self._pos[idx] = d_true[:n]
        self._tok[idx] = torch.where(ok, toks, 0)[:n]
        self._temp[idx] = d_temps[:n]
        self._topk[idx] = d_topk[:n]
        self._topp[idx] = d_topp[:n]
        self._seed[idx] = d_seeds[:n]
        if self.paged:
            self._table[idx] = d_tables[:n]
        self._live[idx] = True
        host = _tracecheck.host_sync(
            "admit-readback",
            torch.where(ok, toks, self.cfg.vocab_size)).tolist()
        if (self.faults is not None
                and self.faults.fire("scatter_corrupt", self.steps)
                is not None):
            # A corrupted admission surfaces as sentinel first tokens at
            # the wave's readback.
            self.flight.record("fault", step=self.steps,
                               site="scatter_corrupt")
            host = [self.cfg.vocab_size] * k
        if start is None:
            self.waves += 1
            self._c_waves.inc()
        now = time.monotonic()
        self._rate.append((now, n))
        poisoned = False
        rung = k if start is None else 1
        for i, (req, slot, a) in enumerate(zip(reqs, slots, allocs)):
            poisoned |= self._commit_admission(req, slot, a, host[i], now,
                                               finished, bucket=bucket,
                                               rung=rung)
        self._admitting = []
        if poisoned:
            self._mark_poison("poisoned_prefill",
                              rids=[r.rid for r in reqs])

    def _commit_admission(self, req: Request, slot: int,
                          alloc: Optional[Allocation],
                          first_tok: int, now: float,
                          finished: List[Result], *, bucket: int,
                          rung: int) -> bool:
        """The row goes active with its first token, or a migrate-flagged
        one exports (module docstring); returns whether the token was the
        sentinel (the row then goes active with no token, and the caller
        marks the wave poisoned)."""
        self.admitted += 1
        poisoned = not 0 <= first_tok < self.cfg.vocab_size
        if not poisoned:
            self.tokens_generated += 1
        resumed = req.rid in self._resumed
        sub_step, sub_t, queued_sid = self._submit_meta.pop(req.rid)
        wait = self.steps - sub_step
        self._queue_wait.observe(wait)
        # A resumed request's first token came before its preemption or
        # recovery, and a poisoned one never reached the client.
        if not resumed and not poisoned:
            self._ttft.observe(now - sub_t)
            self.watchdog.on_ttft(now - sub_t)
        hit_toks = alloc.n_hit * self.kv_page_size if alloc is not None \
            else 0
        if (self.paged and self.block_pool.cache is not None
                and not resumed and not poisoned):
            self._ttft_prefix.labels(
                prefix="hit" if hit_toks else "miss").observe(now - sub_t)
        self.tracer.end(queued_sid, {"wait_steps": wait})
        self.flight.record("admit", rid=req.rid, step=self.steps, slot=slot,
                           bucket=bucket, rung=rung, wait_steps=wait)
        self.flight.record("prefill", rid=req.rid, step=self.steps,
                           prefix="hit" if hit_toks else "miss",
                           hit_tokens=hit_toks,
                           suffix_tokens=len(req.prompt) - hit_toks)
        if req.rid in self._migrate_rids:
            self._migrate_rids.discard(req.rid)
            finishes_here = (
                poisoned or req.max_new_tokens <= 1
                or (req.eos_id is not None and first_tok == req.eos_id))
            if not finishes_here and alloc is not None:
                # Export: the prompt's K/V is written and the first token
                # is in hand. The slot is parked now, host and device
                # (behind the chunk in flight, which never saw it live),
                # so the row never decodes here and the chain is never
                # written again. A poisoned or finishing first token
                # stays colocated below.
                self.sched.release(slot)
                self._release_row(slot)
                self.sched.park_limbo(_Export(
                    req=req, alloc=alloc, first_tok=first_tok,
                    export_t=now, submit_t=sub_t, submit_step=sub_step))
                self.flight.record("export", rid=req.rid, step=self.steps,
                                   chain_blocks=len(alloc.table),
                                   hit_blocks=alloc.n_hit,
                                   prompt_len=len(req.prompt))
                return False
        span = self.tracer.begin("generate", cat="request", rid=req.rid,
                                 args={"slot": slot, "bucket": bucket})
        st = _Active(req=req, slot=slot, alloc=alloc, submit_t=sub_t,
                     first_token_t=now, last_t=now, span=span)
        self._active[slot] = st
        if poisoned:
            return True
        st.tokens.append(first_tok)
        done = self._maybe_finish(st)
        if done is not None:
            finished.append(done)
        return False

    # ------------------------------------------------------------------
    # preemption (module docstring)
    # ------------------------------------------------------------------
    def _head_blocks_available(self, head: Request) -> bool:
        """Could the head's reservation be covered now (free plus
        evictable blocks, less its prefix hit)? A probe; nothing
        commits."""
        need = self.block_pool.blocks_needed(len(head.prompt),
                                             head.max_new_tokens)
        hit_blocks = self.block_pool.match_len(head.prompt) \
            // self.kv_page_size
        avail = self.block_pool.free_blocks
        if self.block_pool.cache is not None:
            avail += self.block_pool.cache.evictable()
        return need - hit_blocks <= avail

    def _steps_per_s(self) -> Optional[float]:
        """Recent entries of the rate ring a second (admission waves and
        retires: the unit queue waits are counted in), or None while the
        signal is cold. Read by the retry-after hint."""
        ring = list(self._rate)
        if len(ring) < 2:
            return None
        dt = ring[-1][0] - ring[0][0]
        if dt <= 0:
            return None
        return (len(ring) - 1) / dt

    def _projected_slot_free_s(self) -> Optional[float]:
        """Seconds until a slot frees by itself: the smallest remaining
        budget of an active row over the recent tokens a second of one
        row. None while the signal is cold."""
        rate = self._recent_rate()
        if rate is None or rate <= 0 or not self._active:
            return None
        per_row = rate / len(self._active)
        min_rem = min(st.req.max_new_tokens - len(st.tokens)
                      for st in self._active.values())
        return max(0, min_rem) / per_row

    def _maybe_preempt(self) -> None:
        """At most one preemption a step: evict the lowest-priority
        active row when the queue head has a deadline, is blocked on
        slots or blocks, and its slack no longer covers the projected
        wait for a slot to free by itself (with a cold rate signal: once
        it has waited half its deadline). A head past its deadline is
        not saved (it sheds); equal priorities never preempt. Also the
        preempt_storm site, which skips the policy and evicts the
        lowest-priority active row (the earliest admitted among
        equals)."""
        if self.faults is not None and self._active:
            f = self.faults.fire("preempt_storm", self.steps)
            if f is not None:
                victim = min(self._active.values(),
                             key=lambda st: (st.req.priority, st.req.rid))
                self.flight.record("fault", rid=victim.req.rid,
                                   step=self.steps, site="preempt_storm")
                self._preempt(victim, cause="preempt_storm")
        if not self.preemption or not self._active:
            return
        head = self.sched.peek_head()
        if head is None or head.deadline_s is None:
            return
        if self.sched.free_slots and (
                self.block_pool is None
                or self._head_blocks_available(head)):
            return
        waited = time.monotonic() - self._submit_meta[head.rid][1]
        slack = head.deadline_s - waited
        if slack <= 0:
            return
        proj = self._projected_slot_free_s()
        if proj is not None:
            if slack > proj:
                return
        elif waited < 0.5 * head.deadline_s:
            return
        victims = [st for st in self._active.values()
                   if st.req.priority < head.priority]
        if not victims:
            return
        # Lowest priority first; among equals the latest admission (the
        # least work lost, the shortest re-prefill).
        self._preempt(min(victims, key=lambda st: (st.req.priority,
                                                   -st.req.rid)),
                      cause="deadline")

    def _preempt(self, st: _Active, cause: str = "deadline") -> None:
        """Evict one active request: park its slot, donate its prompt and
        generated blocks to the prefix cache, and requeue it at the head
        of its class with prompt' = prompt + tokens (module docstring).
        Not a terminal: its Result comes when the resume finishes or
        sheds."""
        req = st.req
        del self._active[st.slot]
        self.sched.release(st.slot)
        if self._inflight is not None:
            # The chunk in flight's tokens for this slot belong to nobody
            # now: a resume in the same slot must not take them (the
            # resume recomputes them, sampling being keyed by position).
            self._inflight[1].pop(st.slot, None)
        self._release_row(st.slot)
        donated = 0
        if st.alloc is not None:
            donated = self.block_pool.release(st.alloc, generated=st.tokens)
        base = self._resumed.get(req.rid)
        pre = (base.tokens if base is not None else []) + st.tokens
        self._resumed[req.rid] = _Resume(
            prompt=base.prompt if base is not None else req.prompt,
            tokens=pre)
        self.tracer.end(st.span, {"preempted": True, "cause": cause})
        sid = self.tracer.begin("queued", cat="request", rid=req.rid,
                                args={"preempted": True})
        self._submit_meta[req.rid] = (self.steps, st.submit_t, sid)
        self.preemptions += 1
        self.flight.record("preempt", rid=req.rid, step=self.steps,
                           cause=cause, slot=st.slot,
                           salvaged_tokens=len(pre), donated_blocks=donated,
                           priority=req.priority)
        self.sched.requeue_front([replace(
            req, prompt=req.prompt + tuple(st.tokens),
            max_new_tokens=req.max_new_tokens - len(st.tokens))])

    def _unstitch(self, req: Request,
                  tokens: Sequence[int]) -> Tuple[tuple, List[int], bool]:
        """A terminal's (prompt, tokens, resumed): a preempted request
        reports its original prompt and the tokens of every incarnation.
        Pops the record, which must not outlive the request."""
        res = self._resumed.pop(req.rid, None)
        if res is None:
            return req.prompt, list(tokens), False
        return res.prompt, res.tokens + list(tokens), True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _next_chunk(self) -> int:
        """The next dispatch's chunk length from scan_rungs, or 0 when
        every live row's budget is already covered by computed tokens
        (read back, or in the chunk in flight). The rung maximises useful
        lane steps per unit of time, sum_rows min(remaining, r) /
        (scan_dispatch_cost_steps + r), ties to the larger rung (JAX's
        policy). Under brownout (``scan_cap``) only the rungs up to the
        cap are taken: graphs already captured. Chunks are dispatch
        boundaries, not sampling state: the choice never changes a
        token."""
        snapshot, ahead = ((self._inflight[1], self._inflight[2])
                           if self._inflight is not None else ({}, 0))
        rems = []
        for slot, st in self._active.items():
            rem = st.req.max_new_tokens - len(st.tokens)
            if snapshot.get(slot) == st.req.rid:
                rem -= ahead
            if rem > 0:
                rems.append(rem)
        if not rems:
            return 0
        rungs = self.scan_rungs
        if self.scan_cap is not None:
            rungs = [r for r in rungs if r <= self.scan_cap] or rungs[:1]
        cost = self.scan_dispatch_cost_steps
        best, best_score = 1, -1.0
        for r in rungs:
            score = sum(min(rem, r) for rem in rems) / (cost + r)
            if score >= best_score:
                best, best_score = r, score
        return best

    def _steps(self, k: int, filtered: bool) -> None:
        """k decode steps for every slot at its own frontier, on the
        device alone: step j's tokens (the out-of-vocab sentinel for a row
        whose logits are not finite) go to row j of the chunk buffer;
        live rows advance and take their token as the next input (a
        poisoned row keeps its input, in range for the embedding). What a
        CUDA graph of the chunk captures."""
        for j in range(k):
            logits = self.model(self._tok[:, None], cache=self._pool,
                                cache_index=self._pos,
                                block_table=self._table)[:, 0]
            nxt = sample_token_rows(
                logits, seeds=self._seed, positions=self._pos + 1,
                temperature=self._temp, top_k=self._topk, top_p=self._topp,
                filtered=filtered)
            ok = torch.isfinite(logits).all(dim=-1)
            self._chunk_toks[j].copy_(torch.where(ok, nxt,
                                                  self.cfg.vocab_size))
            self._tok.copy_(torch.where(self._live & ok, nxt, self._tok))
            self._pos += self._live.int()

    def _capture_graphs(self) -> None:
        """Capture every (rung, filtered) chunk over the parked slot state,
        after one eager step of each variant on the capture stream (the
        libraries' first-call setup: cuBLAS's workspace, the sort's).
        Records each capture's kernel launches and plain-version calls
        (the wrappers' counts, which a replay does not tick) and the bytes
        the captures reserved. A capture that fails raises.

        Python's cyclic collector is run first and kept off while the
        captures run: a dropped engine waiting in a reference cycle,
        finalised inside a capture, frees pinned buffers, events and
        graphs, and those CUDA calls invalidate the capture (torch no
        longer collects on entering torch.cuda.graph)."""
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._capture_all()
        finally:
            if collecting:
                gc.enable()

    def _capture_all(self) -> None:
        """_capture_graphs' body, with the collector off."""
        dev = self._tok.device
        # The decode kernels' ticket buffer the captures point at (a
        # ModelDrafter's draft steps share it: sized for the wider).
        heads = self.cfg.n_head
        drafter = self._spec.drafter if self._spec is not None else None
        if drafter is not None and drafter.kind == "device":
            heads = max(heads, drafter.model.cfg.n_head)
        self._tickets = fd.ticket_counters(dev, self.num_slots * heads)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        programs = self._program_bodies()
        with torch.no_grad():
            with torch.cuda.stream(stream):
                for filtered in (False, True):
                    self._steps(1, filtered)
                for kind in ("verify", "draft"):
                    for body in programs.get(kind, {}).values():
                        body()
            torch.cuda.current_stream(dev).wait_stream(stream)
            pool = torch.cuda.graph_pool_handle()
            for kind, group in programs.items():
                graphs = self._graphs if kind == "decode" else (
                    self._spec_graphs)
                for key, body in group.items():
                    self.tracecheck.bump(kind)
                    before = _wrapper_counts()
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        body()
                    graphs[key] = graph
                    self.graph_replays[key] = 0
                    self.graph_launches[key], self.graph_plain_calls[key] = (
                        {name: n - b[name] for name, n in a.items()
                         if n > b[name]}
                        for a, b in zip(_wrapper_counts(), before))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def _draft_steps(self) -> None:
        """The ModelDrafter's k+1 draft steps from the slot state (what
        its graph captures)."""
        self._spec.drafter.steps(self._tok, self._pos, self._live,
                                 self._table)

    def _run_spec(self, key: tuple, body) -> None:
        """One spec graph replay on CUDA (counted), the body on the CPU."""
        if self._replay:
            self._spec_graphs[key].replay()
            self.graph_replays[key] += 1
        else:
            body()

    def _dispatch(self, k: int, filtered: bool) -> int:
        """Run one chunk of k steps (one graph replay on CUDA) and start
        its tokens' copy into the next host buffer; returns the buffer's
        index, which _copied_wait waits on."""
        if self._replay:
            self._graphs[(k, filtered)].replay()
            self.graph_replays[(k, filtered)] += 1
        else:
            self._steps(k, filtered)
        self.chunk_steps += k
        i = self._next_buf
        self._next_buf ^= 1
        self._host_toks[i][:k].copy_(self._chunk_toks[:k], non_blocking=True)
        if self._copied[i] is not None:
            self._copied[i].record()
        return i

    def _copied_wait(self, i: int) -> torch.Tensor:
        """Host buffer i once the copy into it is done (this chunk's
        event only: work queued behind it keeps running): the decode
        chunk's one readback, 'decode-readback' in the sync ledger."""
        _tracecheck.host_sync("decode-readback", self._copied[i])
        return self._host_toks[i]

    def _retire(self, inflight: tuple, finished: List[Result]) -> None:
        """Read one dispatched chunk's tokens back and apply the lagged
        finish decisions. A slot whose occupant changed since dispatch
        (its request finished and the slot was reused) is skipped: its
        tokens belong to nobody. A live row walks its chunk in order and
        stops at the first of: its budget reached (the surplus is
        dropped), eos (kept, then nothing after it), or the out-of-vocab
        sentinel (the clean tokens before it are kept, the step is
        marked poisoned, and a row poisoned POISON_STRIKE_LIMIT times in
        a row ends 'failed')."""
        i, snapshot, k, poison, sid, chunk = inflight
        toks = self._copied_wait(i)[:k].tolist()
        vocab = self.cfg.vocab_size
        if poison:
            toks = [[vocab] * self.num_slots for _ in toks]
        now = time.monotonic()
        n_live = 0
        poisoned_slots: List[int] = []
        for slot, rid in snapshot.items():
            st = self._active.get(slot)
            if st is None or st.req.rid != rid:
                continue
            kept = 0
            poisoned = False
            for row in toks:
                if len(st.tokens) >= st.req.max_new_tokens:
                    break
                tok = row[slot]
                if not 0 <= tok < vocab:
                    poisoned = True
                    break
                st.tokens.append(tok)
                kept += 1
                if st.req.eos_id is not None and tok == st.req.eos_id:
                    break
            if kept:
                st.last_t = now
                n_live += kept
                # One event a retired (row, chunk), n tokens at once.
                ev = {"rid": rid, "step": self.steps, "n": kept}
                if self.scan_k > 1:
                    ev["chunk"] = chunk
                self.flight.record("retire", **ev)
            if poisoned:
                self._strike(st, slot, poisoned_slots, finished)
                continue
            if kept:
                st.poison_strikes = 0
                done = self._maybe_finish(st)
                if done is not None:
                    finished.append(done)
        if poisoned_slots:
            self._mark_poison("poisoned_step", slots=poisoned_slots)
        self.tokens_generated += n_live
        self._rate.append((now, n_live))
        self.tracer.end(sid, {"live_tokens": n_live})

    def _strike(self, st: _Active, slot: int, poisoned_slots: List[int],
                finished: List[Result]) -> None:
        """A poisoned readback of one row: counted toward the step's
        poison mark, and past POISON_STRIKE_LIMIT in a row the row ends
        'failed' (nobody is recovering)."""
        poisoned_slots.append(slot)
        st.poison_strikes += 1
        if st.poison_strikes >= POISON_STRIKE_LIMIT:
            finished.append(self._finish(st, "failed",
                                         cause="persistent_poison"))

    def _maybe_finish(self, st: _Active) -> Optional[Result]:
        req = st.req
        if not st.tokens:
            return None
        if req.eos_id is not None and st.tokens[-1] == req.eos_id:
            return self._finish(st, "eos")
        if len(st.tokens) >= req.max_new_tokens:
            return self._finish(st, "length")
        return None

    def _finish(self, st: _Active, reason: str,
                cause: Optional[str] = None) -> Result:
        """Release the slot (host and device) and the blocks — donating
        the full prompt blocks to the prefix cache unless the row failed
        — and account the terminal: a preempted request's Result carries
        its original prompt and all of its tokens; a deadline-carrying
        one lands in the SLO ledger (a failed row as shed). A finish
        leaves 'evict' and 'finish' events, a failed row (``cause``) one
        'failed' event."""
        now = time.monotonic()
        req = st.req
        del self._active[st.slot]
        self.sched.release(st.slot)
        failed = reason == "failed"
        if not failed:
            self.flight.record("evict", rid=req.rid, step=self.steps,
                               slot=st.slot)
        self._release_row(st.slot)
        digest: tuple = ()
        if self.paged:
            self.block_pool.release(st.alloc, donate=not failed)
        if not failed and self.paged and self.block_pool.cache is not None:
            digest = tuple(prefix_digests(req.prompt, self.kv_page_size))
        self.completed += 1
        self._c_completed.labels(reason=reason).inc()
        prompt_out, tokens_out, resumed = self._unstitch(req, st.tokens)
        if failed:
            if req.deadline_s is not None:
                self.slo.record_shed(req.slo_class)
            self.tracer.end(st.span, {"failed": True, "cause": cause})
            self.flight.record("failed", rid=req.rid, step=self.steps,
                               cause=cause, tokens=len(tokens_out))
        else:
            self.tracer.end(st.span, {"tokens": len(tokens_out),
                                      "finish_reason": reason})
            elapsed = now - st.submit_t
            met = self.slo.record_finish(
                req.slo_class, tokens=len(tokens_out), elapsed_s=elapsed,
                deadline_s=req.deadline_s,
                prefix="hit" if st.alloc is not None and st.alloc.n_hit
                else "miss")
            fin = {"reason": reason, "tokens": len(tokens_out),
                   "e2e_s": round(elapsed, 6)}
            if resumed:
                fin["resumed"] = True
            if met is not None:
                fin["deadline_met"] = met
            if digest:
                fin["prefix_digest"] = list(digest)
            self.flight.record("finish", rid=req.rid, step=self.steps, **fin)
            if self._spec is not None:
                self._spec_req_accepted.observe(st.spec_accepted)
            if len(st.tokens) > 1:
                self._tpot.observe((now - st.first_token_t)
                                   / (len(st.tokens) - 1))
        return Result(rid=req.rid, prompt=prompt_out, tokens=tokens_out,
                      finish_reason=reason, prefix_digest=digest)

    # ------------------------------------------------------------------
    # speculative decoding (module docstring)
    # ------------------------------------------------------------------
    def _spec_step(self, finished: List[Result]) -> None:
        """One speculative round: the drafts (host prompt lookup, or the
        ModelDrafter's draft steps), one verify over every slot, and the
        retire of each live row's accepted prefix plus its fresh token,
        truncated at an eos inside it. Drafts are capped at the row's
        remaining budget - 1: the verify always emits accepted + 1
        tokens, so a row never overshoots max_new_tokens. A drafter
        that raises degrades the step to a verify of no drafts (plain
        decode); spec_fault_tolerance of them in a row disable spec."""
        runner = self._spec
        k, drafter = runner.k, runner.drafter
        verify_sid = self.tracer.begin(
            "spec_verify", cat="spec",
            args={"k": k, "rows": len(self._active)})
        caps = {slot: min(k, st.req.max_new_tokens - len(st.tokens) - 1)
                for slot, st in self._active.items()}
        dl = np.zeros(self.num_slots, np.int64)
        drafts: Optional[np.ndarray] = np.zeros((self.num_slots, k),
                                                np.int64)
        try:
            if (self.faults is not None
                    and self.faults.fire("drafter_fault", self.steps)
                    is not None):
                raise FaultInjected("drafter_fault", self.steps)
            if drafter.kind == "host":
                for slot, st in self._active.items():
                    if caps[slot] <= 0:
                        continue
                    prop = drafter.propose(list(st.req.prompt) + st.tokens,
                                           caps[slot])
                    dl[slot] = len(prop)
                    drafts[slot, :len(prop)] = prop
            else:
                self._run_spec(("draft",), self._draft_steps)
                drafts = None
                for slot, cap in caps.items():
                    dl[slot] = max(cap, 0)
        except Exception as e:
            self.drafter_faults += 1
            self._drafter_fault_streak += 1
            dl[:] = 0
            drafts = np.zeros((self.num_slots, k), np.int64)
            self.flight.record("drafter_fault", step=self.steps,
                               error=f"{type(e).__name__}: {e}",
                               streak=self._drafter_fault_streak)
            if self._drafter_fault_streak >= self.spec_fault_tolerance:
                self._disable_spec(
                    f"{self._drafter_fault_streak} consecutive drafter "
                    f"faults (last: {type(e).__name__}: {e})")
        else:
            self._drafter_fault_streak = 0
        runner.load(drafts, dl)
        sampled = any(st.req.temperature > 0
                      for st in self._active.values())
        self._run_spec(("verify", sampled), lambda: runner.body(sampled))
        self.steps += 1
        self.host_dispatches["verify"] += 1
        runner.steps += 1
        out = runner.readback()
        emitted, counts, acc_host = out[:, :k + 1], out[:, k + 1], \
            out[:, k + 2]
        if (self.faults is not None
                and self.faults.fire("nan_logits", self.steps) is not None):
            self.flight.record("fault", step=self.steps, site="nan_logits")
            emitted = np.full_like(emitted, self.cfg.vocab_size)
        now = time.monotonic()
        n_kept = 0
        poisoned_slots: List[int] = []
        for slot, st in list(self._active.items()):
            c = int(counts[slot])
            if c <= 0:
                continue
            acc = int(acc_host[slot])
            toks = emitted[slot, :c].tolist()
            if any(not 0 <= t < self.cfg.vocab_size for t in toks):
                self._strike(st, slot, poisoned_slots, finished)
                continue
            if dl[slot] > 0:
                runner.drafted += int(dl[slot])
                runner.accepted += acc
                self._spec_accept_len.observe(acc)
                st.spec_accepted += acc
            if st.req.eos_id is not None and st.req.eos_id in toks:
                toks = toks[:toks.index(st.req.eos_id) + 1]
            st.tokens.extend(toks)
            st.poison_strikes = 0
            st.last_t = now
            self.flight.record("retire", rid=st.req.rid, step=self.steps,
                               n=len(toks), accepted=acc)
            n_kept += len(toks)
            done = self._maybe_finish(st)
            if done is not None:
                finished.append(done)
        if poisoned_slots:
            self._mark_poison("poisoned_step", slots=poisoned_slots)
        self.tokens_generated += n_kept
        self._rate.append((now, n_kept))
        self.tracer.end(verify_sid, {"emitted": n_kept,
                                     "drafted": int(dl.sum()),
                                     "accepted": int(acc_host.sum())})

    def _disable_spec(self, reason: str) -> None:
        """Drop to plain decode for the engine's life (outputs unchanged:
        greedy spec is greedy plain decode)."""
        self.spec_disabled_reason = reason
        self._spec = None
        self.flight.record("spec_disabled", step=self.steps, reason=reason)
        warn_once("serve-spec-disabled",
                  f"[serve] speculative decoding DISABLED: {reason}; "
                  "continuing with plain decode")

    # ------------------------------------------------------------------
    # fault detection, quarantine and recovery (module docstring; the
    # policy is serve/recovery.py's)
    # ------------------------------------------------------------------
    def _mark_poison(self, kind: str, **info) -> None:
        """Latch a poisoned step until take_poison: its outputs were
        discarded and the supervisor should recover before the next
        dispatch."""
        self.poisoned_steps += 1
        if self._poison is None:
            self._poison = {"kind": kind, "step": self.steps, **info}
        self.flight.record("poison", step=self.steps, kind=kind, **info)

    def take_poison(self) -> Optional[dict]:
        """The supervisor's check after a step: returns and clears the
        latched poison, if any."""
        poison, self._poison = self._poison, None
        return poison

    def quarantine(self, cause: str) -> None:
        """Readiness goes red until recover()."""
        self.quarantined = True
        self.quarantine_cause = cause
        self.flight.record("quarantine", step=self.steps, cause=cause)

    def _close_dangling_spans(self) -> None:
        """End the spans a raise left open (the chunk in flight's
        'decode_step', a mid-prefill wave's 'prefill_wave'), so the
        tracer's open table cannot grow across recoveries."""
        if self._inflight is not None:
            self.tracer.end(self._inflight[4], {"aborted": True})
        if self._admitting_span is not None:
            self.tracer.end(self._admitting_span, {"aborted": True})
            self._admitting_span = None

    def recover(self, cause: str = "unknown", *,
                flush_cache: bool = False) -> dict:
        """Reset the device state in place (_reset_device_state) and
        requeue every request in flight at the head of its class, in rid
        order: an active one with prompt' = prompt + its tokens and the
        remaining budget (its prompt blocks donated, so the resume is a
        prefix hit); a wave caught mid-prefill and a chunked prefill as
        they were (a chunk's half-written chain freed without donation).
        Sampling keyed by position makes greedy resumes token-identical.
        ``flush_cache`` (a dispatch raised: buffers suspect) also drops
        the prefix cache and zeroes the pools."""
        t0 = time.monotonic()
        self._close_dangling_spans()
        self._inflight = None
        self._poison = None
        actives = sorted(self._active.values(), key=lambda s: s.req.rid)
        active_rids = {st.req.rid for st in actives}
        # A raise inside the commit loop leaves the committed part of the
        # wave in both _active and _admitting: _active owns it.
        admitting = [e for e in self._admitting
                     if e[0].rid not in active_rids]
        self._active = {}
        self._admitting = []

        def done_before(req: Request) -> int:
            base = self._resumed.get(req.rid)
            return len(base.tokens) if base is not None else 0

        # (request, tokens done before, submit time or None)
        requeue: List[Tuple[Request, int, Optional[float]]] = []
        for st in actives:
            self.sched.release(st.slot)
            if st.alloc is not None:
                self.block_pool.release(st.alloc)
            self.tracer.end(st.span, {"recovered": True})
            base = self._resumed.get(st.req.rid)
            pre = (base.tokens if base is not None else []) + st.tokens
            self._resumed[st.req.rid] = _Resume(
                prompt=base.prompt if base is not None else st.req.prompt,
                tokens=pre)
            requeue.append((replace(
                st.req, prompt=st.req.prompt + tuple(st.tokens),
                max_new_tokens=st.req.max_new_tokens - len(st.tokens)),
                len(pre), st.submit_t))
        for req, slot, alloc, donate in admitting:
            self.sched.release(slot)
            if alloc is not None:
                self.block_pool.release(alloc, donate=donate)
            requeue.append((req, done_before(req), None))
        for entry in self._chunking:
            self.sched.release(entry.slot)
            self.block_pool.release(entry.alloc, donate=False)
            requeue.append((entry.req, done_before(entry.req), None))
        self._chunking = []
        while True:
            # Migration limbo: the chain is written and the row released,
            # so it is donated (clean as an active's prompt), the migrate
            # intent restored, and the request requeued: its re-prefill
            # is a prefix hit that samples the same first token.
            exp = self.sched.pop_limbo()
            if exp is None:
                break
            self.block_pool.release(exp.alloc)
            self._migrate_rids.add(exp.rid)
            requeue.append((exp.req, done_before(exp.req), exp.submit_t))
        if flush_cache and self.paged:
            self.block_pool.reset_cache()
        self._reset_device_state(flush_cache)
        requeue.sort(key=lambda item: item[0].rid)
        now = time.monotonic()
        for req, done, sub_t in requeue:
            if req.rid not in self._submit_meta:
                sid = self.tracer.begin("queued", cat="request",
                                        rid=req.rid, args={"resumed": True})
                self._submit_meta[req.rid] = (
                    self.steps, sub_t if sub_t is not None else now, sid)
            self.requeued += 1
            self.flight.record("requeue", rid=req.rid, step=self.steps,
                               cause=cause, tokens_done=done)
        self.sched.requeue_front([item[0] for item in requeue])
        self.recoveries += 1
        self._c_recoveries.labels(cause=cause).inc()
        dt = time.monotonic() - t0
        self._h_recovery.observe(dt)
        self.quarantined = False
        self.quarantine_cause = None
        self.flight.record("recover", step=self.steps, cause=cause,
                           requeued=len(requeue), flushed=flush_cache,
                           rebuild_s=round(dt, 6))
        return {"cause": cause, "requeued": len(requeue),
                "flush_cache": flush_cache, "rebuild_s": dt}

    def abort_all(self, cause: str) -> List[Result]:
        """Permanent failure: every request in flight or queued ends
        'failed' (its tokens so far salvaged into the Result), the slots
        are parked, and submit raises EngineFailedError from now on."""
        self.failed = True
        self.quarantined = False
        self.quarantine_cause = cause
        self._close_dangling_spans()
        self._inflight = None
        self._poison = None
        results, self._pending = self._pending, []
        victims: List[Tuple[Request, List[int]]] = []
        active_rids = set()
        for st in sorted(self._active.values(), key=lambda s: s.req.rid):
            self.sched.release(st.slot)
            if st.alloc is not None:
                self.block_pool.release(st.alloc, donate=False)
            self.tracer.end(st.span, {"failed": True})
            active_rids.add(st.req.rid)
            victims.append((st.req, st.tokens))
        for req, slot, alloc, _ in self._admitting:
            if req.rid in active_rids:
                continue
            self.sched.release(slot)
            if alloc is not None:
                self.block_pool.release(alloc, donate=False)
            victims.append((req, []))
        for entry in self._chunking:
            self.sched.release(entry.slot)
            self.block_pool.release(entry.alloc, donate=False)
            victims.append((entry.req, []))
        self._active, self._admitting, self._chunking = {}, [], []
        self._migrate_rids.clear()
        for item in self.sched.drain_expired(lambda item: True):
            if isinstance(item, _Export):
                # Migration limbo: the handoff never completed. Blocks
                # freed without donation; the first token is salvaged.
                self.block_pool.release(item.alloc, donate=False)
                victims.append((item.req, [item.first_tok]))
            else:
                victims.append((item, []))
        self._reset_device_state(flush_cache=False)
        for req, toks in victims:
            meta = self._submit_meta.pop(req.rid, None)
            if meta is not None:
                self.tracer.end(meta[2], {"failed": True})
            prompt_out, tokens_out, _ = self._unstitch(req, toks)
            if req.deadline_s is not None:
                self.slo.record_shed(req.slo_class)
            self._c_completed.labels(reason="failed").inc()
            self.flight.record("failed", rid=req.rid, step=self.steps,
                               cause=cause, tokens=len(tokens_out))
            results.append(Result(rid=req.rid, prompt=prompt_out,
                                  tokens=tokens_out,
                                  finish_reason="failed"))
        self.flight.record("engine_failed", step=self.steps, cause=cause,
                           aborted=len(victims))
        return results

    # ------------------------------------------------------------------
    # disaggregated prefill/decode (module docstring). The export side:
    # pop_export, then exactly one of complete_export, requeue_export,
    # repark_export. The adopting side: begin_adopt, write_pool_blocks
    # (from the source's read_pool_blocks), then commit_adopt, or
    # abort_adopt.
    # ------------------------------------------------------------------
    def pop_export(self) -> Optional[_Export]:
        """Claim the oldest parked export for transfer (None when limbo is
        empty). The caller owns it until it completes, requeues or
        reparks it."""
        return self.sched.pop_limbo()

    def repark_export(self, exp: _Export) -> None:
        """Return an untransferred export to the head of limbo (the
        adopting engine had no slot or blocks); the shed sweep keeps
        watching it."""
        self.sched.park_limbo_front(exp)

    def complete_export(self, exp: _Export, *, dst: str = "",
                        blocks_copied: int = 0, bytes_moved: int = 0,
                        migrate_s: float = 0.0) -> None:
        """The handoff landed: the adopting engine committed the row. The
        chain is released with donation (written and clean: a later
        failover restitch hits it here) and the terminal belongs to the
        adopter. This engine records the one ``migrate`` event."""
        self.migrated += 1
        self.completed += 1
        self._c_completed.labels(reason="migrated").inc()
        self.block_pool.release(exp.alloc)
        self.flight.record(
            "migrate", rid=exp.rid, step=self.steps, dst=dst,
            chain_blocks=len(exp.alloc.table), hit_blocks=exp.alloc.n_hit,
            copied_blocks=blocks_copied, bytes=bytes_moved,
            migrate_s=round(migrate_s, 6),
            limbo_s=round(time.monotonic() - exp.export_t, 6))

    def requeue_export(self, exp: _Export, *, migrate: bool = False) -> None:
        """Fallback (no engine can adopt): the request goes back through
        this engine's admission under its rid and deadline budget,
        colocated unless ``migrate``. The chain is donated first, so the
        re-prefill is a prefix hit that samples the same first token."""
        self.block_pool.release(exp.alloc)
        if migrate:
            self._migrate_rids.add(exp.rid)
        sid = self.tracer.begin("queued", cat="request", rid=exp.rid,
                                args={"requeued_export": True})
        self._submit_meta[exp.rid] = (exp.submit_step, exp.submit_t, sid)
        self.sched.requeue_front([exp.req])
        self.flight.record("requeue", rid=exp.rid, step=self.steps,
                           cause="export_fallback", tokens_done=0)

    def begin_adopt(self, req: Request, *,
                    max_new_tokens: Optional[int] = None
                    ) -> Optional[_Adoption]:
        """Reserve a slot and the full footprint of a migrated request
        (BlockPool.adopt_chain), re-keyed into this engine's rids; None
        when it cannot be taken now (no free slot, too few blocks,
        quarantined): the caller reparks the export. The handle's
        ``copy`` / ``dst_blocks`` name the blocks to fill before
        commit_adopt."""
        if self.failed:
            raise EngineFailedError("engine permanently failed; cannot "
                                    "adopt")
        if not self.paged:
            raise ValueError("adoption needs a paged engine: the block "
                             "chain is the migration wire format")
        max_new = (req.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if len(req.prompt) + max_new > self.max_len:
            raise ValueError(
                f"adopted prompt ({len(req.prompt)}) + max_new ({max_new}) "
                f"exceeds max_len {self.max_len}")
        if self.quarantined or not self.sched.free_slots:
            return None
        got = self.block_pool.adopt_chain(req.prompt, max_new)
        if got is None:
            self.flight.record(
                "block_stall", rid=-1, step=self.steps,
                need=self.block_pool.blocks_needed(len(req.prompt), max_new),
                free=self.block_pool.free_blocks, adopt=True)
            return None
        alloc, copy = got
        req = replace(req, rid=next(self._rid), max_new_tokens=max_new)
        return _Adoption(req=req, slot=self.sched.take_slot(), alloc=alloc,
                         copy=copy)

    def abort_adopt(self, ad: _Adoption) -> None:
        """Unwind a begun adoption whose transfer failed: the slot back,
        the blocks freed without donation (a half-copied chain must never
        serve a hit). No terminal: the source's export still owns the
        request."""
        self.sched.release(ad.slot)
        self.block_pool.release(ad.alloc, donate=False)

    def commit_adopt(self, ad: _Adoption, first_tok: int, *,
                     submit_t: Optional[float] = None,
                     src: str = "") -> Tuple[int, Optional[Result]]:
        """Activate the adopted row: its slot state is written in place
        (table row, pos = true_len, the migrated first token, the seed
        and sampling knobs, live), behind any chunk in flight, and no
        prefill runs. Decode continues at (seed, pos + 1), so its tokens
        are the source's colocated stream. Returns (rid here, the Result
        when the first token already finishes it). A first token outside
        the vocabulary raises ValueError before anything is written."""
        req = ad.req
        if not 0 <= int(first_tok) < self.cfg.vocab_size:
            raise ValueError(f"migrated first token {first_tok} outside "
                             f"[0, vocab_size={self.cfg.vocab_size})")
        now = time.monotonic()
        slot = ad.slot
        row = np.full(self.slot_blocks, self.kv_pool_blocks, np.int32)
        row[:len(ad.alloc.table)] = ad.alloc.table
        self._table[slot].copy_(torch.from_numpy(row))
        self._pos[slot] = len(req.prompt)
        self._tok[slot] = int(first_tok)
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._seed[slot] = req.seed
        self._live[slot] = True
        self.admitted += 1
        self.adopted += 1
        self._c_submitted.inc()
        span = self.tracer.begin("generate", cat="request", rid=req.rid,
                                 args={"slot": slot, "adopted": True})
        st = _Active(req=req, slot=slot, alloc=ad.alloc,
                     tokens=[int(first_tok)],
                     submit_t=submit_t if submit_t is not None else now,
                     first_token_t=now, last_t=now, span=span)
        self._active[slot] = st
        self.flight.record(
            "adopt", rid=req.rid, step=self.steps, slot=slot, src=src,
            chain_blocks=len(ad.alloc.table), hit_blocks=ad.alloc.n_hit,
            copied_blocks=len(ad.copy), prompt_len=len(req.prompt))
        return req.rid, self._maybe_finish(st)

    def _pool_leaves(self) -> List[torch.Tensor]:
        """The pool's tensors in the JAX package's leaf order: per layer
        (k, v), or (k, v, k_scale, v_scale) for int8 and int4. Under tp
        each carries the leading shard dim (init_paged_cache)."""
        return [buf for layer in self._pool for buf in layer]

    def _read_leaf(self, leaf: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
        """Blocks idx of one leaf in tp 1's layout: under tp the shards'
        heads concatenated in shard order, (n, H, ...)."""
        if self.tp == 1:
            return leaf.index_select(0, idx)
        blocks = leaf.index_select(1, idx).movedim(0, 1)  # (n, tp, H/tp..)
        return blocks.flatten(1, 2)

    def _write_leaf(self, leaf: torch.Tensor, idx: torch.Tensor,
                    v: torch.Tensor) -> None:
        """read_leaf's inverse, in place: tp 1's (n, H, ...) blocks into
        blocks idx of one leaf."""
        if self.tp == 1:
            leaf.index_copy_(0, idx, v)
            return
        leaf.index_copy_(1, idx, v.unflatten(1, (self.tp, -1)).movedim(1, 0))

    def _leaf_shape(self, leaf: torch.Tensor) -> tuple:
        """A leaf's per-block shape in tp 1's layout."""
        if self.tp == 1:
            return tuple(leaf.shape[1:])
        return (leaf.shape[0] * leaf.shape[2],) + tuple(leaf.shape[3:])

    def _block_index(self, block_ids: Sequence[int]) -> torch.Tensor:
        """The ids of one request's blocks as a device index; ValueError
        past slot_blocks of them or outside the allocatable blocks (the
        drop block is never read or written as a block)."""
        ids = [int(b) for b in block_ids]
        if len(ids) > self.slot_blocks or any(
                not 0 <= b < self.kv_pool_blocks for b in ids):
            raise ValueError(f"block ids {ids}: at most {self.slot_blocks} "
                             f"in [0, {self.kv_pool_blocks})")
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def read_pool_blocks(self, block_ids: Sequence[int]
                         ) -> List[torch.Tensor]:
        """Whole blocks by id, one tensor a pool leaf (_pool_leaves'
        order), on this engine's device: the migration payload. Quantized
        pools give their codes and scales as they are."""
        idx = self._block_index(block_ids)
        return [self._read_leaf(leaf, idx) for leaf in self._pool_leaves()]

    def write_pool_blocks(self, block_ids: Sequence[int],
                          values: Sequence) -> int:
        """Write whole blocks into this pool by id, in place (the pool
        tensors keep their addresses for the graphs), behind any chunk in
        flight: the adopting twin of read_pool_blocks. ``values`` are
        tensors (any device) of (>= n, ...) rows, one a leaf. JAX pads
        its scatter to slot_blocks rows for one compiled shape; an eager
        index_copy_ needs none, so only the n real rows move. Returns the
        payload bytes written."""
        n = len(block_ids)
        if n == 0:
            return 0
        idx = self._block_index(block_ids)
        leaves = self._pool_leaves()
        if len(values) != len(leaves):
            raise ValueError(f"payload has {len(values)} leaves, pool has "
                             f"{len(leaves)}")
        for leaf, v in zip(leaves, values):
            if (v.shape[0] < n or tuple(v.shape[1:]) != self._leaf_shape(leaf)
                    or v.dtype != leaf.dtype):
                raise ValueError(
                    f"payload leaf {tuple(v.shape)}/{v.dtype} does not "
                    f"match pool leaf {self._leaf_shape(leaf)}/{leaf.dtype}")
        nbytes = 0
        for leaf, v in zip(leaves, values):
            self._write_leaf(leaf, idx, v[:n].to(self.device))
            nbytes += v[:n].numel() * v.element_size()
        return nbytes

    def prefix_summary(self) -> dict:
        """The radix cache's residency summary a fleet router replaces its
        index of this replica with (GET /debug/prefix_summary): one
        chained fingerprint a resident trie node. Host bookkeeping only;
        walks the trie, so it runs on the thread that steps the engine."""
        if self.block_pool is None or self.block_pool.cache is None:
            return {"enabled": False, "page": 0, "blocks": 0,
                    "digests": []}
        digests = self.block_pool.cache.digests()
        return {"enabled": True, "page": self.kv_page_size,
                "blocks": len(digests), "digests": digests}

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def _recent_rate(self) -> Optional[float]:
        ring = list(self._rate)
        if len(ring) < 2 or ring[-1][0] <= ring[0][0]:
            return None
        return sum(n for _, n in ring[1:]) / (ring[-1][0] - ring[0][0])

    def retry_after_s(self, slo_class: Optional[str] = None,
                      priority: Optional[int] = None) -> float:
        """Client backoff hint for a 429: the queue-wait p50 (decode
        steps) over the recent step rate, at least 0.5 s (1 s while
        either signal is cold). With a class or a priority it scales by
        the queue mass ahead of that priority, the strictly higher part
        counted twice: a batch request behind a deep interactive queue
        waits longer than an interactive one."""
        base = 1.0
        p = self._queue_wait.percentiles((50,))
        steps_per_s = self._steps_per_s()
        if p and steps_per_s is not None:
            base = max(0.5, p["p50"] / steps_per_s)
        if priority is None:
            if slo_class is None:
                return base
            priority = PRIORITY_BY_CLASS.get(slo_class, DEFAULT_PRIORITY)
        ahead, jumps = self.sched.queue_mass(priority)
        return base * (1.0 + (ahead + jumps) / max(1, self.num_slots))

    def reset_latency_stats(self) -> None:
        """Clear the latency histograms, the rate window, the span ring,
        the SLO ledger, the flight ring, the watchdog's TTFT baseline,
        the pool's hit ledger and the spec acceptance counts, so that
        they describe the traffic after a warmup."""
        for fam in (self._ttft, self._ttft_prefix, self._tpot,
                    self._queue_wait, self._spec_accept_len,
                    self._spec_req_accepted):
            fam.reset()
        self._rate.clear()
        self.tracer.clear()
        self.slo.reset()
        self.flight.clear()
        self.watchdog.reset()
        if self.block_pool is not None:
            self.block_pool.reset_ledger()
        if self._spec is not None:
            # The acceptance rate describes the traffic after a warmup
            # too (warmup prompts are all zeros).
            self._spec.steps = self._spec.drafted = self._spec.accepted = 0

    # ------------------------------------------------------------------
    # the on-demand profiler window (POST /profile)
    # ------------------------------------------------------------------
    def request_profile(self, steps: int, out_dir: Optional[str] = None,
                        ) -> dict:
        """Arm a torch.profiler window (utils/profiler.py, the trainer's
        profile_steps machinery) over the next ``steps`` engine steps;
        the trace lands in ``out_dir`` (default: a new temporary
        directory) as serve_profile.trace.json. Thread-safe: an HTTP
        handler arms it, the stepping thread opens, advances and closes
        it inside step(). The directory is made and checked here, before
        the lock, so a bad path is the caller's error and slow I/O never
        holds a lock the stepping thread takes. A started window raises
        RuntimeError; an armed one not yet started is replaced."""
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"profile steps must be >= 1, got {steps}")
        auto = out_dir is None
        d = out_dir or tempfile.mkdtemp(prefix="serve-profile-")
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            raise ValueError(f"unusable profile dir {d!r}: {e}") from e
        with self._profile_lock:
            if self._profile is not None and self._profile["started"]:
                if auto:
                    _rmdir_quietly(d)
                raise RuntimeError("a profile window is already in progress")
            self._reap_unstarted_dir()
            self._profile = {"dir": d, "auto_dir": auto, "steps": steps,
                             "remaining": steps, "started": False,
                             "span": 0, "profiler": None}
        return {"dir": d, "steps": steps}

    def _reap_unstarted_dir(self) -> None:
        """Remove the empty auto-made directory of a replaced or
        cancelled window that never started (call with _profile_lock
        held). rmdir only: a directory a trace wrote into stays."""
        prof = self._profile
        if prof is not None and prof["auto_dir"] and not prof["started"]:
            _rmdir_quietly(prof["dir"])

    def cancel_profile(self) -> bool:
        """Disarm a window that has not started (a started one runs to
        its close). Returns whether anything was cancelled."""
        with self._profile_lock:
            if self._profile is not None and not self._profile["started"]:
                self._reap_unstarted_dir()
                self._profile = None
                return True
            return False

    def _profile_window_start(self) -> None:
        # Unlocked None check first: this runs every step, and no lock is
        # taken unless a window is armed.
        if self._profile is None:
            return
        with self._profile_lock:
            prof = self._profile
            if prof is None or prof["started"] or not self.has_work():
                return
            prof["started"] = True
        try:
            prof["profiler"] = profile_window.start(self.device,
                                                    preamble=True)
        except Exception as e:  # the profiler is busy elsewhere
            # Fail the profile, never the serving loop it rides in.
            with self._profile_lock:
                if prof["auto_dir"]:
                    _rmdir_quietly(prof["dir"])
                self._profile = None
            self.last_profile = {"dir": prof["dir"], "steps": prof["steps"],
                                 "error": f"{type(e).__name__}: {e}"}
            return
        prof["sync_mark"] = _tracecheck.sync_counts()
        prof["span"] = self.tracer.begin(
            "profile_window", cat="profile",
            args={"steps": prof["steps"], "dir": prof["dir"]})

    def _profile_window_advance(self) -> None:
        prof = self._profile
        if prof is None or not prof["started"]:
            return
        prof["remaining"] -= 1
        # Close early when the engine runs dry: the loop stops stepping
        # an idle engine, and the window would stay open until traffic
        # came back.
        if prof["remaining"] > 0 and self.has_work():
            return
        path = os.path.join(prof["dir"], "serve_profile.trace.json")
        self.last_profile = {"dir": prof["dir"], "steps": prof["steps"],
                             "steps_profiled": prof["steps"]
                             - prof["remaining"]}
        try:
            profile_window.stop(prof["profiler"], self.device, path)
        except Exception as e:  # the directory went away, a full disk
            self.last_profile["error"] = f"{type(e).__name__}: {e}"
            self.tracer.end(prof["span"], {"error": self.last_profile["error"]})
        else:
            by_kind = _tracecheck.sync_delta(prof["sync_mark"])
            self.last_profile["trace"] = path
            self.last_profile["host_syncs_in_window"] = by_kind
            self.tracer.end(prof["span"],
                            {"host_syncs": sum(by_kind.values())})
        with self._profile_lock:
            self._profile = None

    def stats(self) -> dict:
        spec = {"enabled": False} if self._spec is None else \
            self._spec.stats()
        dispatches = sum(self.host_dispatches.values())
        kv_pool: dict = {"paged": False}
        if self.paged:
            kv_pool = self.block_pool.stats()
            # peek, never labels(): a read must not mint an empty
            # {prefix=} series for the exposition to render.
            hit = self._ttft_prefix.peek(prefix="hit")
            miss = self._ttft_prefix.peek(prefix="miss")
            kv_pool["ttft_hit_s"] = (None if hit is None
                                     else hit.percentiles((50, 90, 99)))
            kv_pool["ttft_miss_s"] = (None if miss is None
                                      else miss.percentiles((50, 90, 99)))
        return {
            "device": str(self.device),
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "paged": self.paged,
            "kv_dtype": self.kv_dtype,
            "tp": self.tp,
            "tp_devices": [str(self.device)] * self.tp,
            "kv_page_size": self.kv_page_size,
            "kv_pool_blocks": self.kv_pool_blocks,
            "kv_pool": kv_pool,
            "prefill_buckets": list(self.sched.buckets),
            "admit_buckets": list(self.admit_buckets),
            "active": len(self._active),
            "queued": self.sched.queued,
            "free_slots": self.sched.free_slots,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": dict(self.rejected),
            # The disaggregated posture: the tier and both sides of the
            # migration flow.
            "role": self.role,
            "limbo": self.sched.limbo,
            "migrated": self.migrated,
            "adopted": self.adopted,
            "prefill_waves": self.waves,
            "decode_steps": self.steps,
            "decode_chunk_steps": self.chunk_steps,
            "decode_attention_impl": self.decode_impl,
            "pipeline": self.pipeline,
            "scan_k": self.scan_k,
            "scan_rungs": list(self.scan_rungs),
            "host_dispatches": dict(self.host_dispatches),
            "tokens_per_dispatch": (
                self.tokens_generated / dispatches if dispatches else None),
            "graph_replays": {_graph_name(g): n
                              for g, n in self.graph_replays.items()},
            "graph_pool_bytes": (self.graph_pool_bytes if self._graphs
                                 else None),
            "tokens_generated": self.tokens_generated,
            "decode_tokens_per_sec": self._recent_rate(),
            "ttft_s": self._ttft.percentiles((50, 90, 99)),
            "tpot_s": self._tpot.percentiles((50, 90, 99)),
            "queue_wait_steps_mean": self._queue_wait.mean(),
            "retry_after_s": self.retry_after_s(),
            "shed": self.shed,
            "default_deadline_s": self.default_deadline_s,
            "preemptions": self.preemptions,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "chunking": len(self._chunking),
            "spec_suspended": self.spec_suspended,
            "brownout": (None if self.brownout is None
                         else self.brownout.stats()),
            "slo": self.slo.stats(),
            # The speculative signal: token-level acceptance rate and the
            # mean accepted draft length of drafting verify rows.
            "spec": spec,
            "spec_acceptance_rate": spec.get("acceptance_rate"),
            "spec_accepted_len_mean": self._spec_accept_len.mean(),
            "spec_req_accepted_tokens": self._spec_req_accepted.percentiles(
                (50, 90, 99)),
            # Faults and recovery: what readiness keys off, plus the
            # armed plan.
            "recovery": {
                "quarantined": self.quarantined,
                "failed": self.failed,
                "cause": self.quarantine_cause,
                "recoveries": self.recoveries,
                "recovery_s": self._h_recovery.percentiles((50, 90, 99)),
                "poisoned_steps": self.poisoned_steps,
                "requeued": self.requeued,
                "resumed_in_flight": len(self._resumed),
                "drafter_faults": self.drafter_faults,
                "spec_disabled": self.spec_disabled_reason,
            },
            "drafter_faults": self.drafter_faults,
            "faults": (None if self.faults is None
                       else self.faults.stats()),
            "flight": self.flight.stats(),
            "watchdog": self.watchdog.stats(),
            "profile": {"active": self._profile is not None,
                        "last": self.last_profile},
        }

    # ------------------------------------------------------------------
    # live introspection (GET /debug/slots | /debug/kvpool |
    # /debug/scheduler): reads from an HTTP handler thread while the
    # loop thread mutates, as /stats does. Every shared structure is
    # copied before iteration, so a torn read gives a stale view, never
    # a crash; no device tensor is read.
    # ------------------------------------------------------------------
    def debug_slots(self) -> dict:
        """Per-slot occupancy: who owns each row, how far along it is,
        and how stale its last token is (the stuck-slot watchdog's view,
        on demand)."""
        now = time.monotonic()
        inflight = self._inflight
        inflight = dict(inflight[1]) if inflight is not None else {}
        active = dict(self._active)
        chunking = {e.slot: e for e in list(self._chunking)}
        slots = []
        for slot in range(self.num_slots):
            st = active.get(slot)
            if st is None:
                e = chunking.get(slot)
                if e is not None:
                    slots.append({"slot": slot, "state": "prefilling",
                                  "rid": e.req.rid,
                                  "prompt_len": len(e.req.prompt),
                                  "prefilled": e.hit + e.done})
                else:
                    slots.append({"slot": slot, "state": "free"})
                continue
            req = st.req
            slots.append({
                "slot": slot, "state": "active", "rid": req.rid,
                "slo_class": req.slo_class, "deadline_s": req.deadline_s,
                "prompt_len": len(req.prompt),
                "max_new": req.max_new_tokens,
                "tokens": len(st.tokens),
                "age_s": round(now - st.submit_t, 6),
                "since_last_token_s": round(now - st.last_t, 6),
                "prefix_hit": bool(st.alloc.n_hit)
                if st.alloc is not None else False,
                "in_flight_step": inflight.get(slot) == req.rid,
                "spec_accepted": st.spec_accepted,
            })
        return {"num_slots": self.num_slots, "active": len(active),
                "free_slots": self.sched.free_slots, "slots": slots}

    def debug_kvpool(self) -> dict:
        """Paged-pool block states, fragmentation and radix-trie
        occupancy (serve/paged.py BlockPool.debug); {"paged": False} on a
        dense engine; under tp > 1 also "tp", the shards' count."""
        shards = {"tp": self.tp} if self.tp > 1 else {}
        if self.block_pool is None:
            return {"paged": False, **shards}
        live = [(st.req.rid, len(st.req.prompt) + len(st.tokens), st.alloc)
                for st in list(self._active.values())
                if st.alloc is not None]
        return {"paged": True, "kv_page_size": self.kv_page_size,
                **shards, **self.block_pool.debug(live)}

    def debug_scheduler(self) -> dict:
        """The queue head first, with each request's wait, deadline state
        (the shed forecast), bucket and priority; the depth of each class
        by priority; the brownout posture, the chunked-prefill lane, the
        ladders and, under spec, the drafter's acceptance."""
        now = time.monotonic()
        queued = []
        by_class: Dict[str, dict] = {}
        for item in self.sched.queued_items():
            meta = self._submit_meta.get(item.rid)
            waited = None if meta is None else round(now - meta[1], 6)
            queued.append({
                "rid": item.rid, "prompt_len": len(item.prompt),
                "max_new": item.max_new_tokens,
                # The no-hit bucket: a debug read must not walk the radix
                # trie the loop thread owns.
                "bucket": self.sched.bucket_for(len(item.prompt)),
                "slo_class": item.slo_class,
                "priority": item.priority,
                "deadline_s": item.deadline_s,
                "waited_s": waited,
                "expired": bool(item.deadline_s is not None
                                and waited is not None
                                and waited > item.deadline_s),
            })
            cls = by_class.setdefault(
                item.slo_class, {"queued": 0, "priorities": {}})
            cls["queued"] += 1
            pr = cls["priorities"]
            pr[item.priority] = pr.get(item.priority, 0) + 1
        # The migration limbo: exports awaiting adoption, with the queue's
        # deadline fields (the same shed sweep covers them).
        limbo = []
        for exp in self.sched.limbo_items():
            waited = round(now - exp.submit_t, 6)
            limbo.append({
                "rid": exp.rid, "prompt_len": len(exp.req.prompt),
                "chain_blocks": len(exp.alloc.table),
                "hit_blocks": exp.alloc.n_hit,
                "slo_class": exp.req.slo_class,
                "priority": exp.priority,
                "deadline_s": exp.deadline_s,
                "waited_s": waited,
                "limbo_s": round(now - exp.export_t, 6),
                "expired": bool(exp.deadline_s is not None
                                and waited > exp.deadline_s),
            })
        out = {"queued": len(queued), "queue": queued,
               "queue_by_class": by_class,
               "role": self.role,
               "limbo": len(limbo), "limbo_queue": limbo,
               "migrated": self.migrated, "adopted": self.adopted,
               "free_slots": self.sched.free_slots,
               "active": len(self._active),
               "prefill_buckets": list(self.sched.buckets),
               "admit_buckets": list(self.admit_buckets),
               "pipeline": self.pipeline,
               "inflight_step": self._inflight is not None,
               "steps": self.steps, "shed": self.shed,
               "default_deadline_s": self.default_deadline_s,
               "preemptions": self.preemptions,
               "prefill_chunk": self.prefill_chunk,
               "chunking": [{"rid": e.req.rid, "slot": e.slot,
                             "prefilled": e.hit + e.done,
                             "prompt_len": len(e.req.prompt)}
                            for e in list(self._chunking)],
               "brownout": (None if self.brownout is None
                            else self.brownout.stats())}
        spec = self._spec
        if spec is not None:
            out["spec"] = {**spec.stats(),
                           "drafter_kind": spec.drafter.kind,
                           "mean_accepted_per_verify": (
                               spec.accepted / spec.steps if spec.steps
                               else None)}
        return out

    def _program_bodies(self) -> Dict[str, Dict[tuple, Callable]]:
        """The CUDA graphs the engine captures, by kind and key, each
        with the body its capture records: 'decode', one per (rung,
        filtered) pair; under spec 'verify', the greedy and the sampled
        graph, and a ModelDrafter's 'draft'."""
        progs = {"decode": {
            (r, filtered): (lambda r=r, f=filtered: self._steps(r, f))
            for r in self.scan_rungs for filtered in (False, True)}}
        if self._spec is not None:
            progs["verify"] = {("verify", sampled):
                               (lambda s=sampled: self._spec.body(s))
                               for sampled in (False, True)}
            if self._spec.drafter.kind == "device":
                progs["draft"] = {("draft",): self._draft_steps}
        return progs

    def max_programs(self) -> dict:
        """The tracecheck budgets by kind: how many graphs of each kind
        the engine captures (none on the CPU, where the bodies run
        eagerly). What was captured is ``tracecheck.counts()``. JAX's
        counterpart counts compiled programs: one per rung, and one
        verify (its lax.cond holds both paths)."""
        return self.tracecheck.budgets()


def _rmdir_quietly(path: str) -> None:
    try:
        os.rmdir(path)
    except OSError:
        pass


def _wrapper_counts() -> tuple:
    """The kernel wrappers' counts, copied: (launches, plain-version
    calls on the card)."""
    return ({**fd.launches, **at.launches},
            {**fd.plain_cuda_calls, **at.plain_cuda_calls})


def _graph_name(key: tuple) -> str:
    """A graph's name in stats(): '<rung>' or '<rung>/filtered' for a
    decode chunk, 'verify' or 'verify/sampled', 'draft'."""
    if key[0] == "verify":
        return "verify/sampled" if key[1] else "verify"
    if key[0] == "draft":
        return "draft"
    rung, filtered = key
    return f"{rung}/filtered" if filtered else str(rung)
