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

Speculative decoding, the flight recorder and metric registry, fault
injection and recovery, and the disaggregated handoff are later slices
of the port.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nanosandbox_tpu_torch.config import resolve_device
from nanosandbox_tpu_torch.models.gpt import (GPT, init_cache,
                                              init_paged_cache, kv_mode,
                                              scatter_cache_rows)
from nanosandbox_tpu_torch.obs.slo import SLOLedger, validate_slo_class
from nanosandbox_tpu_torch.ops import _build
from nanosandbox_tpu_torch.ops import attention as at
from nanosandbox_tpu_torch.ops import flash_decode as fd
from nanosandbox_tpu_torch.sample import sample_token_rows
from nanosandbox_tpu_torch.serve.brownout import BrownoutController
from nanosandbox_tpu_torch.serve.paged import (Allocation, BlockPool,
                                               prefix_digests)
from nanosandbox_tpu_torch.serve.scheduler import (SlotScheduler,
                                                   default_buckets)

# Scheduling priority by SLO class: higher admits first and may preempt
# lower. An explicit priority overrides the class's; unknown classes take
# the default. The brownout floors (serve/brownout.py) use these numbers.
PRIORITY_BY_CLASS = {"batch": 0, "default": 1, "interactive": 2}
DEFAULT_PRIORITY = 1


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


@dataclass
class _Resume:
    """A preempted request's original prompt and the tokens it had
    before each preemption: what its terminal Result reports."""
    prompt: tuple
    tokens: List[int]


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
                 device: str = "auto"):
        if paged and kv_page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got "
                             f"{kv_page_size}")
        self.scan_rungs = scan_ladder(scan_k)
        self.scan_k = int(scan_k)
        self.pipeline = bool(pipeline)
        self.decode_impl = resolve_decode_impl(decode_impl)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        cfg = self.cfg = model.cfg
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
        self.paged = bool(paged)
        self.block_pool: Optional[BlockPool] = None
        if self.paged:
            self.kv_page_size = int(kv_page_size)
            self.slot_blocks = -(-self.max_len // self.kv_page_size)
            self.kv_pool_blocks = int(kv_pool_blocks
                                      or num_slots * self.slot_blocks)
            self._pool = init_paged_cache(cfg, self.kv_pool_blocks,
                                          self.kv_page_size, kv_dtype,
                                          device=self.device)
            self.block_pool = BlockPool(self.kv_pool_blocks,
                                        self.kv_page_size,
                                        prefix_cache=prefix_cache)
        else:
            self.kv_page_size = self.slot_blocks = self.kv_pool_blocks = 0
            self._pool = init_cache(cfg, num_slots, self.max_len, kv_dtype,
                                    device=self.device)
        self._init_slot_state()

        self._active: Dict[int, _Active] = {}        # slot -> state
        self._pending: List[Result] = []    # terminal before any step
        # rid -> (decode steps, wall clock) at submit, for queued requests.
        self._submit_meta: Dict[int, Tuple[int, float]] = {}
        self._chunking: List[_Chunking] = []     # the chunked-prefill lane
        self._prefill_spent = 0                  # this step's prefill tokens
        self._resumed: Dict[int, _Resume] = {}   # preempted rids
        self._rid = itertools.count()
        # The dispatched chunk not yet retired: (host buffer index,
        # {slot: rid} at dispatch, chunk length).
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
        # The brownout knobs, read on the hot path. spec_suspended is
        # inert until speculative decoding is ported.
        self.scan_cap: Optional[int] = None
        self.spec_suspended = False
        self.brownout_min_priority: Optional[int] = None
        self.slo = SLOLedger()
        self.host_dispatches = {"decode": 0}
        self._ttft: deque = deque(maxlen=4096)
        self._tpot: deque = deque(maxlen=4096)
        # Decode steps each admitted request waited in the queue (the
        # retry-after hint's p50).
        self._queue_wait: deque = deque(maxlen=4096)
        self._rate: deque = deque(maxlen=256)        # (t, tokens read back)
        # On CUDA, per (rung, filtered): the captured chunk, its replays,
        # and the kernel launches and plain-version calls its capture
        # recorded (a replay runs them again, uncounted by the wrappers);
        # and the bytes the captures reserved.
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self.graph_replays: Dict[tuple, int] = {}
        self.graph_launches: Dict[tuple, Dict[str, int]] = {}
        self.graph_plain_calls: Dict[tuple, Dict[str, int]] = {}
        self.graph_pool_bytes = 0
        self._replay = self.device.type == "cuda"
        if self._replay:
            _build.library()       # build the kernels before any request
            self._capture_graphs()
        # Last, so that the controller sees the finished engine.
        self.brownout = BrownoutController(self) if brownout else None

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

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _reject(self, reason: str, msg: str) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        raise ValueError(msg)

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: int = 0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               slo_class: str = "default",
               priority: Optional[int] = None) -> int:
        """Queue one request; returns its id. Requests the engine can
        never serve are rejected here (ValueError), not mid-flight.
        ``deadline_s`` (default: default_deadline_s) arms SLO accounting
        and queue-time shedding; ``priority`` defaults from
        PRIORITY_BY_CLASS[slo_class]. Below an active brownout floor a
        valid request is accepted and shed at once (a 'shed' Result)."""
        prompt = tuple(int(t) for t in prompt)
        plen = len(prompt)
        if not prompt:
            self._reject("empty_prompt",
                         "empty prompt (encode at least one token)")
        bad = next((t for t in prompt
                    if not 0 <= t < self.cfg.vocab_size), None)
        if bad is not None:
            self._reject("token_out_of_range",
                         f"prompt token {bad} outside [0, vocab_size="
                         f"{self.cfg.vocab_size})")
        if max_new_tokens < 0:
            self._reject("bad_max_new",
                         f"max_new_tokens must be >= 0, got {max_new_tokens}")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        else:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                self._reject("bad_deadline",
                             f"deadline_s must be > 0, got {deadline_s}")
        try:
            slo_class = validate_slo_class(str(slo_class))
        except ValueError as e:
            self._reject("bad_slo_class", str(e))
        if plen > self.sched.buckets[-1]:
            self._reject("prompt_exceeds_bucket",
                         f"prompt length {plen} exceeds the largest prefill "
                         f"bucket {self.sched.buckets[-1]}")
        if plen + max_new_tokens > self.max_len:
            self._reject("exceeds_max_len",
                         f"prompt ({plen}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds the per-request KV "
                         f"length {self.max_len}")
        if self.paged:
            need = self.block_pool.blocks_needed(plen, max_new_tokens)
            if need > self.kv_pool_blocks:
                self._reject("pool_too_small",
                             f"request needs {need} KV blocks but the pool "
                             f"holds {self.kv_pool_blocks}")
        priority = (PRIORITY_BY_CLASS.get(slo_class, DEFAULT_PRIORITY)
                    if priority is None else int(priority))
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed), eos_id=eos_id,
                      deadline_s=deadline_s, slo_class=slo_class,
                      priority=priority)
        floor = self.brownout_min_priority
        if floor is not None and priority < floor:
            # Shed at submit: counted against the class's attainment,
            # nothing spent on it.
            self.shed += 1
            if deadline_s is not None:
                self.slo.record_shed(slo_class)
                self.brownout_sheds += 1
            self._pending.append(Result(rid, prompt, [], "shed"))
            return rid
        if max_new_tokens == 0:
            self.completed += 1
            self.slo.record_finish(slo_class, tokens=0, elapsed_s=0.0,
                                   deadline_s=deadline_s)
            self._pending.append(Result(rid, prompt, [], "length"))
            return rid
        self._submit_meta[rid] = (self.steps, time.monotonic())
        self.sched.enqueue(req)
        return rid

    def has_work(self) -> bool:
        """Requests queued, chunking, active or pending, or a chunk in
        flight."""
        return bool(self._active or self.sched.queued or self._chunking
                    or self._pending or self._inflight is not None)

    def step(self) -> List[Result]:
        """Shed expired queued requests, preempt for a deadline-pressed
        head, admit what fits (one batched prefill per wave, or chunks
        within the prefill budget), dispatch one decode chunk, retire the
        previous chunk (pipeline) or this one, and backfill the slots the
        retire freed; with nothing left to dispatch, retire the chunk in
        flight. Then the brownout poll. Returns the requests that
        finished during this call."""
        finished, self._pending = self._pending, []
        self._prefill_spent = 0
        with torch.no_grad():
            self._shed_expired(finished)
            self._maybe_preempt()
            self._admit_waves(finished)
            retired = False
            chunk_len = self._next_chunk() if self._active else 0
            if chunk_len:
                buf = self._dispatch(chunk_len, any(
                    st.req.filters for st in self._active.values()))
                self.steps += 1
                self.host_dispatches["decode"] += 1
                snapshot = {slot: st.req.rid
                            for slot, st in self._active.items()}
                prev, self._inflight = self._inflight, (buf, snapshot,
                                                        chunk_len)
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
        if self.brownout is not None:
            self.brownout.on_step()
        return finished

    def _shed_expired(self, finished: List[Result]) -> None:
        """Queued requests past their deadline, or below the brownout
        floor, become terminal 'shed' Results (a resumed victim's with
        its original prompt and salvaged tokens), counted against their
        class's attainment."""
        if not self.sched.queued:
            return
        now = time.monotonic()
        meta = self._submit_meta
        floor = self.brownout_min_priority

        def expired(item) -> bool:
            return ((item.deadline_s is not None
                     and now - meta[item.rid][1] > item.deadline_s)
                    or (floor is not None and item.priority < floor))

        for req in self.sched.drain_expired(expired):
            _, sub_t = meta.pop(req.rid)
            self.shed += 1
            prompt_out, tokens_out, _ = self._unstitch(req, [])
            if req.deadline_s is not None:
                self.slo.record_shed(req.slo_class)
                if now - sub_t <= req.deadline_s:
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
        if self._active or self._chunking:
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
                    a = self.block_pool.admit(req.prompt,
                                              req.max_new_tokens)
                    if a is not None:
                        allocs.append(a)
                    return a is not None

                wave = self.sched.next_admission_wave(
                    max_items=max_items, bucket_of=self._suffix_bucket,
                    admit=try_alloc)
                if wave is None:
                    return
                reqs, slots, bucket = wave
            if budget is not None:
                self._prefill_spent += self.sched.rung_for(len(reqs)) * bucket
            self._prefill_wave(reqs, slots, allocs, bucket, finished)

    def _start_chunked(self, head: Request) -> bool:
        """Claim the queue head into the chunked lane: its blocks (the
        full reservation) and a slot, no device work yet. False when the
        pool cannot cover it: the head stays queued."""
        alloc = self.block_pool.admit(head.prompt, head.max_new_tokens)
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
                self._prefill_spent += bucket
                self.prefill_chunks += 1
                entry.done += c
                if c < remaining:
                    self._prefill_piece(req.prompt[start:start + c], start,
                                        alloc, bucket)
                    continue
                self._chunking.remove(entry)
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
        self.model.hidden(self._to_dev(row), cache=self._pool,
                          cache_index=self._to_dev(
                              np.array([start], np.int32)),
                          block_table=self._to_dev(table))

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
        if self.paged:
            d_tables = self._to_dev(tables)
            h = self.model.hidden(d_tokens, cache=self._pool,
                                  cache_index=d_hits, block_table=d_tables)
        else:
            temp = init_cache(self.cfg, k, bucket, device=self.device)
            h = self.model.hidden(d_tokens, cache=temp, cache_index=0)
            scatter_cache_rows(self._pool,
                               [tuple(x[:n] for x in layer) for layer in temp],
                               torch.tensor(slots, device=self.device))
            del temp
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
        host = torch.where(ok, toks, self.cfg.vocab_size).cpu().tolist()
        if start is None:
            self.waves += 1
        now = time.monotonic()
        self._rate.append((now, n))
        for i, (req, slot, a) in enumerate(zip(reqs, slots, allocs)):
            self._commit_admission(req, slot, a, host[i], now, finished)

    def _commit_admission(self, req: Request, slot: int,
                          alloc: Optional[Allocation],
                          first_tok: int, now: float,
                          finished: List[Result]) -> None:
        self.admitted += 1
        sub_step, sub_t = self._submit_meta.pop(req.rid)
        self._queue_wait.append(self.steps - sub_step)
        st = _Active(req=req, slot=slot, alloc=alloc, submit_t=sub_t,
                     first_token_t=now)
        self._active[slot] = st
        if not 0 <= first_tok < self.cfg.vocab_size:
            finished.append(self._finish(st, "failed"))
            return
        st.tokens.append(first_tok)
        self.tokens_generated += 1
        # A resumed request's first token came before its preemption.
        if req.rid not in self._resumed:
            self._ttft.append(now - sub_t)
        done = self._maybe_finish(st)
        if done is not None:
            finished.append(done)

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
        not saved (it sheds); equal priorities never preempt."""
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
                                                   -st.req.rid)))

    def _preempt(self, st: _Active) -> None:
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
        if st.alloc is not None:
            self.block_pool.release(st.alloc, generated=st.tokens)
        base = self._resumed.get(req.rid)
        self._resumed[req.rid] = _Resume(
            prompt=base.prompt if base is not None else req.prompt,
            tokens=(base.tokens if base is not None else []) + st.tokens)
        self._submit_meta[req.rid] = (self.steps, st.submit_t)
        self.preemptions += 1
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
        the captures reserved. A capture that fails raises."""
        dev = self._tok.device
        # The decode kernels' ticket buffer the captures point at.
        self._tickets = fd.ticket_counters(
            dev, self.num_slots * self.cfg.n_head)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad():
            with torch.cuda.stream(stream):
                for filtered in (False, True):
                    self._steps(1, filtered)
            torch.cuda.current_stream(dev).wait_stream(stream)
            pool = torch.cuda.graph_pool_handle()
            for r in self.scan_rungs:
                for filtered in (False, True):
                    key = (r, filtered)
                    before = _wrapper_counts()
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        self._steps(r, filtered)
                    self._graphs[key] = graph
                    self.graph_replays[key] = 0
                    self.graph_launches[key], self.graph_plain_calls[key] = (
                        {name: n - b[name] for name, n in a.items()
                         if n > b[name]}
                        for a, b in zip(_wrapper_counts(), before))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved

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
        event only: work queued behind it keeps running)."""
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        return self._host_toks[i]

    def _retire(self, inflight: tuple, finished: List[Result]) -> None:
        """Read one dispatched chunk's tokens back and apply the lagged
        finish decisions. A slot whose occupant changed since dispatch
        (its request finished and the slot was reused) is skipped: its
        tokens belong to nobody. A live row walks its chunk in order and
        stops at the first of: its budget reached (the surplus is
        dropped), eos (kept, then nothing after it), or the out-of-vocab
        sentinel (the row fails with the clean tokens before it)."""
        i, snapshot, k = inflight
        toks = self._copied_wait(i)[:k].tolist()
        now = time.monotonic()
        vocab = self.cfg.vocab_size
        n_live = 0
        for slot, rid in snapshot.items():
            st = self._active.get(slot)
            if st is None or st.req.rid != rid:
                continue
            poisoned = False
            for row in toks:
                if len(st.tokens) >= st.req.max_new_tokens:
                    break
                tok = row[slot]
                if not 0 <= tok < vocab:
                    poisoned = True
                    break
                st.tokens.append(tok)
                n_live += 1
                if st.req.eos_id is not None and tok == st.req.eos_id:
                    break
            done = (self._finish(st, "failed") if poisoned
                    else self._maybe_finish(st))
            if done is not None:
                finished.append(done)
        self.tokens_generated += n_live
        self._rate.append((now, n_live))

    def _maybe_finish(self, st: _Active) -> Optional[Result]:
        req = st.req
        if req.eos_id is not None and st.tokens[-1] == req.eos_id:
            return self._finish(st, "eos")
        if len(st.tokens) >= req.max_new_tokens:
            return self._finish(st, "length")
        return None

    def _finish(self, st: _Active, reason: str) -> Result:
        """Release the slot (host and device) and the blocks — donating
        the full prompt blocks to the prefix cache unless the row failed
        — and account the terminal: a preempted request's Result carries
        its original prompt and all of its tokens; a deadline-carrying
        one lands in the SLO ledger (a failed row as shed)."""
        now = time.monotonic()
        del self._active[st.slot]
        self.sched.release(st.slot)
        self._release_row(st.slot)
        donate = reason != "failed"
        digest: tuple = ()
        if self.paged:
            self.block_pool.release(st.alloc, donate=donate)
        if donate and self.paged and self.block_pool.cache is not None:
            digest = tuple(prefix_digests(st.req.prompt, self.kv_page_size))
        self.completed += 1
        if len(st.tokens) > 1:
            self._tpot.append((now - st.first_token_t)
                              / (len(st.tokens) - 1))
        req = st.req
        prompt_out, tokens_out, _ = self._unstitch(req, st.tokens)
        if reason == "failed":
            if req.deadline_s is not None:
                self.slo.record_shed(req.slo_class)
        else:
            self.slo.record_finish(
                req.slo_class, tokens=len(tokens_out),
                elapsed_s=now - st.submit_t, deadline_s=req.deadline_s)
        return Result(rid=req.rid, prompt=prompt_out, tokens=tokens_out,
                      finish_reason=reason, prefix_digest=digest)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    @staticmethod
    def _pcts(samples) -> Optional[dict]:
        xs = list(samples)
        if not xs:
            return None
        p50, p90, p99 = np.percentile(xs, (50, 90, 99))
        return {"p50": float(p50), "p90": float(p90), "p99": float(p99)}

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
        waits = list(self._queue_wait)
        steps_per_s = self._steps_per_s()
        if waits and steps_per_s is not None:
            base = max(0.5, float(np.percentile(waits, 50)) / steps_per_s)
        if priority is None:
            if slo_class is None:
                return base
            priority = PRIORITY_BY_CLASS.get(slo_class, DEFAULT_PRIORITY)
        ahead, jumps = self.sched.queue_mass(priority)
        return base * (1.0 + (ahead + jumps) / max(1, self.num_slots))

    def reset_latency_stats(self) -> None:
        """Clear the TTFT / TPOT / queue-wait / rate windows, the SLO
        ledger and the pool's hit ledger, so that they describe the
        traffic after a warmup."""
        self._ttft.clear()
        self._tpot.clear()
        self._queue_wait.clear()
        self._rate.clear()
        self.slo.reset()
        if self.block_pool is not None:
            self.block_pool.reset_ledger()

    def stats(self) -> dict:
        # Copies (one C-level call each): HTTP handler threads read stats
        # while the engine thread appends.
        waits = list(self._queue_wait)
        return {
            "device": str(self.device),
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "paged": self.paged,
            "kv_dtype": self.kv_dtype,
            "kv_page_size": self.kv_page_size,
            "kv_pool_blocks": self.kv_pool_blocks,
            "kv_pool": (self.block_pool.stats() if self.paged
                        else {"paged": False}),
            "prefill_buckets": list(self.sched.buckets),
            "admit_buckets": list(self.admit_buckets),
            "active": len(self._active),
            "queued": self.sched.queued,
            "free_slots": self.sched.free_slots,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": dict(self.rejected),
            "prefill_waves": self.waves,
            "decode_steps": self.steps,
            "decode_chunk_steps": self.chunk_steps,
            "decode_attention_impl": self.decode_impl,
            "pipeline": self.pipeline,
            "scan_k": self.scan_k,
            "scan_rungs": list(self.scan_rungs),
            "host_dispatches": dict(self.host_dispatches),
            "tokens_per_dispatch": (
                self.tokens_generated / self.host_dispatches["decode"]
                if self.host_dispatches["decode"] else None),
            "graph_replays": {_graph_name(g): n
                              for g, n in self.graph_replays.items()},
            "graph_pool_bytes": (self.graph_pool_bytes if self._graphs
                                 else None),
            "tokens_generated": self.tokens_generated,
            "decode_tokens_per_sec": self._recent_rate(),
            "ttft_s": self._pcts(self._ttft),
            "tpot_s": self._pcts(self._tpot),
            "queue_wait_steps_mean": (float(np.mean(waits))
                                      if waits else None),
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
        }

    def max_programs(self) -> dict:
        """The decode programs: the CUDA graphs captured, one per (rung,
        filtered) pair (none on the CPU, where the body runs eagerly).
        JAX's counterpart counts one compiled program per rung."""
        return {"decode": len(self._graphs)}


def _wrapper_counts() -> tuple:
    """The kernel wrappers' counts, copied: (launches, plain-version
    calls on the card)."""
    return ({**fd.launches, **at.launches},
            {**fd.plain_cuda_calls, **at.plain_cuda_calls})


def _graph_name(key: tuple) -> str:
    """'<rung>' or '<rung>/filtered': a graph's name in stats()."""
    rung, filtered = key
    return f"{rung}/filtered" if filtered else str(rung)
