"""Continuous-batching decode engine over a paged or dense KV pool.

The counterpart of nanosandbox_tpu/serve/engine.py with ``--scan_k=1``,
both pools, and every --kv_dtype (fp32, bf16, int8, int4; the quantized
modes quantize on write, models/gpt.py). The paged pool (``paged=True``,
the default):

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
  * One batched decode step over ALL slots per engine step: parked rows
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
(sample.py): a request's tokens do not depend on the rest of its batch.
The loop is synchronous — dispatch, read back, retire — which is the
JAX engine's ``pipeline=False``; outputs are identical either way. The
one-step pipeline, scan_k, speculative decoding, chunked prefill,
preemption, deadlines and recovery are later slices of the port.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nanosandbox_tpu_torch.config import resolve_device
from nanosandbox_tpu_torch.models.gpt import (GPT, init_cache,
                                              init_paged_cache, kv_mode,
                                              scatter_cache_rows)
from nanosandbox_tpu_torch.ops import _build
from nanosandbox_tpu_torch.sample import sample_token_rows
from nanosandbox_tpu_torch.serve.paged import (Allocation, BlockPool,
                                               prefix_digests)
from nanosandbox_tpu_torch.serve.scheduler import (SlotScheduler,
                                                   default_buckets)


@dataclass(frozen=True)
class Request:
    """One generation request, in token-id space."""
    rid: int
    prompt: tuple
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None

    @property
    def filters(self) -> bool:
        """Samples from a truncated distribution (needs the sort)."""
        return self.temperature > 0 and (self.top_k > 0 or self.top_p < 1.0)


@dataclass
class Result:
    rid: int
    prompt: tuple
    tokens: List[int]          # generated ids (includes the eos hit, if any)
    finish_reason: str         # 'length' | 'eos' | 'failed'
    prefix_digest: tuple = ()  # prompt blocks donated to the prefix cache


@dataclass
class _Active:
    req: Request
    slot: int
    alloc: Optional[Allocation]             # None on the dense pool
    tokens: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: float = 0.0


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
    device : 'auto' (the GPU; raises without one), 'cuda' or 'cpu'.
    """

    def __init__(self, model: GPT, *, num_slots: int = 8,
                 max_len: Optional[int] = None,
                 kv_dtype: Optional[str] = None, paged: bool = True,
                 kv_page_size: int = 16,
                 kv_pool_blocks: Optional[int] = None,
                 prefix_cache: bool = True, device: str = "auto"):
        if paged and kv_page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1, got "
                             f"{kv_page_size}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        cfg = self.cfg = model.cfg
        self.kv_dtype = kv_mode(cfg, kv_dtype)
        self.num_slots = num_slots
        self.max_len = min(max_len or cfg.block_size, cfg.block_size)
        # Prefill buckets: the power-of-two ladder up to max_len.
        self.sched = SlotScheduler(num_slots, default_buckets(self.max_len))
        self.admit_buckets = self.sched.admit_buckets
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
        self._reset_slot_state()
        if self.device.type == "cuda":
            _build.library()       # build the kernels before any request

        self._active: Dict[int, _Active] = {}        # slot -> state
        self._pending: List[Result] = []             # max_new_tokens == 0
        self._submit_t: Dict[int, float] = {}
        self._rid = itertools.count()
        self.steps = 0
        self.waves = 0
        self.admitted = 0
        self.completed = 0
        self.tokens_generated = 0
        self.rejected: Dict[str, int] = {}
        self._ttft: deque = deque(maxlen=4096)
        self._tpot: deque = deque(maxlen=4096)
        self._rate: deque = deque(maxlen=256)        # (t, tokens read back)

    # ------------------------------------------------------------------
    # device slot state
    # ------------------------------------------------------------------
    def _reset_slot_state(self) -> None:
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
               seed: int = 0, eos_id: Optional[int] = None) -> int:
        """Queue one request; returns its id. Requests the engine can
        never serve are rejected here (ValueError), not mid-flight."""
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
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed), eos_id=eos_id)
        if max_new_tokens == 0:
            self.completed += 1
            self._pending.append(Result(rid, prompt, [], "length"))
            return rid
        self._submit_t[rid] = time.monotonic()
        self.sched.enqueue(req)
        return rid

    def has_work(self) -> bool:
        return bool(self._active or self.sched.queued or self._pending)

    def step(self) -> List[Result]:
        """Admit what fits (one batched prefill per wave), run one batched
        decode step, retire it, and backfill the slots it freed. Returns
        the requests that finished during this call."""
        finished, self._pending = self._pending, []
        with torch.no_grad():
            self._admit_waves(finished)
            if self._active:
                self._decode_step(finished)
                self._admit_waves(finished)
        return finished

    def drain(self) -> List[Result]:
        """Run step() until queue and slots are empty."""
        out: List[Result] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _suffix_bucket(self, req: Request) -> int:
        """The wave key: the bucket of the prompt minus its resident
        prefix, so requests sharing a cached prefix prefill together."""
        return self.sched.bucket_for(
            len(req.prompt) - self.block_pool.match_len(req.prompt))

    def _admit_waves(self, finished: List[Result]) -> None:
        while True:
            if not self.paged:
                wave = self.sched.next_admission_wave()
                if wave is None:
                    return
                reqs, slots, bucket = wave
                self._prefill_wave(reqs, slots, [None] * len(reqs), bucket,
                                   finished)
                continue
            allocs: List[Allocation] = []

            def try_alloc(req: Request) -> bool:
                a = self.block_pool.admit(req.prompt, req.max_new_tokens)
                if a is not None:
                    allocs.append(a)
                return a is not None

            wave = self.sched.next_admission_wave(
                bucket_of=self._suffix_bucket, admit=try_alloc)
            if wave is None:
                return
            reqs, slots, bucket = wave
            self._prefill_wave(reqs, slots, allocs, bucket, finished)

    def _prefill_wave(self, reqs: List[Request], slots: List[int],
                      allocs: List[Optional[Allocation]], bucket: int,
                      finished: List[Result]) -> None:
        """One (rung, bucket) prefill forward — against the paged pool
        from each row's prefix hit on, or into a dense temp cache whose
        first n rows are scattered onto the wave's slots (module
        docstring) — then first tokens sampled from each row's last true
        position with the (seed, true_len) key the decode stream
        continues from."""
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
            hit = a.n_hit * page if a is not None else 0
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
        st = _Active(req=req, slot=slot, alloc=alloc,
                     submit_t=self._submit_t.pop(req.rid),
                     first_token_t=now)
        self._active[slot] = st
        if not 0 <= first_tok < self.cfg.vocab_size:
            finished.append(self._finish(st, "failed"))
            return
        st.tokens.append(first_tok)
        self.tokens_generated += 1
        self._ttft.append(now - st.submit_t)
        done = self._maybe_finish(st)
        if done is not None:
            finished.append(done)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _decode_step(self, finished: List[Result]) -> None:
        """One token for every slot at its own frontier, then retire."""
        logits = self.model(self._tok[:, None], cache=self._pool,
                            cache_index=self._pos,
                            block_table=self._table)[:, 0]
        nxt = sample_token_rows(
            logits, seeds=self._seed, positions=self._pos + 1,
            temperature=self._temp, top_k=self._topk, top_p=self._topp,
            filtered=any(st.req.filters for st in self._active.values()))
        ok = torch.isfinite(logits).all(dim=-1)
        self._pos += self._live.int()
        self._tok = torch.where(self._live & ok, nxt, self._tok)
        host = torch.where(ok, nxt, self.cfg.vocab_size).cpu().tolist()
        self.steps += 1
        now = time.monotonic()
        n_live = 0
        for slot, st in list(self._active.items()):
            tok = host[slot]
            if not 0 <= tok < self.cfg.vocab_size:
                finished.append(self._finish(st, "failed"))
                continue
            st.tokens.append(tok)
            n_live += 1
            done = self._maybe_finish(st)
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
        the full prompt blocks to the prefix cache unless the row failed."""
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
        return Result(rid=st.req.rid, prompt=st.req.prompt,
                      tokens=list(st.tokens), finish_reason=reason,
                      prefix_digest=digest)

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

    def reset_latency_stats(self) -> None:
        self._ttft.clear()
        self._tpot.clear()
        self._rate.clear()

    def stats(self) -> dict:
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
            "tokens_generated": self.tokens_generated,
            "decode_tokens_per_sec": self._recent_rate(),
            "ttft_s": self._pcts(self._ttft),
            "tpot_s": self._pcts(self._tpot),
        }
