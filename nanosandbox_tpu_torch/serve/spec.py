"""Speculative decoding: the fixed-shape batched verify for the Engine.

The counterpart of nanosandbox_tpu/serve/spec.py. A drafter
(serve/drafters.py) guesses the next k tokens of every slot, ONE target
forward scores the (num_slots, k+1) block [current token, d_1 .. d_k]
at each row's own frontier, and rejection sampling keeps the longest
prefix the target agrees with plus one fresh token. Greedy rows
exact-match the raw-logits argmax, so greedy outputs are the
non-speculative engine's token for token.

  * One block shape. Per-row draft LENGTHS are a mask (``draft_len``),
    so a row whose drafter found nothing (draft_len 0) rides the same
    block as a row with k drafts, and emits exactly the token the plain
    decode step would draw from the same logits, key and all, even at
    temperature > 0.
  * Rollback is free. The block writes K/V for all k+1 positions (paged:
    write_paged_kv, past the chain into the drop block; dense: the
    scatter-drop write of models/gpt.py); when a of k drafts are
    accepted the engine's frontier advances a+1 and the stale columns
    past it are overwritten by the next block, which spans them, before
    any query reads them.
  * The paged read is K1 (ops/flash_decode.py flash_prefill_paged) on
    the card; the dense read is the masked attention over the row, as
    JAX's dense verify is its masked-score path, outside any kernel.
  * Sampling. The token for position q is drawn with the (seed, q)
    Gumbel noise of sample.py row_uniforms; the accept coin for q is
    sample.py accept_uniforms(seed, q), a stream of its own. A sampled
    row accepts draft d with probability p_q(d) under its filtered
    distribution (sample.py filter_logits_rows, which the decode step
    samples from too); on the first rejection it resamples from p_q
    with d's mass removed.
  * Poison. A non-finite logit anywhere in a row's block maps its fresh
    token to the out-of-vocab sentinel (vocab_size), which the engine's
    retire detects; the row keeps its input token on the device (an
    out-of-range id would fault the embedding on the card).

On CUDA the verify is one CUDA graph replay: the engine captures two
graphs in its constructor, greedy and sampled (JAX's lax.cond on
whether any row samples; here the host knows the rows' temperatures
and picks), over static buffers: the drafts and draft lengths going in,
and one (num_slots, k+3) block coming out ([emitted (k+1) | count |
accepted]), read back in one copy. K1 runs inside the captured graph.
On the CPU the same body runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nanosandbox_tpu_torch.sample import (NEG_INF, accept_uniforms,
                                          filter_logits_rows, gumbel_argmax)
from nanosandbox_tpu_torch.utils import tracecheck as _tracecheck


class SpecRunner:
    """The drafter, the verify body and its static buffers, and the
    acceptance counters. Built by Engine.__init__ (spec=...); the verify
    reads and advances the engine's slot state tensors in place."""

    def __init__(self, drafter, engine):
        self.drafter = drafter
        self.engine = engine
        self.k = int(drafter.k)
        if self.k < 1:
            raise ValueError(f"drafter k must be >= 1, got {self.k}")
        if engine.max_len < 2:
            raise ValueError("speculative decoding needs max_len >= 2")
        S, dev = engine.num_slots, engine.device
        self.num_slots = S
        self._drafts = torch.zeros((S, self.k), dtype=torch.int64,
                                   device=dev)
        self._dlen = torch.zeros(S, dtype=torch.int64, device=dev)
        self._out = torch.zeros((S, self.k + 3), dtype=torch.int64,
                                device=dev)
        # Token-level acceptance counters (host ints, monotonic).
        self.steps = 0
        self.drafted = 0
        self.accepted = 0

    def register_metrics(self, registry) -> None:
        """Publish the acceptance counters on the engine's registry, as a
        scrape-time mirror of the plain ints (the verify loop never
        touches a metric family)."""
        c_drafted = registry.counter(
            "serve_spec_tokens_drafted_total",
            "Draft tokens proposed to the verify step.")
        c_accepted = registry.counter(
            "serve_spec_tokens_accepted_total",
            "Draft tokens the target model accepted.")
        c_steps = registry.counter(
            "serve_spec_verify_steps_total", "Batched verify dispatches.")
        g_rate = registry.gauge(
            "serve_spec_acceptance_rate",
            "Token-level accepted/drafted over the process lifetime.")

        def collect():
            c_drafted._set_total(self.drafted)
            c_accepted._set_total(self.accepted)
            c_steps._set_total(self.steps)
            # Unconditional: reset_latency_stats zeroes the counts after
            # the warmup, and the gauge must follow.
            g_rate.set(self.accepted / self.drafted if self.drafted
                       else 0.0)

        registry.add_collector(collect)

    def load(self, drafts: Optional[np.ndarray],
             draft_len: np.ndarray) -> None:
        """Stage the next verify's inputs in the static buffers: host
        drafts (None: the device drafter's, already on the card) and the
        per-row draft lengths."""
        if drafts is None:
            self._drafts.copy_(self.drafter.drafts)
        else:
            self._drafts.copy_(torch.from_numpy(drafts))
        self._dlen.copy_(torch.from_numpy(draft_len))

    def body(self, sampled: bool) -> None:
        """One verify over every slot: the block forward, the accept rule
        (greedy, or rejection sampling when ``sampled``), the poison
        sentinel, the output block and the frontier advance, on the
        device alone. What a verify CUDA graph captures."""
        e = self.engine
        S, K = self.num_slots, self.k
        dev = self._drafts.device
        drafts, dlen = self._drafts, self._dlen
        toks_in = torch.cat([e._tok[:, None], drafts], dim=1)
        logits = e.model(toks_in, cache=e._pool, cache_index=e._pos,
                         block_table=e._table)              # (S, K+1, V)
        V = logits.shape[-1]
        greedy = torch.argmax(logits, dim=-1)
        in_len = torch.arange(K, device=dev)[None, :] < dlen[:, None]
        rows = torch.arange(S, device=dev)
        if not sampled:
            accept = (drafts == greedy[:, :K]) & in_len
            a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
            out = greedy[rows, a]
        else:
            t = e._temp
            filt = filter_logits_rows(
                logits.reshape(S * (K + 1), V),
                temperature=t.repeat_interleave(K + 1),
                top_k=e._topk.repeat_interleave(K + 1),
                top_p=e._topp.repeat_interleave(K + 1)).reshape(S, K + 1, V)
            probs = torch.softmax(filt, dim=-1)
            positions = (e._pos.long()[:, None] + 1
                         + torch.arange(K + 1, device=dev)[None, :])
            coin = accept_uniforms(e._seed[:, None].expand(S, K + 1),
                                   positions)
            p_draft = probs[:, :K].gather(-1, drafts[..., None])[..., 0]
            accept = torch.where(t[:, None] == 0.0, drafts == greedy[:, :K],
                                 coin[:, :K] < p_draft) & in_len
            a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
            # The +1 token at offset a: after a rejection, from p_a with
            # the rejected draft's mass removed; after a full accept (or
            # no drafts) a full draw from p_a, the plain decode's draw.
            rejected = a < dlen
            d_a = drafts[rows, a.clamp(max=K - 1)]
            drop = rejected[:, None] & (torch.arange(V, device=dev)[None, :]
                                        == d_a[:, None])
            sample_logits = filt[rows, a].masked_fill(drop, NEG_INF)
            drawn = gumbel_argmax(sample_logits, e._seed, positions[rows, a])
            out = torch.where(t == 0.0, greedy[rows, a], drawn)
        ok = torch.isfinite(logits).all(dim=2).all(dim=1)
        out = torch.where(ok, out, V)
        live = e._live.long()
        off = torch.arange(K + 1, device=dev)[None, :]
        drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])],
                               dim=1)
        emitted = torch.where(off < a[:, None], drafts_pad,
                              torch.where(off == a[:, None], out[:, None],
                                          0))
        self._out[:, :K + 1].copy_(emitted)
        self._out[:, K + 1].copy_((a + 1) * live)
        self._out[:, K + 2].copy_(a * live)
        e._pos += ((a + 1) * live).int()
        e._tok.copy_(torch.where(e._live & ok, out, e._tok))

    def readback(self) -> np.ndarray:
        """The last verify's (num_slots, k+3) output block on the host:
        emitted[:, :k+1] (row r's new tokens are its first count[r]),
        count (accepted + 1 for live rows, 0 for parked ones) at k+1,
        accepted at k+2."""
        return _tracecheck.host_sync("spec-verify-readback",
                                     self._out).numpy()

    def stats(self) -> dict:
        rate: Optional[float] = (self.accepted / self.drafted
                                 if self.drafted else None)
        return {
            "enabled": True,
            "drafter": type(self.drafter).__name__,
            "k": self.k,
            "verify_steps": self.steps,
            "tokens_drafted": self.drafted,
            "tokens_accepted": self.accepted,
            "acceptance_rate": rate,
        }
