"""Draft-token proposers for speculative decoding (serve/spec.py).

The counterpart of nanosandbox_tpu/serve/drafters.py. A drafter guesses
the next ``k`` tokens of a request cheaply; the verify then keeps the
longest prefix the target agrees with, so a wrong draft costs only the
draft work. Two backends, one protocol (``kind``, ``k``; a host drafter
also has ``propose(context, max_tokens)``, so tests can plug in scripted
ones):

  * ``NGramDrafter`` (kind 'host'): prompt lookup. The request's own
    context is scanned for the most recent earlier occurrence of its
    trailing n-gram, and the tokens that followed it are proposed. No
    weights, no device work.
  * ``ModelDrafter`` (kind 'device'): a GPT sharing the target's
    vocabulary, run greedily for k+1 single-token steps against its OWN
    pool, in the engine's kv_dtype. Its frontier is the engine's slot
    state (pos, tok, live), so a rollback is the engine not advancing
    pos. A paged engine's drafter pool is indexed by the same block ids
    as the target's (one block table, two pools), so a prefix hit skips
    the drafter's prefill of the prefix too. Its prefill runs at each
    admission (and each chunked-prefill piece) with the engine's staged
    operands; on CUDA the engine captures its k+1 draft steps as one
    graph.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch


class NGramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the context's trailing n-gram.

    ``max_ngram`` is the longest suffix tried (longest first); the most
    recent earlier occurrence wins. A match at distance d from the end
    supplies d literal tokens, and the proposal cycles them up to the
    budget (exact for text of period d, e.g. a greedy loop). Returns []
    on no match: the engine then verifies that row with draft length 0,
    one ordinary decode step."""

    kind = "host"

    def __init__(self, k: int = 4, max_ngram: int = 3):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.k = int(k)
        self.max_ngram = int(max_ngram)

    def propose(self, context: Sequence[int],
                max_tokens: Optional[int] = None) -> List[int]:
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        n_ctx = len(context)
        if cap <= 0 or n_ctx < 2:
            return []
        context = list(context)
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            suffix = context[n_ctx - n:]
            for start in range(n_ctx - n - 1, -1, -1):
                if context[start:start + n] == suffix:
                    m = start + n          # continuation begins here
                    d = n_ctx - m          # literal tokens before the end
                    return [context[m + i % d] for i in range(cap)]
        return []


class ModelDrafter:
    """A GPT of the same vocabulary drafting k tokens greedily against
    its own pool. Construction takes the model (weights in their serving
    dtype, models/gpt.py cast_for_serving) and k; the engine calls
    ``build`` with its slot geometry, then ``prefill`` after each of its
    own prefill forwards and ``steps`` (or its captured graph) before
    each verify. ``drafts`` (num_slots, k) holds the last proposal."""

    kind = "device"

    def __init__(self, model, k: int = 4):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.model = model
        self.k = int(k)
        self.pool = None
        self.drafts: Optional[torch.Tensor] = None
        self.paged = False

    def build(self, *, target_cfg, num_slots: int, max_len: int,
              kv_dtype, paged: bool, kv_page_size: int,
              kv_pool_blocks: int, device: torch.device) -> None:
        """Check the model against the target and allocate the pool: a
        parallel (kv_pool_blocks + 1, H, page, D) block pool under a
        paged engine (the same drop block index), else one max_len row
        per slot; in the engine's kv_dtype either way."""
        from nanosandbox_tpu_torch.models.gpt import (init_cache,
                                                      init_paged_cache)

        dcfg = self.model.cfg
        if dcfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"drafter vocab_size {dcfg.vocab_size} != target "
                f"vocab_size {target_cfg.vocab_size}: speculative drafts "
                "are token ids, so the models must share one tokenizer")
        if dcfg.block_size < max_len:
            raise ValueError(
                f"drafter block_size {dcfg.block_size} < engine max_len "
                f"{max_len}: the drafter must hold every slot frontier "
                "the target can reach")
        self.model = self.model.to(device).eval()
        self.paged = bool(paged)
        self.pool = (init_paged_cache(dcfg, kv_pool_blocks, kv_page_size,
                                      kv_dtype, device=device)
                     if self.paged else
                     init_cache(dcfg, num_slots, max_len, kv_dtype,
                                device=device))
        self.drafts = torch.zeros((num_slots, self.k), dtype=torch.int64,
                                  device=device)

    def prefill(self, tokens: torch.Tensor, *, cache_index=None,
                block_table=None, slots=None, n: int = 0) -> None:
        """Ingest a prefill's (rows, bucket) tokens into the drafter pool,
        with the engine's staged operands: paged, the suffix at per-row
        ``cache_index`` through ``block_table`` (padding rows carry the
        sentinel table and drop); dense, a temp cache at index 0 whose
        first ``n`` rows are scattered onto ``slots``."""
        from nanosandbox_tpu_torch.models.gpt import (init_cache,
                                                      scatter_cache_rows)

        if self.paged:
            self.model.hidden(tokens, cache=self.pool,
                              cache_index=cache_index,
                              block_table=block_table)
            return
        temp = init_cache(self.model.cfg, tokens.shape[0], tokens.shape[1],
                          device=tokens.device)
        self.model.hidden(tokens, cache=temp, cache_index=0)
        scatter_cache_rows(self.pool,
                           [tuple(x[:n] for x in layer) for layer in temp],
                           slots)

    def steps(self, tok: torch.Tensor, pos: torch.Tensor,
              live: torch.Tensor, table: Optional[torch.Tensor]) -> None:
        """k+1 greedy single-token steps over every slot from the
        engine's frontiers, the first k predictions into ``drafts``.
        Parked rows keep their pos and token. The extra step writes the
        k-th draft's K/V at pos + k: after a full accept the next call's
        queries read that column, which no later write would fill."""
        t, p = tok.clone(), pos.clone()
        for j in range(self.k + 1):
            logits = self.model(t[:, None], cache=self.pool, cache_index=p,
                                block_table=table)[:, 0]
            t = torch.where(live, torch.argmax(logits, dim=-1), t)
            p = p + live.int()
            if j < self.k:
                self.drafts[:, j].copy_(t)

    def zero_pool(self) -> None:
        """Zero every pool tensor in place (the engine's flush)."""
        for layer in self.pool:
            for buf in layer:
                buf.zero_()


def drafter_from_flag(spec: str, *, k: int = 4, device="cpu"):
    """The CLIs' --spec: 'off' / '' / 'none' -> None, 'ngram' ->
    NGramDrafter, 'model:<out_dir>' -> a ModelDrafter over that
    directory's weights: its serving.pt (checkpoint.save_for_serving),
    else its newest training checkpoint, cast to the compute dtype."""
    if spec in ("", "off", "none"):
        return None
    if spec == "ngram":
        return NGramDrafter(k=k)
    if spec.startswith("model:"):
        from nanosandbox_tpu_torch.checkpoint import (FILENAME,
                                                      TrainCheckpointer,
                                                      load_for_serving)
        from nanosandbox_tpu_torch.config import GPTConfig, TrainConfig
        from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving

        out_dir = spec[len("model:"):]
        if not out_dir:
            raise ValueError("--spec=model:<out_dir> needs a checkpoint dir")
        if os.path.exists(os.path.join(out_dir, FILENAME)):
            cfg, state = load_for_serving(out_dir)
        else:
            blob = TrainCheckpointer(out_dir).restore()
            state = blob["model"]
            cfg = GPTConfig.from_train_config(
                TrainConfig(**blob["config"]), state["wte.weight"].shape[0])
        model = GPT(cfg, device=device)
        model.load_state_dict(state)
        return ModelDrafter(cast_for_serving(model).eval(), k=k)
    raise ValueError(
        f"unknown --spec value {spec!r} (expected off, ngram, or "
        "model:<out_dir>)")
