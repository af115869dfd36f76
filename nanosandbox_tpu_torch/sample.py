"""Token sampling, and the offline sampler.

The counterpart of nanosandbox_tpu/sample.py:

  * ``sample_token_rows`` (``_filter_logits_rows``, ``_sample_token_rows``
    and ``row_keys`` there): each row of a (B, V) logits batch samples
    under its own temperature / top-k / top-p, and the token for
    position q of a request seeded s depends only on (s, q, logits),
    never on which other requests share the batch;
  * ``generate``: one prefill over the prompt into a dense cache
    (models/gpt.py init_cache; causal attention, K4), then one T = 1
    decode step per token (K3); ``_generate_windowed`` re-forwards the
    sliding context window (K4) when prompt + new tokens exceed
    block_size;
  * ``main``: ``python -m nanosandbox_tpu_torch.sample`` with the JAX
    CLI's flags, from a training out_dir of this port; ``--spec``
    samples through a speculative serve engine instead.

    python -m nanosandbox_tpu_torch.sample --out_dir=out --start="Once" \
        --num_samples=2 --max_new_tokens=100

Randomness is counter-based: Gumbel-max over a per-element uniform
drawn from an fmix32 hash of (seed, position, vocab index) — the same
murmur3 finalizer as ops/attention.py's dropout mask. It does not
reproduce JAX's threefry bits; sampled streams are held to the
contract above (and to distribution tests), greedy streams to exact
token identity. The offline sampler keys sample i of a run seeded s by
(s + i, position); JAX draws all samples from one threefry stream.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SALT = 0x85EBCA77
# The accept coin's stream tag (accept_uniforms): no column hash of
# row_uniforms equals it (v * _GOLDEN mod 2^32 takes this value only at
# v = 1192979645, past any vocabulary).
ACCEPT_STREAM = 0x5BD1E995


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32 values held in int64 (torch has
    no uint32 multiply everywhere); products wrap mod 2^64, whose low 32
    bits are the uint32 product's."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def row_uniforms(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, V) f32 uniforms in (0, 1): element v of row b is a hash of
    (seeds[b], positions[b], v) alone."""
    dev = seeds.device
    s = seeds.long() & _M32
    q = positions.long() & _M32
    row = _fmix32(s ^ _fmix32((q * _GOLDEN + _SALT) & _M32))        # (B,)
    col = (torch.arange(vocab, device=dev, dtype=torch.int64)
           * _GOLDEN) & _M32
    h = _fmix32(_fmix32(row[:, None] ^ col[None, :]))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def accept_uniforms(seeds: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in (0, 1) shaped like ``positions``: the speculative
    verify's accept coin for the token at position q of a request seeded
    s, a hash of (s, q) alone. Its own stream (ACCEPT_STREAM folded into
    the row hash, as JAX folds 1 into the row key), so it never
    correlates with row_uniforms(s, q, .), the Gumbel noise that draws
    the token at q."""
    s = seeds.long() & _M32
    q = positions.long() & _M32
    row = _fmix32(s ^ _fmix32((q * _GOLDEN + _SALT) & _M32))
    h = _fmix32(_fmix32(row ^ ACCEPT_STREAM))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def gumbel_argmax(x: torch.Tensor, seeds: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """(B,) tokens: Gumbel-max over (B, V) temperature-scaled (and
    filtered) logits with the (seed, position) noise of row_uniforms."""
    u = row_uniforms(seeds, positions, x.shape[-1])
    return torch.argmax(x - torch.log(-torch.log(u)), dim=-1)


def filter_logits_rows(logits: torch.Tensor, *, temperature: torch.Tensor,
                       top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-k / nucleus filtering of (B, V) f32
    logits; filtered entries become -1e30. Rows with temperature <= 0
    scale by 1 (their callers take argmax of the raw logits). One shared
    descending sort serves both filters, as in the JAX version: top-k
    only demotes entries below the kth value, so the pre-filter order
    still sorts the nucleus mass."""
    B, V = logits.shape
    t, k, p = temperature.float(), top_k.long(), top_p.float()
    x = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    sort_idx = torch.argsort(x, dim=-1, descending=True)
    srt = torch.gather(x, -1, sort_idx)
    kth = torch.gather(srt, -1, (k.clamp(1, V) - 1)[:, None])
    x = torch.where((k[:, None] > 0) & (x < kth),
                    torch.full_like(x, NEG_INF), x)
    sorted_logits = torch.gather(x, -1, sort_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = (mass_before < p[:, None]) | (p[:, None] >= 1.0)
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    return torch.where(keep, x, torch.full_like(x, NEG_INF))


def sample_token_rows(logits: torch.Tensor, *, seeds: torch.Tensor,
                      positions: torch.Tensor, temperature: torch.Tensor,
                      top_k: torch.Tensor, top_p: torch.Tensor,
                      filtered: bool = True) -> torch.Tensor:
    """(B,) int64 tokens from (B, V) logits. temperature 0 rows take the
    argmax of the raw logits; the others sample their filtered
    distribution by Gumbel-max with noise keyed by (seed, position).
    ``filtered=False`` is the caller's promise that no sampling row
    truncates (top_k 0, top_p 1): the sort is skipped, the result is
    the same."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    t = temperature.float()
    if filtered:
        x = filter_logits_rows(logits, temperature=t, top_k=top_k,
                               top_p=top_p)
    else:
        x = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
    return torch.where(t == 0.0, greedy, gumbel_argmax(x, seeds, positions))


# ---------------------------------------------------------------------------
# The offline sampler
# ---------------------------------------------------------------------------

class _RowSampler:
    """One sampling setting for every row of a generate() batch; row i's
    noise is keyed by (seed + i, position)."""

    def __init__(self, batch: int, *, temperature: float, top_k: int,
                 top_p: float, seed: int, device):
        def full(value, dtype):
            return torch.full((batch,), value, dtype=dtype, device=device)

        self.kw = dict(temperature=full(float(temperature), torch.float32),
                       top_k=full(int(top_k), torch.int64),
                       top_p=full(float(top_p), torch.float32),
                       filtered=temperature > 0 and (top_k > 0
                                                     or top_p < 1.0))
        self.seeds = seed + torch.arange(batch, device=device)

    def __call__(self, logits: torch.Tensor, position: int) -> torch.Tensor:
        positions = torch.full_like(self.seeds, position)
        return sample_token_rows(logits, seeds=self.seeds,
                                 positions=positions, **self.kw)


@torch.no_grad()
def generate(model, idx: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, block_size: Optional[int] = None) -> torch.Tensor:
    """(B, T0 + max_new_tokens) token ids: idx followed by its samples.
    Temperature 0 is greedy. KV-cached: one prefill over the prompt into
    a (B, H, T0 + max_new_tokens, D) cache in the compute dtype, then one
    single-token step per new token against it, so attention reads grow
    with the frontier instead of re-running the context. Falls back to
    the windowed path only when the total exceeds block_size (wpe
    defines no positions past it)."""
    from nanosandbox_tpu_torch.models.gpt import init_cache

    block_size = block_size or model.cfg.block_size
    B, T0 = idx.shape
    total = T0 + max_new_tokens
    if max_new_tokens == 0:
        return idx
    sampler = _RowSampler(B, temperature=temperature, top_k=top_k,
                          top_p=top_p, seed=seed, device=idx.device)
    if total > block_size:
        return _generate_windowed(model, idx, max_new_tokens, sampler,
                                  block_size)
    cache = init_cache(model.cfg, B, total, device=idx.device)
    tok = sampler(model(idx, cache=cache, cache_index=0)[:, -1], T0)
    out = [tok]
    for i in range(T0, total - 1):
        logits = model(tok[:, None], cache=cache, cache_index=i)[:, 0]
        tok = sampler(logits, i + 1)
        out.append(tok)
    return torch.cat([idx, torch.stack(out, dim=1)], dim=1)


def _generate_windowed(model, idx: torch.Tensor, max_new_tokens: int,
                       sampler: _RowSampler,
                       block_size: int) -> torch.Tensor:
    """Full-forward sliding-window decode (nanoGPT's crop-and-reforward
    semantics): each token re-runs the last block_size known tokens
    through the no-cache forward (K4). JAX pads the window to
    block_size with zeros past the frontier; causal attention makes
    those positions irrelevant, so only the known tokens are run."""
    B, T0 = idx.shape
    buf = torch.zeros((B, T0 + max_new_tokens), dtype=idx.dtype,
                      device=idx.device)
    buf[:, :T0] = idx
    for i in range(T0 - 1, T0 - 1 + max_new_tokens):
        start = max(i + 1 - block_size, 0)
        logits = model(buf[:, start:i + 1])[:, -1]
        buf[:, i + 1] = sampler(logits, i + 1)
    return buf


def resolve_start(start: str) -> str:
    """nanoGPT's --start convention: 'FILE:<path>' reads the prompt from a
    file (verbatim, trailing newline included); anything else is the
    prompt text itself."""
    if start.startswith("FILE:"):
        with open(start[len("FILE:"):], "r", encoding="utf-8") as f:
            return f.read()
    return start


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser(prog="python -m nanosandbox_tpu_torch.sample")
    ap.add_argument("--out_dir", default="out",
                    help="a training out_dir of this port (ckpt/<step>/)")
    ap.add_argument("--data_dir", default="",
                    help="dataset root holding <dataset>/meta.pkl; empty = "
                         "the checkpoint's training data_dir")
    ap.add_argument("--dataset", default="",
                    help="empty = the checkpoint's training dataset")
    ap.add_argument("--start", default="\n",
                    help="prompt text, or FILE:<path> to read it from a "
                         "file (nanoGPT convention)")
    ap.add_argument("--num_samples", type=int, default=1)
    ap.add_argument("--max_new_tokens", type=int, default=200)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="0 = greedy")
    ap.add_argument("--top_k", type=int, default=40)
    ap.add_argument("--top_p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--seed", type=int, default=1337,
                    help="sample i draws its noise from seed + i")
    ap.add_argument("--spec", default="off",
                    help="speculative decoding through the serve engine's "
                         "batched verify: 'ngram' or 'model:<out_dir>' "
                         "(needs prompt + max_new_tokens <= block_size)")
    ap.add_argument("--spec_k", type=int, default=4,
                    help="draft tokens per verify step (--spec only)")
    ap.add_argument("--device", default="auto",
                    help="auto (the GPU; raises without one) | cuda | cpu")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    if args.num_samples < 1:
        ap.error(f"--num_samples must be >= 1, got {args.num_samples}")
    # Fail fast on a bad --start=FILE:<path>, before loading a model.
    start_text = resolve_start(args.start)

    from nanosandbox_tpu_torch.checkpoint import TrainCheckpointer
    from nanosandbox_tpu_torch.config import (GPTConfig, TrainConfig,
                                              resolve_device)
    from nanosandbox_tpu_torch.data.tokenizer import tokenizer_for_dataset
    from nanosandbox_tpu_torch.models.gpt import GPT, cast_for_serving

    device = resolve_device(args.device)
    blob = TrainCheckpointer(args.out_dir).restore()     # the newest step
    tcfg = TrainConfig(**blob["config"])
    cfg = GPTConfig.from_train_config(tcfg,
                                      blob["model"]["wte.weight"].shape[0])
    model = GPT(cfg, device=device)
    model.load_state_dict(blob["model"])
    cast_for_serving(model).eval()
    tok = tokenizer_for_dataset(args.data_dir or tcfg.data_dir,
                                args.dataset or tcfg.dataset)
    start_ids = tok.encode(start_text) or [0]
    if args.spec != "off":
        return _spec_samples(ap, args, model, tok, start_ids, device)
    idx = torch.tensor([start_ids] * args.num_samples, dtype=torch.int64,
                       device=device)
    out = generate(model, idx, args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, seed=args.seed,
                   block_size=cfg.block_size)
    texts = []
    for row in out.cpu().tolist():      # one readback for every sample
        text = tok.decode(row)
        texts.append(text)
        print(text)
        print("---------------")
    return texts


def _spec_samples(ap, args, model, tok, start_ids, device) -> list[str]:
    """--spec: the samples through a spec engine of min(num_samples, 8)
    slots (serve/engine.py), sample i seeded seed + i as in generate.
    Bounded to the cached regime: the windowed fallback has no frontier
    to verify against."""
    from nanosandbox_tpu_torch.serve.drafters import drafter_from_flag
    from nanosandbox_tpu_torch.serve.engine import Engine

    total = len(start_ids) + args.max_new_tokens
    if total > model.cfg.block_size:
        ap.error(f"--spec needs prompt + max_new_tokens <= block_size "
                 f"({total} > {model.cfg.block_size}); drop --spec to use "
                 "the windowed fallback")
    drafter = drafter_from_flag(args.spec, k=args.spec_k, device=device)
    engine = Engine(model, num_slots=min(args.num_samples, 8),
                    max_len=model.cfg.block_size, spec=drafter,
                    device=device)
    rids = [engine.submit(start_ids, args.max_new_tokens,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.seed + i)
            for i in range(args.num_samples)]
    res = {r.rid: r for r in engine.drain()}
    texts = []
    for rid in rids:
        text = tok.decode(list(res[rid].prompt) + res[rid].tokens)
        texts.append(text)
        print(text)
        print("---------------")
    s = engine.stats()
    print(f"[spec] drafter={s['spec']['drafter']} k={s['spec']['k']} "
          f"acceptance_rate={s['spec_acceptance_rate']} "
          f"accepted_len_mean={s['spec_accepted_len_mean']}",
          file=sys.stderr)
    return texts


if __name__ == "__main__":
    main()
