"""Per-row token sampling for the serve engine.

The counterpart of sample.py's ``_filter_logits_rows``,
``_sample_token_rows`` and ``row_keys``: each row of a (B, V) logits
batch samples under its own temperature / top-k / top-p, and the token
for position q of a request seeded s depends only on (s, q, logits),
never on which other requests share the batch.

Randomness is counter-based: Gumbel-max over a per-element uniform
drawn from an fmix32 hash of (seed, position, vocab index) — the same
murmur3 finalizer as ops/attention.py's dropout mask. It does not
reproduce JAX's threefry bits; sampled streams are held to the
contract above (and to distribution tests), greedy streams to exact
token identity.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SALT = 0x85EBCA77


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
    u = row_uniforms(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
    return torch.where(t == 0.0, greedy, sampled)
