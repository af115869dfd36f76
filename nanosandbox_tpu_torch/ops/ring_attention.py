"""Ring attention: causal attention over a sequence-parallel process group.

The counterpart of nanosandbox_tpu/ops/ring_attention.py. The sequence
is split over the ranks of the seq group; each rank holds its own rows
of q, k and v, and the K/V chunks rotate around the ring while an exact
merge of (out, lse) block results builds the output: full attention over
the global sequence without any rank holding the global K/V or a
(T, T) score matrix.

Each block is one call of the block primitive, (out_j, lse_j) =
attention(q_blk, k_chunk, v_chunk) (causal on the diagonal, full where
the chunk lies wholly in the query's past), merged exactly:

    lse = logaddexp(lse_a, lse_b)
    out = out_a exp(lse_a - lse) + out_b exp(lse_b - lse)

The block is the flash attention lse call (ops/attention.py
flash_attention_lse[_dropout], through its autograd.Function): on CUDA
tensors the kernels (K4 forward, K5 or K6 + K7 backward with the lse
cotangent), on CPU tensors their plain versions. The tensor's device
alone picks them (the trainer's ``ring_block_impl`` selects nothing,
config.py). Under remat's 'save_attention' policy each block call keeps
its (o, lse), as JAX's tags inside flash_attention_lse do; the rotation
and the merges run again in the recompute, as JAX's untagged ppermutes
do.

Two layouts, as in the JAX package: contiguous (rank i holds rows
[i Tc, (i+1) Tc), and skips the blocks wholly in its future) and zigzag
(rank i holds the half-chunks c_i and c_{2cp-1-i}, one early and one
late, so every rank computes the same number of blocks). JAX takes q, k
and v into zigzag order inside attention; here a rank already holds its
own tokens in its layout's order (``ring_positions``: the loader keeps
those columns and wpe looks up their global positions), which is the
same attention, because everything outside it works on each position
alone and the loss is a sum.

The backward. JAX transposes ppermute; PyTorch's autograd runs no node
whose output reaches no loss, and a point-to-point exchange that one
rank skips hangs its neighbour. So K and V rotate together in ONE
autograd.Function (``_RingKV``) that makes all cp - 1 rotations and
returns every chunk the rank sees, its own at step 0 included. Every
rank uses output 0, so every rank runs its backward, in the same order
in every layer; the backward sends the chunks' gradients back around the
ring and returns the rank's own dK and dV. Every rank takes every
rotation, also where it skips a block.

Dropout: the keep-mask is a hash of GLOBAL (q_pos, k_pos) coordinates,
the per-block offsets riding in the (5,) seed words [seed, b_off, h_off,
q_off, k_off] and the hash running over the global head count and
sequence length (a rank of the model axis holds H / tp heads: its seed
carries their offset and, as a sixth word, the global count), so every
layout, and the non-ring kernel over the whole sequence at hash length
T, drop the same elements.
"""

from __future__ import annotations

import numpy as np
import torch

from nanosandbox_tpu_torch.config import RING_LAYOUTS
from nanosandbox_tpu_torch.ops.attention import (flash_attention_lse,
                                                 flash_attention_lse_dropout)
from nanosandbox_tpu_torch.parallel import distributed

__all__ = ["ring_attention_sharded", "ring_positions", "use_zigzag",
           "zigzag_permutation"]


# ---------------------------------------------------------------------------
# The block and the merge
# ---------------------------------------------------------------------------

def _make_block_fn(sm_scale: float, dropout_rate: float = 0.0,
                   hash_seq_len: int | None = None):
    """block(q, k, v, diag, seed) -> (out f32, lse (B, H, Tq) f32).

    diag=True applies the in-chunk causal mask (q and k share a position
    base); diag=False attends fully (the chunk lies wholly in the past).
    seed: the block's (5,) words with global offsets (None without
    dropout)."""

    def block(q, k, v, diag, seed):
        if dropout_rate > 0.0:
            out, lse = flash_attention_lse_dropout(
                q, k, v, seed, diag, sm_scale, dropout_rate,
                hash_seq_len=hash_seq_len)
        else:
            out, lse = flash_attention_lse(q, k, v, diag, sm_scale)
        return out.float(), lse
    return block


def _merge(carry, blk):
    out_a, lse_a = carry
    out_b, lse_b = blk
    lse = torch.logaddexp(lse_a, lse_b)
    out = (out_a * torch.exp(lse_a - lse)[..., None]
           + out_b * torch.exp(lse_b - lse)[..., None])
    return out, lse


def _block_seed(seed, q_off: int, k_off: int):
    """The words of one block call: the step's seed, the batch and head
    offsets the seed carries (a rank's first row over the data axis, its
    first head over the model axis; none in a (1,) seed), the block's
    global first query and key positions, and a head-sharded seed's
    sixth word, the global head count (ops/attention.py seed_words).
    None without a seed."""
    if seed is None:
        return None
    words = seed.reshape(-1).to(torch.int64)
    offs = torch.tensor([0, 0, q_off, k_off], dtype=torch.int64,
                        device=seed.device)
    bh_off = words[1:3] if words.numel() > 1 else offs[:2]
    return torch.cat([words[:1], bh_off, offs[2:], words[5:]])


# ---------------------------------------------------------------------------
# The rotation
# ---------------------------------------------------------------------------

class _RingKV(torch.autograd.Function):
    """(chunk at step 0, ..., chunk at step cp - 1) of a rank's packed K/V
    chunk: after s rotations a rank holds the chunk of the rank s places
    back. The backward sends each chunk's gradient back to its owner,
    summing on the way: one transposed rotation per forward one."""

    @staticmethod
    def forward(ctx, kv, group, size):
        ctx.group, ctx.size = group, size
        ctx.set_materialize_grads(False)
        chunks = [kv]
        for _ in range(1, size):
            chunks.append(distributed.shift(chunks[-1], 1, group))
        return tuple(chunks)

    @staticmethod
    def backward(ctx, *grads):
        # A chunk whose blocks were all skipped has no gradient (None);
        # its rotation back is taken all the same, with zeros.
        zeros = torch.zeros_like(next(g for g in grads if g is not None))
        acc = grads[-1]
        for s in range(ctx.size - 1, 0, -1):
            acc = distributed.shift(zeros if acc is None else acc, -1,
                                    ctx.group)
            if grads[s - 1] is not None:
                acc = acc + grads[s - 1]
        return acc, None, None


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def use_zigzag(layout: str, causal: bool, cp: int, T: int) -> bool:
    """The JAX package's rule: zigzag only when asked for, causal, over
    more than one rank and with T a multiple of 2 cp; else contiguous."""
    if layout not in RING_LAYOUTS:
        raise ValueError(f"unknown ring layout: {layout!r}")
    return layout == "zigzag" and causal and cp > 1 and T % (2 * cp) == 0


def zigzag_permutation(T: int, cp: int):
    """(idx, inv): x[..., idx, :] puts global rows into zigzag order
    (rank i's rows = [c_i, c_{2cp-1-i}]); x[..., inv, :] undoes it.
    Requires T % (2 cp) == 0."""
    h = T // (2 * cp)
    idx = np.concatenate([
        np.concatenate([np.arange(i * h, (i + 1) * h),
                        np.arange((2 * cp - 1 - i) * h, (2 * cp - i) * h)])
        for i in range(cp)])
    return idx, np.argsort(idx)


def ring_positions(T: int, cp: int, rank: int, layout: str = "zigzag",
                   causal: bool = True) -> np.ndarray:
    """The global positions of the rows rank ``rank`` holds, in its
    order: its contiguous chunk, or its zigzag pair of half-chunks."""
    if T % cp:
        raise ValueError(f"sequence length {T} not divisible by seq axis "
                         f"{cp}")
    Tc = T // cp
    if use_zigzag(layout, causal, cp, T):
        return zigzag_permutation(T, cp)[0][rank * Tc:(rank + 1) * Tc]
    return np.arange(rank * Tc, (rank + 1) * Tc)


# ---------------------------------------------------------------------------
# The ring bodies
# ---------------------------------------------------------------------------

def _contiguous(q, chunks, block, seed, my, cp, causal):
    """Rank ``my`` holds rows [my Tc, (my+1) Tc); the chunk it holds after
    s rotations is rank (my - s)'s. Causal: blocks wholly in the future
    (s > my) are skipped, but their rotation was taken."""
    Tc = q.shape[2]
    q_off = my * Tc
    kv = chunks[0]
    carry = block(q, kv[0, 0], kv[1, 0], causal, _block_seed(seed, q_off,
                                                             q_off))
    for s in range(1, cp):
        if causal and s > my:
            continue
        src = (my - s) % cp
        kv = chunks[s]
        carry = _merge(carry, block(q, kv[0, 0], kv[1, 0], False,
                                    _block_seed(seed, q_off, src * Tc)))
    return carry[0]


def _zigzag(q, chunks, block, seed, my, cp):
    """Rank ``my`` holds half-chunks c_my (early) and c_{2cp-1-my} (late);
    at every step it computes two half-blocks (see the JAX package's
    zigzag_ring_attention)."""
    h = q.shape[2] // 2
    qe, ql = q[:, :, :h].contiguous(), q[:, :, h:].contiguous()
    qe_off, ql_off = my * h, (2 * cp - 1 - my) * h
    kv = chunks[0]
    carry_e = block(qe, kv[0, 0], kv[1, 0], True,
                    _block_seed(seed, qe_off, qe_off))
    carry_l = _merge(block(ql, kv[0, 0], kv[1, 0], False,
                           _block_seed(seed, ql_off, qe_off)),
                     block(ql, kv[0, 1], kv[1, 1], True,
                           _block_seed(seed, ql_off, ql_off)))
    for s in range(1, cp):
        src = (my - s) % cp
        ke_off, kl_off = src * h, (2 * cp - 1 - src) * h
        kv = chunks[s]
        carry_l = _merge(carry_l, block(ql, kv[0, 0], kv[1, 0], False,
                                        _block_seed(seed, ql_off, ke_off)))
        if src < my:
            carry_e = _merge(carry_e, block(qe, kv[0, 0], kv[1, 0], False,
                                            _block_seed(seed, qe_off,
                                                        ke_off)))
        else:
            carry_l = _merge(carry_l, block(ql, kv[0, 1], kv[1, 1], False,
                                            _block_seed(seed, ql_off,
                                                        kl_off)))
    return torch.cat([carry_e[0], carry_l[0]], dim=2)


def ring_attention_sharded(q, k, v, *, group=None, rank: int = 0,
                           size: int = 1, causal: bool = True,
                           sm_scale: float | None = None,
                           layout: str = "zigzag",
                           dropout_rate: float = 0.0, dropout_seed=None
                           ) -> torch.Tensor:
    """Ring attention over the seq group (``size`` ranks; this is rank
    ``rank``): q, k, v are this rank's rows (B, H, T / size, D) of the
    global (B, H, T, D) sequence, in the order ``ring_positions(T, size,
    rank, layout, causal)`` gives; returns its rows of the output, in q's
    dtype. layout 'zigzag' applies when ``use_zigzag`` says so, else the
    contiguous layout runs. dropout_seed: a (1,) per-step seed, the same
    on every rank of the ring, or its (5,) words with a batch offset
    (required when dropout_rate > 0)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("ring attention dropout needs a per-step "
                         "dropout_seed when dropout_rate > 0")
    B, H, Tc, D = q.shape
    T = Tc * size
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    zig = use_zigzag(layout, causal, size, T)
    block = _make_block_fn(sm_scale, float(dropout_rate), T)
    seed = dropout_seed if dropout_rate > 0.0 else None
    # K and V travel as one contiguous (2, halves, B, H, rows, D) buffer,
    # so each block's K and V are contiguous views of it.
    halves = 2 if zig else 1
    kv = torch.stack([x.reshape(B, H, halves, Tc // halves, D).movedim(2, 0)
                      for x in (k, v)]).contiguous()
    if size == 1:
        chunks = (kv,)
    else:
        chunks = _RingKV.apply(kv, group, size)
    if zig:
        out = _zigzag(q, chunks, block, seed, rank, size)
    else:
        out = _contiguous(q.contiguous(), chunks, block, seed, rank, size,
                          causal)
    return out.to(q.dtype)
