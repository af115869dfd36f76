"""Decoder-only GPT in PyTorch: the port of models/gpt.py.

Same model contract as the JAX package's flax GPT: learned positional
embeddings, pre-LayerNorm blocks (f32 LayerNorm, eps 1e-5), causal
self-attention with [q|k|v] packed in one projection, a 4x tanh-GELU
MLP, optional biases, and an LM head tied to ``wte``. Matmuls run in
``cfg.compute_dtype``; the weights are stored in ``cfg.param_dtype``
(training) or already cast to the compute dtype (serving, which halves
the bytes the weight-read-bound decode step streams).

Two forward paths:

  * no cache (training, evaluation, the reference recompute): causal
    attention through ops/attention.py — the flash kernels on CUDA
    tensors, the plain version on CPU tensors. Under sequence parallelism
    (cfg.attention_impl 'ring' and a ``mesh`` whose seq axis is larger
    than 1) the model holds this rank's tokens only, in the ring layout's
    order (ops/ring_attention.py ring_positions): wpe looks up their
    global positions and attention is ring attention over the seq group;
    each rank's loss is its share of the sums over every rank's tokens
    (``shared_mean``).
    ``plain_attention=True`` asks for the plain version on any device;
    only comparison harnesses pass it (its CUDA calls show in
    attention.plain_cuda_calls), and a ring forward refuses it. With a
    ``dropout_generator`` and cfg.dropout > 0 the forward trains: residual
    dropout where flax has it (after the embedding sum, after attention's
    c_proj, after the MLP's c_proj) with masks drawn from the generator,
    and attention-probability dropout in the kernels, keyed by a uint32
    seed per layer drawn from the same generator. Under sequence
    parallelism every rank draws the GLOBAL (B, T, C) mask and keeps its
    own positions' rows, so the masks are one process's and every rank
    draws as many numbers, which keeps the attention seeds shared; a rank
    that holds rows of the batch (the data and fsdp axes) keeps its rows
    of the global mask, and its attention seed words carry their first
    row as the batch offset the kernels hash. With cfg.remat (or FSDP) a
    forward that records gradients runs each block under
    torch.utils.checkpoint (``_RematBlock``; the cached path and
    no-grad evaluation never do);
  * paged cache: each layer's pool is (num_blocks + 1, H, page, D). The
    call writes its K/V through the block table first, then attends with
    the paged-attention kernels (ops/flash_decode.py): the decode kernel
    for T = 1, the prefill kernel for T > 1;
  * dense cache (init_cache): each layer's pool is (B, H, max_len, D),
    one row per slot or sample. With a per-row ``cache_index`` (B,) and
    T = 1 (the dense engine's decode step) each row writes at its own
    position and K3 (flash_decode) attends up to it; with a scalar
    ``cache_index`` i and T = 1 (the sampler's decode step) every row
    writes at i and K3 attends over [0, i]; with i == 0 and T > 1 (a
    prefill into a fresh cache) the call writes [0, T) and attends
    causally over its own keys through causal_attention (K4); with a
    per-row ``cache_index`` and T > 1 (the speculative verify block)
    row b writes positions cache_index[b] + [0, T) with drop semantics
    (columns past the buffer are discarded, never shifted back onto
    valid history) and attends through the masked attention over the
    whole buffer (ops/flash_decode.py masked_cache_attention, JAX's
    masked-score path: no kernel there either). A T > 1 call at a
    nonzero scalar index is not ported yet.

Each pool layer is (K, V) in fp32 or bf16, or (K, V, k_scale, v_scale)
for the quantized modes: int8 values, or packed int4 (uint8, two nibbles
per byte along head_dim), with one f32 scale per (row|block, head,
position). Writes quantize on the way in (ops/flash_decode.py
quantize_kv_rows[_int4]), so fp K/V never reaches a quantized pool, and
the kernels fold the scales into scores and probabilities. Pools are
updated IN PLACE (JAX returns a new pool; here that would copy the whole
pool every step).

The paged pool's last block (index num_blocks, the engine's sentinel
value) is a drop block: writes bound for the sentinel — parked rows,
ladder padding, positions past a row's chain — land there instead of
being filtered out, so the write needs neither a host sync (a boolean
mask would) nor an out-of-range index (which raises a device-side assert
on CUDA where JAX's scatter drops). No table entry of a live request
ever names it, and the kernels only read it for sentinel entries, whose
positions are past every frontier. Writes bound for it skip the
quantizer's scale chain (``valid=``), as JAX's do.

The losses (``cross_entropy_loss``, ``chunked_cross_entropy_loss``) and
``count_params`` are the JAX module's, in the same logsumexp form.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nanosandbox_tpu_torch.config import DTYPES, GPTConfig
from nanosandbox_tpu_torch.ops.attention import (SavedAttention,
                                                 causal_attention,
                                                 saving_attention,
                                                 torch_flash_attention)
from nanosandbox_tpu_torch.ops.flash_decode import (KV_MODES, KV_STORAGE,
                                                    flash_decode,
                                                    flash_decode_paged,
                                                    flash_prefill_paged,
                                                    masked_cache_attention,
                                                    quantize_kv_rows,
                                                    quantize_kv_rows_int4)
from nanosandbox_tpu_torch.ops.ring_attention import (ring_attention_sharded,
                                                      ring_positions)
from nanosandbox_tpu_torch.parallel import distributed
from nanosandbox_tpu_torch.parallel.tensor import (copy_to_model,
                                                   reduce_from_model)

# Per layer: (K, V) or, quantized, (K, V, k_scale, v_scale).
KVPool = List[Tuple[torch.Tensor, ...]]


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
           bias: bool = True):
    """flax Dense(dtype=compute): inputs and weights in the compute dtype.
    ``bias=False`` leaves the bias out: a row-parallel partial product,
    whose bias is added once after the sum (_row_parallel)."""
    b = lin.bias.to(dtype) if bias and lin.bias is not None else None
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


def _row_parallel(lin: nn.Linear, partials: list, dtype: torch.dtype,
                  group=None) -> torch.Tensor:
    """A row-parallel projection's output from its shards' partial
    products: summed in shard order (shard 0 first) or, one partial a
    rank, over the model group (parallel/tensor.py reduce_from_model),
    then the bias added once."""
    if group is not None:
        y = reduce_from_model(partials[0], group)
    else:
        y = partials[0]
        for part in partials[1:]:
            y = y + part
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 whatever the storage dtype (models/gpt.py:33)."""
    b = ln.bias.float() if ln.bias is not None else None
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), b,
                        ln.eps)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator],
             spread: Optional[tuple] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, kept values
    scaled by 1 / (1 - rate); the identity without a generator. spread
    (B_global, row0, T_global, positions (T,) or None): x holds rows
    [row0, row0 + B) of the micro-batch and these positions of each row
    (None: all of them), so the mask is drawn for the whole (B_global,
    T_global, C) and x's part kept."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    B, T, C = x.shape
    if spread is None:
        u = torch.rand((B, T, C), generator=generator, device=x.device)
    else:
        rows, row0, cols, pos = spread
        u = torch.rand((rows, cols, C), generator=generator,
                       device=x.device)[row0:row0 + B]
        if pos is not None:
            u = u[:, pos]
    return torch.where(u < keep_prob, x / keep_prob, 0.0)


def _attention_seed(generator: torch.Generator, device,
                    spread: Optional[tuple] = None,
                    heads: Optional[tuple] = None) -> torch.Tensor:
    """One uint32 dropout seed (as int64) drawn on the generator's device:
    no host sync on the training path. A rank that holds rows from row0
    on (spread) gets the (5,) seed words with that batch offset, so the
    kernels hash the rows' global indices; a rank that holds heads
    [h_off, h_off + H_local) of H (``heads`` = (h_off, H), the model
    axis) gets the head offset and, as a sixth word, the H the stream is
    linearised over (ops/attention.py seed_words)."""
    seed = torch.randint(0, 2**32, (1,), generator=generator,
                         device=device, dtype=torch.int64)
    row0 = 0 if spread is None else spread[1]
    if row0 == 0 and heads is None:
        return seed
    words = [row0, 0 if heads is None else heads[0], 0, 0]
    if heads is not None:
        words.append(heads[1])
    return torch.cat([seed, torch.tensor(words, dtype=torch.int64,
                                         device=device)])


def _to_pool(layer, k: torch.Tensor, v: torch.Tensor, valid=None):
    """(B, H, T, D) K/V in the layer's representation: values cast to
    the pool dtype, or quantized (with scales (B, H, T)) for a 4-tuple
    layer. ``valid`` (broadcastable to (B, H, T)) as in the quantizers."""
    if len(layer) == 2:
        return k.to(layer[0].dtype), v.to(layer[1].dtype), None, None
    quantize = (quantize_kv_rows_int4 if layer[0].dtype == torch.uint8
                else quantize_kv_rows)
    (kq, ks), (vq, vs) = quantize(k, valid=valid), quantize(v, valid=valid)
    return kq, vq, ks, vs


def write_paged_kv(layer, k: torch.Tensor, v: torch.Tensor,
                   block_table: torch.Tensor,
                   cache_index: torch.Tensor) -> None:
    """Write (B, H, T, D) K/V at positions cache_index[b] + [0, T) of
    each row's chain: position p of row b lands in block
    table[b, p // page] at offset p % page. Positions past the chain or
    bound for a sentinel entry go to the drop block (module docstring),
    and skip the quantizer's scale chain."""
    pool_k = layer[0]
    drop = pool_k.shape[0] - 1
    page = pool_k.shape[2]
    B, H, T, _ = k.shape
    nb = block_table.shape[1]
    qpos = (cache_index.long()[:, None]
            + torch.arange(T, device=k.device)[None, :])          # (B, T)
    jblk = qpos // page
    blk = block_table.long().gather(1, jblk.clamp(max=nb - 1))
    blk = torch.where((jblk < nb) & (blk >= 0) & (blk < drop), blk, drop)
    vals = _to_pool(layer, k, v, valid=(blk < drop)[:, None, :])
    bf, of = blk.reshape(-1), (qpos % page).reshape(-1)
    for buf, x in zip(layer, vals):
        if x.dim() == 4:                          # values (B, H, T, D')
            buf[bf, :, of, :] = x.transpose(1, 2).reshape(B * T, H, -1)
        else:                                     # scales (B, H, T)
            buf[bf, :, of] = x.transpose(1, 2).reshape(B * T, H)


def write_dense_kv(layer, k: torch.Tensor, v: torch.Tensor,
                   cache_index) -> None:
    """Write (B, H, T, D) K/V into a dense (B, H, L, D') layer: a scalar
    ``cache_index`` i writes positions [i, i + T) of every row; a (B,)
    one with T = 1 writes row b at its own position cache_index[b],
    clamped to L - 1 as JAX's per-row dynamic_update_slice clamps it. A
    row past L is one that rides a pipelined or scan_k chunk after its
    budget: its write lands in its own row's last position, which no
    token of its budget reads (plen + max_new <= L, so the last useful
    step writes position L - 2), and K3 clamps its length to L. A (B,)
    one with T > 1 (the verify block) writes row b at cache_index[b] +
    [0, T) with JAX's scatter-drop semantics (_write_dense_block)."""
    vals = _to_pool(layer, k, v)
    if isinstance(cache_index, int):
        T = k.shape[2]
        for buf, x in zip(layer, vals):
            buf[:, :, cache_index:cache_index + T] = x
        return
    if k.shape[2] > 1:
        _write_dense_block(layer, vals, cache_index)
        return
    rows = torch.arange(k.shape[0], device=k.device)
    pos = cache_index.long().clamp(max=layer[0].shape[2] - 1)
    for buf, x in zip(layer, vals):
        buf[rows, :, pos] = x[:, :, 0]


def _write_dense_block(layer, vals, cache_index: torch.Tensor) -> None:
    """Row b's T columns at cache_index[b] + [0, T), columns past L
    dropped (JAX's .at[...].set(mode='drop')), without a host sync or a
    data-dependent shape: a dropped column is redirected to the row's
    first column and carries that column's own new value (or, for a row
    whose start is itself past L, the value already at L - 1), so every
    duplicate index writes identical values and nothing outside the
    block changes. The start is never clamped: a clamped block would
    shift backwards over valid history."""
    B, _, T = vals[0].shape[:3]
    L = layer[0].shape[2]
    dev = cache_index.device
    start = cache_index.long()
    cols = start[:, None] + torch.arange(T, device=dev)[None, :]   # (B, T)
    first = start.clamp(max=L - 1)
    tgt = torch.where(cols < L, cols, first[:, None])
    rows = torch.arange(B, device=dev)
    inside = (start < L)[:, None, None]
    for buf, x in zip(layer, vals):
        x = x.transpose(1, 2)                         # (B, T, H[, D'])
        old = buf[rows, :, L - 1]                     # (B, H[, D'])
        fill = torch.where(inside.view(B, *([1] * (x.dim() - 2))),
                           x[:, 0], old)
        x = torch.where((cols < L).view(B, T, *([1] * (x.dim() - 2))), x,
                        fill[:, None])
        buf[rows[:, None], :, tgt] = x


def _scales(layer) -> dict:
    return ({} if len(layer) == 2
            else {"k_scale": layer[2], "v_scale": layer[3]})


def _ring(cfg: GPTConfig, mesh) -> bool:
    """Whether the no-cache forward runs ring attention over mesh's seq
    group (a ring over one rank is causal attention over the row)."""
    return (cfg.attention_impl == "ring" and mesh is not None
            and mesh.seq > 1)


def _tp(mesh) -> tuple:
    """(degree, index) of a mesh's model axis; (1, 0) without one."""
    return (mesh.model, mesh.model_index) if mesh is not None else (1, 0)


class CausalSelfAttention(nn.Module):
    """Attention over the heads of one model shard: all H at ``tp`` (1, 0);
    heads [i H/tp, (i+1) H/tp) at (tp, i), with c_attn's rows of those
    heads and c_proj's columns (parallel/tensor.py). Under a mesh whose
    model axis is larger than 1 the forward sums c_proj's partial product
    over the model group; a single-controller model (ShardedBlock) calls
    ``attend`` and ``partial`` of each shard and sums them itself."""

    def __init__(self, cfg: GPTConfig, mesh=None, tp: tuple = (1, 0),
                 **factory):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tp, self.tp_index = tp
        self.n_head = cfg.n_head // self.tp
        C, Cl = cfg.n_embd, cfg.n_embd // self.tp
        self.c_attn = nn.Linear(C, 3 * Cl, bias=cfg.bias, **factory)
        self.c_proj = nn.Linear(Cl, C, bias=cfg.bias, **factory)

    def forward(self, x, cache=None, cache_index=None, block_table=None,
                generator=None, plain_attention=False, spread=None):
        cfg = self.cfg
        dtype = cfg.torch_compute_dtype
        if self.tp == 1:
            y = self.attend(x, cache, cache_index, block_table, generator,
                            plain_attention, spread)
            return _dropout(_dense(self.c_proj, y, dtype), cfg.dropout,
                            generator, spread)
        group = self.mesh.model_group
        y = self.attend(copy_to_model(x, group), cache, cache_index,
                        block_table, generator, plain_attention, spread)
        return _dropout(_row_parallel(self.c_proj, [self.partial(y)],
                                      dtype, group),
                        cfg.dropout, generator, spread)

    def partial(self, y: torch.Tensor) -> torch.Tensor:
        """c_proj's product over this shard's heads, without the bias."""
        return _dense(self.c_proj, y, self.cfg.torch_compute_dtype,
                      bias=False)

    def attend(self, x, cache=None, cache_index=None, block_table=None,
               generator=None, plain_attention=False, spread=None):
        """(B, T, C / tp): this shard's heads' attention output, before
        c_proj."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = self.n_head, cfg.head_dim
        dtype = cfg.torch_compute_dtype
        q, k, v = _dense(self.c_attn, x, dtype).split(H * D, dim=-1)
        q = q.view(B, T, H, D).transpose(1, 2)        # (B, H, T, D)
        k = k.view(B, T, H, D).transpose(1, 2)
        v = v.view(B, T, H, D).transpose(1, 2)
        if cache is None:
            rate, seed = 0.0, None
            if generator is not None and cfg.dropout > 0.0:
                heads = (None if self.tp == 1
                         else (self.tp_index * H, cfg.n_head))
                rate, seed = cfg.dropout, _attention_seed(
                    generator, x.device, spread, heads)
            if _ring(cfg, self.mesh):
                m = self.mesh
                y = ring_attention_sharded(
                    q, k, v, group=m.seq_group, rank=m.seq_index,
                    size=m.seq, layout=cfg.ring_layout, dropout_rate=rate,
                    dropout_seed=seed)
            elif plain_attention:
                y = torch_flash_attention(q, k, v, dropout_rate=rate,
                                          seed=seed)[0]
            else:
                y = causal_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), dropout_rate=rate,
                                     seed=seed)
        elif block_table is not None:
            # The pool must hold this call's K/V before the kernel reads
            # it: decode attends up to cache_index + 1 positions, prefill
            # from cache_index on (the resident prefix included).
            write_paged_kv(cache, k, v, block_table, cache_index)
            ck, cv = cache[0], cache[1]
            if T == 1:
                y = flash_decode_paged(q[:, :, 0].contiguous(), ck, cv,
                                       block_table, cache_index + 1,
                                       **_scales(cache))[:, :, None]
            else:
                y = flash_prefill_paged(q.contiguous(), ck, cv, block_table,
                                        cache_index, **_scales(cache))
        else:
            y = self._dense_cached(q, k, v, cache, cache_index)
        return y.transpose(1, 2).reshape(B, T, H * D)

    @staticmethod
    def _dense_cached(q, k, v, cache, cache_index):
        """Attention through a dense (B, H, L, D) cache (module
        docstring); the write comes first, as on the paged path."""
        B, H, T, _ = q.shape
        per_row = not isinstance(cache_index, int)
        if T == 1:
            write_dense_kv(cache, k, v, cache_index)
            lengths = (cache_index + 1 if per_row else torch.full(
                (B,), cache_index + 1, dtype=torch.int32, device=q.device))
            return flash_decode(q[:, :, 0].contiguous(), cache[0], cache[1],
                                lengths.to(torch.int32),
                                **_scales(cache))[:, :, None]
        if per_row:
            # The verify block: drop-mode write, then every query at its
            # own position over the whole buffer (module docstring).
            write_dense_kv(cache, k, v, cache_index)
            qpos = (cache_index.long()[:, None]
                    + torch.arange(T, device=q.device)[None, :])
            return masked_cache_attention(q, cache[0], cache[1], qpos,
                                          **_scales(cache))
        if cache_index != 0:
            raise NotImplementedError(
                "a dense-cache call with T > 1 at a nonzero scalar "
                "cache_index is not ported yet")
        if len(cache) == 4:
            raise NotImplementedError(
                "a T > 1 prefill into a quantized dense cache is not "
                "ported yet (prefill into a full-precision cache, then "
                "scatter_cache_rows quantizes)")
        write_dense_kv(cache, k, v, 0)
        # JAX's masked path bounds a scalar-index call's span to
        # cache_index + T keys, so at index 0 it is exactly causal
        # attention over this call's own keys: K4, over q/k/v as
        # computed (a cache in the compute dtype holds the same values).
        return causal_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), dropout_rate=0.0, seed=None)


class MLP(nn.Module):
    """The 4x tanh-GELU MLP over one model shard's hidden units (all 4C
    at ``tp`` (1, 0); units [i 4C/tp, (i+1) 4C/tp) at (tp, i)), summed
    over the model group as CausalSelfAttention's output is."""

    def __init__(self, cfg: GPTConfig, mesh=None, tp: tuple = (1, 0),
                 **factory):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tp = tp[0]
        C = cfg.n_embd
        self.c_fc = nn.Linear(C, 4 * C // self.tp, bias=cfg.bias, **factory)
        self.c_proj = nn.Linear(4 * C // self.tp, C, bias=cfg.bias,
                                **factory)

    def forward(self, x, generator=None, spread=None):
        dtype = self.cfg.torch_compute_dtype
        if self.tp == 1:
            y = _dense(self.c_proj, self.hidden(x), dtype)
        else:
            group = self.mesh.model_group
            y = _row_parallel(self.c_proj, [self.partial(
                self.hidden(copy_to_model(x, group)))], dtype, group)
        return _dropout(y, self.cfg.dropout, generator, spread)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(_dense(self.c_fc, x, self.cfg.torch_compute_dtype),
                      approximate="tanh")

    def partial(self, h: torch.Tensor) -> torch.Tensor:
        """c_proj's product over this shard's units, without the bias."""
        return _dense(self.c_proj, h, self.cfg.torch_compute_dtype,
                      bias=False)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, mesh=None, **factory):
        super().__init__()
        C = cfg.n_embd
        self.ln_1 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.attn = CausalSelfAttention(cfg, mesh, _tp(mesh), **factory)
        self.ln_2 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.mlp = MLP(cfg, mesh, _tp(mesh), **factory)

    def forward(self, x, cache=None, cache_index=None, block_table=None,
                generator=None, plain_attention=False, spread=None):
        dtype = x.dtype
        x = x + self.attn(_layer_norm(self.ln_1, x).to(dtype), cache,
                          cache_index, block_table, generator,
                          plain_attention, spread)
        return x + self.mlp(_layer_norm(self.ln_2, x).to(dtype), generator,
                            spread)


class ShardedBlock(nn.Module):
    """A block of the single-controller tensor-parallel model (serving,
    GPT(shards=tp)): ``tp`` shards of attention and of the MLP at local
    width, each with its own weights, run one after another on one
    device. A cached call's pool layer holds every shard's slice of the
    heads along a leading dim (init_paged_cache / init_cache with tp), and
    shard i attends through slice i. The row-parallel partial products
    are summed in shard order, then the bias (shard 0's; every shard
    holds it) added once. The LayerNorms are whole, once."""

    def __init__(self, cfg: GPTConfig, tp: int, **factory):
        super().__init__()
        C = cfg.n_embd
        self.ln_1 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.attn = nn.ModuleList(CausalSelfAttention(cfg, tp=(tp, i),
                                                      **factory)
                                  for i in range(tp))
        self.ln_2 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.mlp = nn.ModuleList(MLP(cfg, tp=(tp, i), **factory)
                                 for i in range(tp))

    def forward(self, x, cache=None, cache_index=None, block_table=None,
                generator=None, plain_attention=False, spread=None):
        if generator is not None:
            raise ValueError("the single-controller tensor-parallel model "
                             "serves: it takes no dropout generator")
        dtype = x.dtype
        cdt = self.attn[0].cfg.torch_compute_dtype
        h = _layer_norm(self.ln_1, x).to(dtype)
        parts = [a.partial(a.attend(
            h, None if cache is None else tuple(buf[i] for buf in cache),
            cache_index, block_table, plain_attention=plain_attention))
            for i, a in enumerate(self.attn)]
        x = x + _row_parallel(self.attn[0].c_proj, parts, cdt)
        h = _layer_norm(self.ln_2, x).to(dtype)
        parts = [m.partial(m.hidden(h)) for m in self.mlp]
        return x + _row_parallel(self.mlp[0].c_proj, parts, cdt)


class _RematBlock:
    """One training block call under activation checkpointing
    (torch.utils.checkpoint, non-reentrant): the first run keeps no
    activation, and the backward runs the block again to rebuild them.

    Two things must come out of the recompute as they did the first
    time. The dropout generator: torch.utils.checkpoint restores only the
    default generators, so the recompute sets the block's generator to
    the state the first run began at and restores it after. The
    attention: under 'save_attention' the first run keeps each call's
    (o, lse) (ops/attention.py SavedAttention) and the recompute takes
    them back without launching the forward kernel; under 'full' it is
    computed again. ``gather`` (a context factory) wraps both runs: under
    FSDP it installs the block's full weights for the run and frees them
    after (parallel/sharding.py)."""

    def __init__(self, block: Block, policy: str, generator, plain_attention,
                 spread, gather=contextlib.nullcontext):
        self.block, self.generator, self.gather = block, generator, gather
        self.plain_attention, self.spread = plain_attention, spread
        self.saved = SavedAttention() if policy == "save_attention" else None
        self.state = None if generator is None else generator.get_state()
        self.first = True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.first:
            self.first = False
            return self._run(x)
        if self.saved is not None:
            self.saved.replay = True
        g = self.generator
        resume = None if g is None else g.get_state()
        if g is not None:
            g.set_state(self.state)
        distributed.recomputing = True
        try:
            return self._run(x)
        finally:
            distributed.recomputing = False
            if g is not None:
                g.set_state(resume)

    def _run(self, x):
        with saving_attention(self.saved), self.gather():
            return self.block(x, generator=self.generator,
                              plain_attention=self.plain_attention,
                              spread=self.spread)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return checkpoint(self, x, use_reentrant=False,
                          preserve_rng_state=False)


class GPT(nn.Module):
    """GPT-2-family decoder. Parameter names follow the flax model's
    (``h.{i}.attn.c_attn.weight`` <-> ``h_{i}/attn/c_attn/kernel``), so
    models/convert.py maps one onto the other by name.

    ``generator`` seeds the initialization (GPT-2's: normal 0.02, the
    residual projections scaled by 1/sqrt(2 n_layer), LayerNorm 1/0;
    init_param);
    without one the weights are left as allocated, for a caller that
    loads a state_dict next. ``mesh`` (parallel/mesh.py) carries the seq
    group ring attention runs over and, in training, this rank's row
    block of the micro-batch (its dropout masks are the global batch's
    rows); a model axis larger than 1 builds the rank's model shard
    (tensor parallelism, parallel/tensor.py): its heads and hidden units
    of every block, the rest whole, summed over the model group; the
    attention-dropout seed words carry the shard's head offset and the
    global head count, so the masks are one process's. ``shards`` > 1
    is serving's single controller (shard_for_serving): every block a
    ShardedBlock of that many shards in one process, its cached calls
    over a pool made with tp = shards. ``fsdp`` (parallel/sharding.py
    FSDP, set by it) holds the
    parameters as shards: each part of the forward runs inside
    ``gathered`` of its weights, and every training block runs as a
    _RematBlock (under remat_policy, or 'save_attention' without remat)
    so that its full weights are gathered again for the backward instead
    of being kept."""

    def __init__(self, cfg: GPTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 shards: int = 1):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = None
        self.tp = _tp(mesh)
        self.shards = int(shards)
        if self.shards > 1 and self.tp[0] > 1:
            raise ValueError("a model is sharded over a mesh's model axis "
                             "or over shards in one process, not both")
        for tp in (self.tp[0], self.shards):
            if cfg.n_head % tp:
                raise ValueError(f"tensor parallelism splits heads: n_head "
                                 f"{cfg.n_head} must be divisible by {tp}")
        factory = {"device": device, "dtype": cfg.torch_param_dtype}
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **factory)
        self.wpe = nn.Embedding(cfg.block_size, cfg.n_embd, **factory)
        self.h = nn.ModuleList(
            (ShardedBlock(cfg, self.shards, **factory) if self.shards > 1
             else Block(cfg, mesh, **factory)) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=1e-5, bias=cfg.bias,
                                 **factory)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """GPT-2's initialization, drawn as one process draws it: on a
        model shard (a mesh's model axis) each full parameter is drawn
        and this rank's shard of it kept (parallel/tensor.py)."""
        from nanosandbox_tpu_torch.parallel.tensor import (full_shapes,
                                                           shard_param)

        if self.shards > 1:
            raise ValueError("the single-controller tensor-parallel model "
                             "takes its weights from a full model "
                             "(shard_for_serving)")
        tp, index = self.tp
        shapes = full_shapes(self.cfg) if tp > 1 else {}
        for name, p in self.named_parameters():
            if tp == 1:
                init_param(name, p, generator, self.cfg.n_layer)
                continue
            full = torch.empty(shapes[name], dtype=p.dtype, device=p.device)
            init_param(name, full, generator, self.cfg.n_layer)
            p.copy_(shard_param(name, full, tp, index))

    def gathered(self, *prefixes: str):
        """A context in which the parameters whose names start with one of
        ``prefixes`` are whole: under FSDP their shards are gathered and
        installed for its duration; a no-op otherwise."""
        if self.fsdp is None:
            return contextlib.nullcontext()
        return self.fsdp.gathered(*prefixes)

    def hidden(self, idx: torch.Tensor, *, cache: Optional[KVPool] = None,
               cache_index: Optional[torch.Tensor] = None,
               block_table: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None,
               plain_attention: bool = False) -> torch.Tensor:
        """Final-LayerNorm hidden states (B, T, C), f32. With ``cache``,
        the pool is written in place and ``cache_index`` gives the
        position of idx[:, 0]: for a paged pool (init_paged_cache) a (B,)
        int32 frontier per row, with ``block_table`` (B, nb) int32
        mapping positions onto pool blocks; for a dense pool (init_cache)
        a (B,) int32 frontier per row (T = 1) or one Python int for every
        row (module docstring). Without a cache, ``dropout_generator``
        turns training dropout on and ``plain_attention`` selects the
        plain attention. Under sequence parallelism idx holds this rank's
        T / seq tokens of each row, in the ring layout's order; in a
        training run over the data or fsdp axis, its rows of the
        micro-batch."""
        cfg = self.cfg
        B, T = idx.shape
        ring = _ring(cfg, self.mesh) and cache is None
        if ring and plain_attention:
            raise ValueError("plain_attention is not taken under ring "
                             "attention: the ring's block picks the kernels "
                             "or the plain block by the tensors' device")
        T_global = T * self.mesh.seq if ring else T
        if T_global > cfg.block_size:
            raise ValueError(f"sequence length {T_global} > block_size "
                             f"{cfg.block_size}")
        ar = torch.arange(T, device=idx.device)
        if ring:
            pos = torch.from_numpy(ring_positions(
                T_global, self.mesh.seq, self.mesh.seq_index,
                cfg.ring_layout)).to(idx.device)[None, :]
        elif cache is None:
            pos = ar[None, :]
        else:
            if cache_index is None:
                raise ValueError("a cached call needs cache_index")
            if block_table is not None and isinstance(cache_index, int):
                raise ValueError("a paged cache is per-row: cache_index "
                                 "must be a (B,) frontier vector")
            if dropout_generator is not None or plain_attention:
                raise ValueError("the cached path is inference-only and "
                                 "always runs the decode kernels")
            start = (cache_index if isinstance(cache_index, int)
                     else cache_index.long()[:, None])
            # Bucket padding can run past block_size; those positions are
            # garbage rows nobody reads, clamped so the lookup stays in
            # range (an out-of-range index raises on CUDA).
            pos = (start + ar[None, :]).clamp(max=cfg.block_size - 1)
        # A rank that holds part of the batch (its rows, its positions)
        # draws the global masks and keeps its part (module docstring).
        m = self.mesh
        rows = m is not None and m.batch_shards > 1 and cache is None
        spread = None
        if ring or rows:
            nb = m.batch_shards if rows else 1
            spread = (B * nb, B * m.batch_index if rows else 0, T_global,
                      pos[0] if ring else None)
        with self.gathered("wte.", "wpe."):
            x = _dropout(self.wte(idx) + self.wpe(pos), cfg.dropout,
                         dropout_generator, spread)
        x = x.to(cfg.torch_compute_dtype)
        remat = ((cfg.remat or self.fsdp is not None) and cache is None
                 and torch.is_grad_enabled())
        policy = cfg.remat_policy if cfg.remat else "save_attention"
        for i, block in enumerate(self.h):
            gather = functools.partial(self.gathered, f"h.{i}.")
            if remat:
                x = _RematBlock(block, policy, dropout_generator,
                                plain_attention, spread, gather).apply(x)
            else:
                with gather():
                    x = block(x, None if cache is None else cache[i],
                              cache_index, block_table, dropout_generator,
                              plain_attention, spread)
        with self.gathered("ln_f."):
            return _layer_norm(self.ln_f, x)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Tied LM head: f32 logits from hidden states. The product runs
        in the embedding's storage dtype — exactly JAX's f32 head for
        f32 weights; bf16 serving weights skip the f32 upcast of the
        (vocab, C) table."""
        w = self.wte.weight
        return F.linear(h.to(w.dtype), w).float()

    def forward(self, idx, *, cache=None, cache_index=None,
                block_table=None, dropout_generator=None,
                plain_attention=False) -> torch.Tensor:
        """Logits (B, T, vocab) in f32."""
        h = self.hidden(idx, cache=cache, cache_index=cache_index,
                        block_table=block_table,
                        dropout_generator=dropout_generator,
                        plain_attention=plain_attention)
        with self.gathered("wte."):
            return self.head(h)


@torch.no_grad()
def init_param(name: str, p: torch.Tensor, generator: torch.Generator,
               n_layer: int) -> None:
    """GPT-2's initialization of parameter ``name`` in place, drawing
    from ``generator``; GPT.init_weights calls it in named_parameters
    order, and FSDP one full parameter at a time in the same order."""
    if name.endswith("c_proj.weight"):
        nn.init.normal_(p, 0.0, 0.02 / math.sqrt(2 * n_layer),
                        generator=generator)
    elif p.dim() == 2:
        nn.init.normal_(p, 0.0, 0.02, generator=generator)
    elif name.endswith(("ln_1.weight", "ln_2.weight")) or name == \
            "ln_f.weight":
        nn.init.ones_(p)
    else:
        nn.init.zeros_(p)


_KV_ALIASES = {"fp32": "fp32", "float32": "fp32", "bf16": "bf16",
               "bfloat16": "bf16", "int8": "int8", "int4": "int4"}


def normalize_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonicalize a --kv_dtype flag value: None/''/'auto' -> None (the
    compute dtype), else one of ops/flash_decode.KV_MODES."""
    if kv_dtype in (None, "", "auto"):
        return None
    norm = _KV_ALIASES.get(str(kv_dtype))
    if norm is None:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} (expected one of "
                         f"{KV_MODES})")
    return norm


def kv_mode(cfg: GPTConfig, kv_dtype=None) -> str:
    """The pool mode --kv_dtype selects: 'fp32' | 'bf16' | 'int8' |
    'int4'; None/''/'auto' is the compute dtype's."""
    return normalize_kv_dtype(kv_dtype) or (
        "bf16" if cfg.torch_compute_dtype == torch.bfloat16 else "fp32")


def _cache_layers(cfg: GPTConfig, lead: tuple, length: int, kv_dtype,
                  device, tp: int = 1) -> KVPool:
    """Per-layer pools of lead + (H, length, head_dim): (K, V) for the fp
    modes; (K, V, k_scale, v_scale) with f32 scales lead + (H, length)
    for int8 and int4 (values packed to head_dim // 2 bytes). ``tp`` > 1
    gives every tensor a leading dim of tp shards of H / tp heads each:
    shard i's slice [i] is its own contiguous pool (ShardedBlock)."""
    mode = kv_mode(cfg, kv_dtype)
    D = cfg.head_dim
    if mode == "int4" and D % 2:
        raise ValueError(f"int4 KV packs two dims per byte; head_dim {D} "
                         "must be even")
    if tp > 1:
        lead = (tp,) + lead
    H = cfg.n_head // tp
    vshape = lead + (H, length, D // 2 if mode == "int4" else D)
    sshape = lead + (H, length)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    dtype = KV_STORAGE[mode]
    if mode in ("int8", "int4"):
        return [(zeros(vshape, dtype), zeros(vshape, dtype),
                 zeros(sshape, torch.float32), zeros(sshape, torch.float32))
                for _ in range(cfg.n_layer)]
    return [(zeros(vshape, dtype), zeros(vshape, dtype))
            for _ in range(cfg.n_layer)]


def init_cache(cfg: GPTConfig, batch_size: int, max_len: int, kv_dtype=None,
               device=None, tp: int = 1) -> KVPool:
    """Per-layer dense decode pools of (batch_size, H, max_len, head_dim)
    (models/gpt.py init_cache of the JAX package): one row per slot or
    sample, in the --kv_dtype mode (module docstring). max_len caps at
    block_size, the positions wpe defines. ``tp`` > 1: (tp, batch_size,
    H / tp, max_len, head_dim), for GPT(shards=tp)."""
    if max_len > cfg.block_size:
        raise ValueError(f"cache length {max_len} > block_size "
                         f"{cfg.block_size}")
    return _cache_layers(cfg, (batch_size,), max_len, kv_dtype, device, tp)


def scatter_cache_rows(pool: KVPool, rows: KVPool,
                       slots: torch.Tensor) -> None:
    """Write a prefill wave's per-layer (n, H, L, D) full-precision K/V
    rows into slot rows ``slots`` (n,) of a dense pool at positions
    [0, L), in place: cast to an fp pool's dtype, or quantized into an
    int8/int4 pool. Positions past L keep stale values, which the per-row
    frontier hides until the new occupant overwrites them.

    JAX's version takes the wave's ladder-padding rows with slot ids >=
    num_slots and drops them in the scatter; here the caller knows the
    wave's size and passes only its real rows."""
    slots = slots.long()
    for pool_layer, row_layer in zip(pool, rows):
        if len(row_layer) != 2:
            raise ValueError(
                "scatter_cache_rows takes full-precision (K, V) rows; the "
                "pool quantizes them itself")
        L = row_layer[0].shape[2]
        for buf, x in zip(pool_layer, _to_pool(pool_layer, *row_layer)):
            buf[slots, :, :L] = x


def init_paged_cache(cfg: GPTConfig, num_blocks: int, page: int,
                     kv_dtype=None, device=None, tp: int = 1) -> KVPool:
    """Per-layer block pools of (num_blocks + 1, H, page, head_dim):
    ``num_blocks`` allocatable blocks plus the drop block at index
    num_blocks (module docstring), in the --kv_dtype mode; int8/int4
    layers carry (num_blocks + 1, H, page) f32 scales. ``tp`` > 1: a
    leading dim of tp shards of H / tp heads, for GPT(shards=tp)."""
    return _cache_layers(cfg, (num_blocks + 1,), page, kv_dtype, device, tp)


def pool_shards(pool: KVPool, tp: int) -> List[KVPool]:
    """The per-shard pools of a pool made with ``tp`` (views of its
    slices: writes land in it); [pool] itself at tp 1."""
    if tp == 1:
        return [pool]
    return [[tuple(buf[i] for buf in layer) for layer in pool]
            for i in range(tp)]


@torch.no_grad()
def shard_for_serving(model: GPT, tp: int) -> GPT:
    """The single-controller tensor-parallel model of a full ``model``:
    GPT(shards=tp) on the model's device and dtype, shard i of each block
    holding its own copy of shard i of the weights (parallel/tensor.py
    shard_state_dict); the embeddings and LayerNorms once. The model
    itself at tp 1."""
    from nanosandbox_tpu_torch.parallel.tensor import shard_state_dict

    if tp == 1:
        return model
    w = model.wte.weight
    out = GPT(model.cfg, device="meta", shards=tp).to_empty(device=w.device)
    out = out.to(w.dtype)
    sd = model.state_dict()
    mine = out.state_dict()
    for i in range(tp):
        for name, t in shard_state_dict(sd, tp, i).items():
            parts = name.split(".")
            if parts[0] == "h" and parts[2] in ("attn", "mlp"):
                name = ".".join(parts[:3] + [str(i)] + parts[3:])
            elif i:
                continue
            mine[name].copy_(t)
    return out


def cast_for_serving(model: GPT) -> GPT:
    """Cast the weights to the compute dtype in place (the counterpart of
    sample.cast_params_for_serving): decode streams every weight once per
    token, so bf16 weights halve its bytes. No-op for float32 compute."""
    return model.to(model.cfg.torch_compute_dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def nll_sums(logits: torch.Tensor, targets: torch.Tensor,
             ignore_index: int = -1):
    """(sum of next-token nll, count of valid targets); positions ==
    ignore_index are masked. In logsumexp form (nll = logsumexp(logits)
    - logits[target]), so no (B, T, vocab) log-probability tensor is
    built beside the logits. ``.float()`` is free for the f32 logits the
    head returns."""
    logits = logits.float()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - tgt, 0.0)
    return nll.sum(), valid.sum()


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy (nll_sums)."""
    tot, cnt = nll_sums(logits, targets, ignore_index)
    return tot / cnt.clamp(min=1)


def shared_mean(tot: torch.Tensor, cnt: torch.Tensor, group=None):
    """A loss whose tokens are spread over a group's ranks, from this
    rank's (sum, count): both are all-reduced over ``group``. Returns
    (this rank's share tot / sum(cnt), differentiable: what the rank
    backprops, so that parameter gradients summed over the ranks are the
    mean loss's; the mean sum(tot) / sum(cnt), detached, the same on
    every rank). The JAX package's sharded_chunked_cross_entropy_loss
    does this over the seq axis."""
    sums = torch.stack([tot.detach(), cnt.to(tot.dtype)])
    distributed.all_reduce_sum_(sums, group)
    total = sums[1].clamp(min=1)
    return tot / total, sums[0] / total


def _chunk_nll(h: torch.Tensor, y: torch.Tensor, emb: torch.Tensor,
               ignore_index: int):
    """(sum of nll, count of valid targets) over one chunk: the head in
    emb's dtype, the softmax math in f32."""
    logits = F.linear(h.to(emb.dtype), emb).float()     # (B, cs, V)
    valid = y != ignore_index
    safe = torch.where(valid, y, 0)
    nll = (torch.logsumexp(logits, dim=-1)
           - logits.gather(-1, safe[..., None])[..., 0])
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def chunked_nll_sums(hidden: torch.Tensor, embedding: torch.Tensor,
                     targets: torch.Tensor, *, chunk_size: int = 128,
                     compute_dtype: str = "bfloat16",
                     ignore_index: int = -1):
    """(sum of nll, count of valid targets) of the tied LM head + cross
    entropy over sequence chunks, so only (B, chunk, vocab) logits are
    ever alive: each chunk runs under torch.utils.checkpoint, and its
    backward recomputes the chunk's head instead of saving its logits.
    The head runs in ``compute_dtype``. hidden: (B, T, C) from
    GPT.hidden; embedding: the (V, C) wte table. The chunk is the largest
    divisor of T at most chunk_size."""
    B, T, C = hidden.shape
    cs = min(chunk_size, T)
    while T % cs:
        cs -= 1
    emb = embedding.to(DTYPES[compute_dtype])
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, T, cs):
        t, c = checkpoint(_chunk_nll, hidden[:, i:i + cs],
                          targets[:, i:i + cs], emb, ignore_index,
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot, cnt


def chunked_cross_entropy_loss(hidden: torch.Tensor, embedding: torch.Tensor,
                               targets: torch.Tensor, *, chunk_size: int = 128,
                               compute_dtype: str = "bfloat16",
                               ignore_index: int = -1) -> torch.Tensor:
    """Mean cross entropy of the chunked tied head (chunked_nll_sums)."""
    tot, cnt = chunked_nll_sums(hidden, embedding, targets,
                                chunk_size=chunk_size,
                                compute_dtype=compute_dtype,
                                ignore_index=ignore_index)
    return tot / cnt.clamp(min=1)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
