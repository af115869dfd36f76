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
    tensors, the plain version on CPU tensors. ``plain_attention=True``
    asks for the plain version on any device; only comparison harnesses
    pass it (its CUDA calls show in attention.plain_cuda_calls). With a
    ``dropout_generator`` and cfg.dropout > 0 the forward trains: residual
    dropout where flax has it (after the embedding sum, after attention's
    c_proj, after the MLP's c_proj) with masks drawn from the generator,
    and attention-probability dropout in the kernels, keyed by a uint32
    seed per layer drawn from the same generator;
  * paged cache: each layer's (K, V) pool is (num_blocks + 1, H, page,
    D). The call writes its K/V through the block table first, then
    attends with the paged-attention kernels (ops/flash_decode.py):
    the decode kernel for T = 1, the prefill kernel for T > 1. The pool
    is updated IN PLACE (JAX returns a new pool; here that would copy
    the whole pool every step).

The pool's last block (index num_blocks, the engine's sentinel value)
is a drop block: writes bound for the sentinel — parked rows, ladder
padding, positions past a row's chain — land there instead of being
filtered out, so the write needs neither a host sync (a boolean mask
would) nor an out-of-range index (which raises a device-side assert on
CUDA where JAX's scatter drops). No table entry of a live request ever
names it, and the kernels only read it for sentinel entries, whose
positions are past every frontier.

The losses (``cross_entropy_loss``, ``chunked_cross_entropy_loss``) and
``count_params`` are the JAX module's, in the same logsumexp form.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nanosandbox_tpu_torch.config import DTYPES, GPTConfig
from nanosandbox_tpu_torch.ops.attention import (causal_attention,
                                                 torch_flash_attention)
from nanosandbox_tpu_torch.ops.flash_decode import (flash_decode_paged,
                                                    flash_prefill_paged)

KVPool = List[Tuple[torch.Tensor, torch.Tensor]]


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax Dense(dtype=compute): inputs and weights in the compute dtype."""
    b = lin.bias.to(dtype) if lin.bias is not None else None
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 whatever the storage dtype (models/gpt.py:33)."""
    b = ln.bias.float() if ln.bias is not None else None
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), b,
                        ln.eps)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, kept values
    scaled by 1 / (1 - rate); the identity without a generator."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


def _attention_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One uint32 dropout seed (as int64) drawn on the generator's device:
    no host sync on the training path."""
    return torch.randint(0, 2**32, (1,), generator=generator,
                         device=device, dtype=torch.int64)


def write_paged_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   block_table: torch.Tensor,
                   cache_index: torch.Tensor) -> None:
    """Write (B, H, T, D) K/V at positions cache_index[b] + [0, T) of
    each row's chain: position p of row b lands in block
    table[b, p // page] at offset p % page. Positions past the chain or
    bound for a sentinel entry go to the drop block (module docstring)."""
    drop = pool_k.shape[0] - 1
    page = pool_k.shape[2]
    B, H, T, D = k.shape
    nb = block_table.shape[1]
    qpos = (cache_index.long()[:, None]
            + torch.arange(T, device=k.device)[None, :])          # (B, T)
    jblk = qpos // page
    blk = block_table.long().gather(1, jblk.clamp(max=nb - 1))
    blk = torch.where((jblk < nb) & (blk >= 0) & (blk < drop), blk, drop)
    bf, of = blk.reshape(-1), (qpos % page).reshape(-1)
    pool_k[bf, :, of, :] = k.transpose(1, 2).reshape(B * T, H, D).to(
        pool_k.dtype)
    pool_v[bf, :, of, :] = v.transpose(1, 2).reshape(B * T, H, D).to(
        pool_v.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_attn = nn.Linear(C, 3 * C, bias=cfg.bias, **factory)
        self.c_proj = nn.Linear(C, C, bias=cfg.bias, **factory)

    def forward(self, x, cache=None, cache_index=None, block_table=None,
                generator=None, plain_attention=False):
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        dtype = cfg.torch_compute_dtype
        q, k, v = _dense(self.c_attn, x, dtype).split(C, dim=-1)
        q = q.view(B, T, H, D).transpose(1, 2)        # (B, H, T, D)
        k = k.view(B, T, H, D).transpose(1, 2)
        v = v.view(B, T, H, D).transpose(1, 2)
        if cache is None:
            rate, seed = 0.0, None
            if generator is not None and cfg.dropout > 0.0:
                rate, seed = cfg.dropout, _attention_seed(generator, x.device)
            if plain_attention:
                y = torch_flash_attention(q, k, v, dropout_rate=rate,
                                          seed=seed)[0]
            else:
                y = causal_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), dropout_rate=rate,
                                     seed=seed)
        else:
            ck, cv = cache
            # The pool must hold this call's K/V before the kernel reads
            # it: decode attends up to cache_index + 1 positions, prefill
            # from cache_index on (the resident prefix included).
            write_paged_kv(ck, cv, k, v, block_table, cache_index)
            if T == 1:
                y = flash_decode_paged(q[:, :, 0].contiguous(), ck, cv,
                                       block_table,
                                       cache_index + 1)[:, :, None]
            else:
                y = flash_prefill_paged(q.contiguous(), ck, cv, block_table,
                                        cache_index)
        y = y.transpose(1, 2).reshape(B, T, C)
        return _dropout(_dense(self.c_proj, y, dtype), cfg.dropout, generator)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_fc = nn.Linear(C, 4 * C, bias=cfg.bias, **factory)
        self.c_proj = nn.Linear(4 * C, C, bias=cfg.bias, **factory)

    def forward(self, x, generator=None):
        dtype = self.cfg.torch_compute_dtype
        h = F.gelu(_dense(self.c_fc, x, dtype), approximate="tanh")
        return _dropout(_dense(self.c_proj, h, dtype), self.cfg.dropout,
                        generator)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        C = cfg.n_embd
        self.ln_1 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.attn = CausalSelfAttention(cfg, **factory)
        self.ln_2 = nn.LayerNorm(C, eps=1e-5, bias=cfg.bias, **factory)
        self.mlp = MLP(cfg, **factory)

    def forward(self, x, cache=None, cache_index=None, block_table=None,
                generator=None, plain_attention=False):
        dtype = x.dtype
        x = x + self.attn(_layer_norm(self.ln_1, x).to(dtype), cache,
                          cache_index, block_table, generator,
                          plain_attention)
        return x + self.mlp(_layer_norm(self.ln_2, x).to(dtype), generator)


class GPT(nn.Module):
    """GPT-2-family decoder. Parameter names follow the flax model's
    (``h.{i}.attn.c_attn.weight`` <-> ``h_{i}/attn/c_attn/kernel``), so
    models/convert.py maps one onto the other by name.

    ``generator`` seeds the initialization (GPT-2's: normal 0.02, the
    residual projections scaled by 1/sqrt(2 n_layer), LayerNorm 1/0);
    without one the weights are left as allocated, for a caller that
    loads a state_dict next."""

    def __init__(self, cfg: GPTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        factory = {"device": device, "dtype": cfg.torch_param_dtype}
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, **factory)
        self.wpe = nn.Embedding(cfg.block_size, cfg.n_embd, **factory)
        self.h = nn.ModuleList(Block(cfg, **factory)
                               for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=1e-5, bias=cfg.bias,
                                 **factory)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        proj_std = 0.02 / math.sqrt(2 * self.cfg.n_layer)
        for name, p in self.named_parameters():
            if name.endswith("c_proj.weight"):
                nn.init.normal_(p, 0.0, proj_std, generator=generator)
            elif p.dim() == 2:
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            elif name.endswith("ln_1.weight") or name.endswith(
                    "ln_2.weight") or name == "ln_f.weight":
                nn.init.ones_(p)
            else:
                nn.init.zeros_(p)

    def hidden(self, idx: torch.Tensor, *, cache: Optional[KVPool] = None,
               cache_index: Optional[torch.Tensor] = None,
               block_table: Optional[torch.Tensor] = None,
               dropout_generator: Optional[torch.Generator] = None,
               plain_attention: bool = False) -> torch.Tensor:
        """Final-LayerNorm hidden states (B, T, C), f32. With ``cache``
        (a paged pool from init_paged_cache), ``cache_index`` (B,) int32
        is each row's position of idx[:, 0] and ``block_table`` (B, nb)
        int32 maps its positions onto pool blocks; the pool is written
        in place. Without a cache, ``dropout_generator`` turns training
        dropout on and ``plain_attention`` selects the plain attention
        (module docstring)."""
        cfg = self.cfg
        B, T = idx.shape
        if T > cfg.block_size:
            raise ValueError(f"sequence length {T} > block_size "
                             f"{cfg.block_size}")
        ar = torch.arange(T, device=idx.device)
        if cache is None:
            pos = ar[None, :]
        else:
            if cache_index is None or block_table is None:
                raise ValueError("the paged cache needs cache_index and "
                                 "block_table")
            if dropout_generator is not None or plain_attention:
                raise ValueError("the paged cache path is inference-only "
                                 "and always runs the paged kernels")
            # Bucket padding can run past block_size; those positions are
            # garbage rows nobody reads, clamped so the lookup stays in
            # range (an out-of-range index raises on CUDA).
            pos = (cache_index.long()[:, None] + ar[None, :]).clamp(
                max=cfg.block_size - 1)
        x = _dropout(self.wte(idx) + self.wpe(pos), cfg.dropout,
                     dropout_generator).to(cfg.torch_compute_dtype)
        for i, block in enumerate(self.h):
            x = block(x, None if cache is None else cache[i], cache_index,
                      block_table, dropout_generator, plain_attention)
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
        return self.head(self.hidden(
            idx, cache=cache, cache_index=cache_index,
            block_table=block_table, dropout_generator=dropout_generator,
            plain_attention=plain_attention))


KV_DTYPES = {"fp32": torch.float32, "float32": torch.float32,
             "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def kv_torch_dtype(cfg: GPTConfig, kv_dtype=None) -> torch.dtype:
    """--kv_dtype -> storage dtype; None/''/'auto' is the compute dtype."""
    if kv_dtype in (None, "", "auto"):
        return cfg.torch_compute_dtype
    if kv_dtype in ("int8", "int4"):
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pools are not ported yet "
            "(fp32 and bf16 are)")
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} (expected one of "
                         "fp32, bf16, int8, int4)")
    return KV_DTYPES[kv_dtype]


def init_paged_cache(cfg: GPTConfig, num_blocks: int, page: int,
                     kv_dtype=None, device=None) -> KVPool:
    """Per-layer (K, V) block pools of shape (num_blocks + 1, H, page,
    head_dim): ``num_blocks`` allocatable blocks plus the drop block at
    index num_blocks (module docstring)."""
    dtype = kv_torch_dtype(cfg, kv_dtype)
    shape = (num_blocks + 1, cfg.n_head, page, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layer)]


def cast_for_serving(model: GPT) -> GPT:
    """Cast the weights to the compute dtype in place (the counterpart of
    sample.cast_params_for_serving): decode streams every weight once per
    token, so bf16 weights halve its bytes. No-op for float32 compute."""
    return model.to(model.cfg.torch_compute_dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Mean next-token cross entropy; positions == ignore_index are
    masked. In logsumexp form (nll = logsumexp(logits) - logits[target]),
    so no (B, T, vocab) log-probability tensor is built beside the
    logits. ``.float()`` is free for the f32 logits the head returns."""
    logits = logits.float()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - tgt, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


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


def chunked_cross_entropy_loss(hidden: torch.Tensor, embedding: torch.Tensor,
                               targets: torch.Tensor, *, chunk_size: int = 128,
                               compute_dtype: str = "bfloat16",
                               ignore_index: int = -1) -> torch.Tensor:
    """Tied LM head + cross entropy over sequence chunks, so only
    (B, chunk, vocab) logits are ever alive: each chunk runs under
    torch.utils.checkpoint, and its backward recomputes the chunk's head
    instead of saving its logits. The head runs in ``compute_dtype``.
    hidden: (B, T, C) from GPT.hidden; embedding: the (V, C) wte table.
    The chunk is the largest divisor of T at most chunk_size."""
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
    return tot / cnt.clamp(min=1)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
