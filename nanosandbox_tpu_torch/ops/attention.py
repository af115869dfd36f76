"""Causal flash attention for training, forward and backward.

The counterpart of nanosandbox_tpu/ops/attention.py. Its four Pallas
kernels become CUDA kernels (csrc/flash_attention.cu, built at first use
by ops/_build.py):

  flash_attention_fwd        (K4)  <- _flash_fwd_kernel
  flash_attention_bwd fused  (K5)  <- _flash_bwd_tiles_kernel(with_dq=True)
  flash_attention_bwd_dq     (K6)  <- _flash_bwd_dq_kernel
  flash_attention_bwd_dkv    (K7)  <- _flash_bwd_tiles_kernel(with_dq=False)

On bfloat16 all four run on the tensor cores (mma.sync); on float32
they run on CUDA cores in exact f32 products, on cp.async-staged tiles
read as float4 (K4 through the fp32 paged prefill's tile loop,
csrc/attend_f32.cuh; K5 and K7 after a Drow pre-pass; K6 with its Drow
computed in the kernel). The input type alone picks the design.

``BWD_IMPL`` picks the backward strategy, as in the JAX file: 'fused'
(K5, one pass; dQ summed across key tiles with f32 atomicAdd, so its
summation order changes from run to run) or 'split' (K6 then K7, a
deterministic backward that recomputes the score tiles twice).

Layouts are the JAX package's: q, k, v, o (B, H, T, D) in float32 or
bfloat16, lse (B, H, T) float32. ``FlashAttention`` is the
torch.autograd.Function over K4 and the backward; ``flash_attention``,
``flash_attention_dropout`` and ``causal_attention`` are the entry
points the model calls.

Routing, as in ops/flash_decode.py: a CUDA tensor goes to a kernel or
the call raises; a CPU tensor goes to the plain PyTorch version beside
it (``torch_flash_attention``, differentiable by autograd, and
``torch_flash_attention_bwd``, the backward kernels' arithmetic). There
is no probe and no fallback between the two. ``launches`` counts kernel
launches; ``plain_cuda_calls`` counts plain-version calls on CUDA
tensors (a comparison harness makes those on purpose; the training path
never does).

Attention-probability dropout is the JAX kernels' counter-based hash
mask, bit for bit (``hash_dropout_keep_mask``): the same (5,) seed words
drop the same score elements in both packages. Not ported yet:
``flash_attention_lse`` (an lse output with its cotangent, which only
ring attention needs) and the Mosaic stat layouts (on Hopper the lse is
a plain (B*H, T) vector; ``attention_stat_layout`` selects nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from nanosandbox_tpu_torch.ops import _build

NEG_INF = -1e30
LANES = 128       # the JAX kernels pad T to this; the mask hash keeps it
SEED_WORDS = 5    # [seed, b_off, h_off, q_off, k_off] (attention.py:95-104)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF
_BWD_MODE = {"fused": 0, "dq": 1, "dkv": 2}

# Backward strategy: 'fused' (K5) or 'split' (K6 + K7). Not a fallback:
# nothing switches from one to the other on its own.
BWD_IMPL = "fused"

__all__ = ["flash_attention", "flash_attention_dropout", "causal_attention",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "torch_flash_attention", "torch_flash_attention_bwd",
           "hash_dropout_keep_mask", "FlashAttention", "BWD_IMPL",
           "launches", "plain_cuda_calls", "reset_counts"]

launches = {"flash_attention_fwd": 0, "flash_attention_bwd_fused": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
plain_cuda_calls = {"torch_flash_attention": 0,
                    "torch_flash_attention_bwd": 0}


def reset_counts() -> None:
    for d in (launches, plain_cuda_calls):
        for key in d:
            d[key] = 0


# ---------------------------------------------------------------------------
# The dropout keep-mask (attention.py:85-137, 1111-1140)
# ---------------------------------------------------------------------------
#
# torch has no uint32 arithmetic to speak of: the hash runs in int64 and
# keeps the low 32 bits after every step. A multiply is split at 16 bits
# so no intermediate product leaves int64's range.

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer over int64 tensors holding uint32s."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed_words(seed, device=None) -> torch.Tensor:
    """The (SEED_WORDS,) int64 words (uint32 values) every kernel reads:
    a scalar or (1,) seed gets zero offsets (the non-ring path), a
    (SEED_WORDS,) vector is taken as it is; None is all zeros. A tensor
    stays on its device (a seed drawn on the card needs no host sync)."""
    if seed is None:
        return torch.zeros(SEED_WORDS, dtype=torch.int64, device=device)
    if isinstance(seed, torch.Tensor):
        words = seed.reshape(-1).to(device=device or seed.device,
                                    dtype=torch.int64) & _M32
    else:
        words = torch.tensor([int(x) & _M32 for x in
                              np.asarray(seed).reshape(-1).tolist()],
                             dtype=torch.int64, device=device)
    if words.numel() == SEED_WORDS:
        return words.contiguous()
    if words.numel() != 1:
        raise ValueError(f"seed must hold 1 or {SEED_WORDS} words, got "
                         f"{words.numel()}")
    return torch.cat([words, words.new_zeros(SEED_WORDS - 1)])


def default_hash_seq_len(T: int) -> int:
    """The length the JAX kernels hash positions over by default: T
    padded to a multiple of 128 (their block-padded length)."""
    return -(-T // LANES) * LANES


def dropout_threshold(rate: float) -> int:
    """Keep where the hash is at or above this (attention.py:129)."""
    return min(int(round(rate * 2**32)), 2**32 - 1)


def _check_dropout_seq_len(dropout_rate: float, hash_seq_len: int) -> None:
    if dropout_rate > 0.0 and hash_seq_len > 65536:
        raise ValueError(
            f"flash attention dropout supports sequence lengths up to "
            f"65536 (hash length {hash_seq_len}): the positional mask hash "
            "would wrap uint32 and correlate rows")


def hash_dropout_keep_mask(seed, B: int, H: int, Tq: int, Tk: int, *,
                           q_off: int = 0, k_off: int = 0, b_off: int = 0,
                           h_off: int = 0, hash_heads: int | None = None,
                           hash_seq_len: int | None = None,
                           rate: float = 0.1, device=None) -> torch.Tensor:
    """The exact (B, H, Tq, Tk) bool keep-mask the kernels derive, as
    plain torch ops: bit for bit the JAX package's mask for the same
    seed words."""
    w = seed_words(seed, device).tolist()
    hash_heads = H if hash_heads is None else hash_heads
    if hash_seq_len is None:
        hash_seq_len = default_hash_seq_len(Tq)
    bh = torch.arange(B * H, dtype=torch.int64, device=device)
    b = (bh // H + w[1] + b_off) & _M32
    h = (bh % H + w[2] + h_off) & _M32
    gbh = (_mul32(b, hash_heads) + h) & _M32
    mix = _fmix32(w[0] ^ _mul32(gbh, _GOLDEN))                  # (B*H,)
    q_pos = (w[3] + q_off + torch.arange(Tq, dtype=torch.int64,
                                         device=device)) & _M32
    k_pos = (w[4] + k_off + torch.arange(Tk, dtype=torch.int64,
                                         device=device)) & _M32
    idx = (_mul32(q_pos, hash_seq_len)[:, None] + k_pos[None, :]) & _M32
    keep = _fmix32(idx[None] ^ mix[:, None, None]) >= dropout_threshold(rate)
    return keep.reshape(B, H, Tq, Tk)


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and the reference the kernels are held to
# ---------------------------------------------------------------------------

def _causal_scores(q, k, sm_scale) -> torch.Tensor:
    """f32 scores, scaled after the product, NEG_INF above the diagonal."""
    T = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, NEG_INF)


def _require_seed(seed, rate: float) -> None:
    # A silent constant seed would drop the same entries every step.
    if rate > 0.0 and seed is None:
        raise ValueError("flash attention dropout needs a per-step seed "
                         "when dropout_rate > 0")


def _keep(seed, rate, B, H, T, hash_seq_len, device) -> torch.Tensor | None:
    if rate <= 0.0:
        return None
    _require_seed(seed, rate)
    return hash_dropout_keep_mask(seed, B, H, T, T,
                                  hash_seq_len=hash_seq_len, rate=rate,
                                  device=device)


def torch_flash_attention(q, k, v, *, sm_scale: float | None = None,
                          dropout_rate: float = 0.0, seed=None,
                          hash_seq_len: int | None = None):
    """Causal attention over (B, H, T, D) in f32 math, differentiable:
    (o in q's dtype, lse (B, H, T) f32). With dropout_rate > 0 the
    softmax weights go through the hash keep-mask and the 1/(1-rate)
    rescale before p.v; lse is that of the unmasked scores, as the
    kernels'."""
    if q.is_cuda:
        plain_cuda_calls["torch_flash_attention"] += 1
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    hash_seq_len = hash_seq_len or default_hash_seq_len(T)
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    s = _causal_scores(q, k, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    keep = _keep(seed, dropout_rate, B, H, T, hash_seq_len, q.device)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def torch_flash_attention_bwd(q, k, v, o, lse, do, *,
                              sm_scale: float | None = None,
                              dropout_rate: float = 0.0, seed=None,
                              hash_seq_len: int | None = None):
    """(dq, dk, dv) from the forward's o and lse, in f32 math: the
    backward kernels' arithmetic without their casts. p = exp(s - lse)
    is recomputed; the dropout mask and rescale land on dp and on the p
    that multiplies dO; Drow = rowsum(dO o)."""
    if q.is_cuda:
        plain_cuda_calls["torch_flash_attention_bwd"] += 1
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    hash_seq_len = hash_seq_len or default_hash_seq_len(T)
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    p = torch.exp(_causal_scores(q, k, sm_scale) - lse.float()[..., None])
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    keep = _keep(seed, dropout_rate, B, H, T, hash_seq_len, q.device)
    p_v = p
    if keep is not None:
        scale = 1.0 / (1.0 - dropout_rate)
        p_v = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    drow = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - drow)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p_v, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(*named) -> None:
    """Everything the kernels do not take raises here, before a pointer
    leaves Python. named: (name, tensor) pairs, q first."""
    q = named[0][1]
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 and "
                        "bfloat16")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not in the kernels' set "
                         f"{HEAD_DIMS}")
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        want = (torch.float32 if name == "lse" else q.dtype)
        shape = q.shape[:3] if name == "lse" else q.shape
        if t.dtype != want or t.shape != shape:
            raise ValueError(f"{name} {t.dtype}{tuple(t.shape)} != "
                             f"{want}{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _dropout_args(q, seed, dropout_rate, hash_seq_len):
    """(seed words on q's device or None, (seed pointer, on, threshold,
    keep scale, hash_seq_len)) for a C entry point."""
    hash_seq_len = hash_seq_len or default_hash_seq_len(q.shape[2])
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    if dropout_rate <= 0.0:
        return None, (None, 0, 0, 1.0, hash_seq_len)
    _require_seed(seed, dropout_rate)
    words = seed_words(seed, q.device)
    return words, (words.data_ptr(), 1, dropout_threshold(dropout_rate),
                   1.0 / (1.0 - dropout_rate), hash_seq_len)


def flash_attention_fwd(q, k, v, *, sm_scale: float | None = None,
                        dropout_rate: float = 0.0, seed=None,
                        hash_seq_len: int | None = None):
    """K4: (o in q's dtype, lse (B, H, T) f32) for causal attention over
    (B, H, T, D). CUDA tensors launch flash_fwd_mma_kernel (bf16) or
    flash_fwd_f32_kernel (fp32); CPU tensors get
    the plain version."""
    if not q.is_cuda:
        return torch_flash_attention(q, k, v, sm_scale=sm_scale,
                                     dropout_rate=dropout_rate, seed=seed,
                                     hash_seq_len=hash_seq_len)
    _check(("q", q), ("k", k), ("v", v))
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    words, dr = _dropout_args(q, seed, dropout_rate, hash_seq_len)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _build.library().nsb_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dr[0], B * H, H, T, D, float(sm_scale),
        _DTYPE_CODE[q.dtype], *dr[1:],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash attention forward")
    launches["flash_attention_fwd"] += 1
    # words may go now: the caching allocator hands its block only to work
    # queued after this launch on the same stream.
    del words
    return o, lse


def _launch_bwd(mode: str, q, k, v, o, lse, do, dq, dk, dv, sm_scale,
                dropout_rate, seed, hash_seq_len) -> None:
    B, H, T, D = q.shape
    words, dr = _dropout_args(q, seed, dropout_rate, hash_seq_len)
    # K5 and K7 compute Drow = rowsum(dO o) once per row into this
    # (B*H, T) f32 scratch before their key-parallel kernel.
    drow = (torch.empty((B * H, T), dtype=torch.float32, device=q.device)
            if mode in ("fused", "dkv") else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.library().nsb_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dr[0], ptr(drow), ptr(dq), ptr(dk),
        ptr(dv), B * H, H, T, D, float(sm_scale), _DTYPE_CODE[q.dtype],
        *dr[1:], _BWD_MODE[mode],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, f"flash attention backward ({mode})")
    launches[f"flash_attention_bwd_{mode}"] += 1
    del words, drow


def _bwd_args(q, k, v, o, lse, do, sm_scale):
    _check(("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do))
    return q.shape[3] ** -0.5 if sm_scale is None else sm_scale


def flash_attention_bwd_dq(q, k, v, o, lse, do, *,
                           sm_scale: float | None = None,
                           dropout_rate: float = 0.0, seed=None,
                           hash_seq_len: int | None = None) -> torch.Tensor:
    """K6: dq in q's dtype, parallel over query tiles."""
    kw = dict(dropout_rate=dropout_rate, seed=seed, hash_seq_len=hash_seq_len)
    if not q.is_cuda:
        return torch_flash_attention_bwd(q, k, v, o, lse, do,
                                         sm_scale=sm_scale, **kw)[0]
    sm_scale = _bwd_args(q, k, v, o, lse, do, sm_scale)
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, o, lse, do, dq, None, None, sm_scale,
                dropout_rate, seed, hash_seq_len)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *,
                            sm_scale: float | None = None,
                            dropout_rate: float = 0.0, seed=None,
                            hash_seq_len: int | None = None):
    """K7: (dk, dv) in k's and v's dtype, parallel over key tiles."""
    kw = dict(dropout_rate=dropout_rate, seed=seed, hash_seq_len=hash_seq_len)
    if not q.is_cuda:
        return torch_flash_attention_bwd(q, k, v, o, lse, do,
                                         sm_scale=sm_scale, **kw)[1:]
    sm_scale = _bwd_args(q, k, v, o, lse, do, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, o, lse, do, None, dk, dv, sm_scale,
                dropout_rate, seed, hash_seq_len)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *,
                        sm_scale: float | None = None,
                        dropout_rate: float = 0.0, seed=None,
                        hash_seq_len: int | None = None):
    """(dq, dk, dv) from the forward's o and lse: K5 alone, or K6 then K7
    (BWD_IMPL 'fused' or 'split'). CUDA tensors launch the kernels; CPU
    tensors get torch_flash_attention_bwd."""
    kw = dict(dropout_rate=dropout_rate, seed=seed, hash_seq_len=hash_seq_len)
    if BWD_IMPL not in ("fused", "split"):
        raise ValueError(f"unknown BWD_IMPL {BWD_IMPL!r} (expected 'fused' "
                         "or 'split')")
    if not q.is_cuda:
        return torch_flash_attention_bwd(q, k, v, o, lse, do,
                                         sm_scale=sm_scale, **kw)
    if BWD_IMPL == "split":
        dq = flash_attention_bwd_dq(q, k, v, o, lse, do, sm_scale=sm_scale,
                                    **kw)
        return (dq, *flash_attention_bwd_dkv(q, k, v, o, lse, do,
                                             sm_scale=sm_scale, **kw))
    sm_scale = _bwd_args(q, k, v, o, lse, do, sm_scale)
    # K5 adds into dq from every key tile: zeroed f32, scaled and cast
    # after (as the JAX wrapper does outside its pallas_call).
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("fused", q, k, v, o, lse, do, dq, dk, dv, sm_scale,
                dropout_rate, seed, hash_seq_len)
    return (dq * sm_scale).to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    """o = dropout(softmax(causal q k^T * sm_scale)) v with the forward
    kernel (K4) and the backward of BWD_IMPL (K5, or K6 + K7). The
    wrappers below apply it to CUDA tensors; on CPU tensors its entry
    points take the plain versions (the CPU tests drive it that way)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, sm_scale, dropout_rate, hash_seq_len):
        o, lse = flash_attention_fwd(q, k, v, sm_scale=sm_scale,
                                     dropout_rate=dropout_rate, seed=seed,
                                     hash_seq_len=hash_seq_len)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.kw = dict(sm_scale=sm_scale, dropout_rate=dropout_rate,
                      hash_seq_len=hash_seq_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         seed=seed, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_dropout(q, k, v, seed, *, sm_scale: float | None = None,
                            dropout_rate: float = 0.0,
                            hash_seq_len: int | None = None) -> torch.Tensor:
    """Causal flash attention with attention-probability dropout in the
    kernels: o = dropout(softmax(s)) v, the mask keyed by the seed words
    (seed_words) and the element's position. Differentiable."""
    _require_seed(seed, dropout_rate)
    if not q.is_cuda:
        return torch_flash_attention(q, k, v, sm_scale=sm_scale,
                                     dropout_rate=dropout_rate, seed=seed,
                                     hash_seq_len=hash_seq_len)[0]
    words = seed_words(seed, q.device)
    return FlashAttention.apply(q, k, v, words, sm_scale, float(dropout_rate),
                                hash_seq_len)


def flash_attention(q, k, v, *, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """Causal flash attention over (B, H, T, D); differentiable."""
    return flash_attention_dropout(q, k, v, None, sm_scale=sm_scale)


def causal_attention(q, k, v, *, dropout_rate: float = 0.0, seed=None,
                     sm_scale: float | None = None) -> torch.Tensor:
    """The model's attention: dropout when dropout_rate > 0 and a seed is
    given (the training forward draws one per layer), none otherwise."""
    if dropout_rate > 0.0 and seed is not None:
        return flash_attention_dropout(q, k, v, seed, sm_scale=sm_scale,
                                       dropout_rate=dropout_rate)
    return flash_attention(q, k, v, sm_scale=sm_scale)
