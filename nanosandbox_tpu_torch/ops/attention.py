"""Flash attention for training, forward and backward.

The counterpart of nanosandbox_tpu/ops/attention.py. Its four Pallas
kernels become CUDA kernels (csrc/flash_attention.cu, built at first use
by ops/_build.py), each in a causal and a non-causal instance:

  flash_attention_fwd        (K4)  <- _flash_fwd_kernel
  flash_attention_bwd fused  (K5)  <- _flash_bwd_tiles_kernel(with_dq=True)
  flash_attention_bwd_dq     (K6)  <- _flash_bwd_dq_kernel
  flash_attention_bwd_dkv    (K7)  <- _flash_bwd_tiles_kernel(with_dq=False)

On bfloat16 all four run on the tensor cores: the non-causal ones (ring
attention's off-diagonal blocks) on wgmma, with tiles brought in by TMA
(csrc/flash_attention_sm90.cu; K5 in three launches: a pre-pass that
makes Drow and zeroes the f32 dQ accumulator, the kernel, whose dQ tiles
go out by bulk reduce-add, and the bf16 cast of dQ; K6 in one, Drow
computed in the kernel; K7 in two, the pre-pass and K5's kernel without
its dQ half), the causal ones on mma.sync. On float32 they run on
CUDA cores in exact f32 products, on cp.async-staged tiles read as
float4 (the causal K4 through the fp32 paged prefill's tile loop,
csrc/attend_f32.cuh; K5 and K7 after a Drow pre-pass; K6 with its Drow
computed in the kernel); the non-causal fp32 K4-K7 run the kernels
designed for the ring's block (csrc/flash_ring_f32.cuh; K5 in two
launches, a pre-pass that makes Drow and zeroes dq, and the kernel, which
adds dQ into it scaled; K7 in two, the pre-pass without the zeroing and
K5's kernel without its dQ half; K6 in one, Drow computed in the
kernel). The input type and ``causal`` alone pick the design
(``_on_wgmma``, ``_on_ring_f32``).

``BWD_IMPL`` picks the backward strategy, as in the JAX file: 'fused'
(K5, one pass; dQ summed across key tiles in f32 by atomicAdd, or by
TMA reduce-adds in the wgmma K5, so its summation order changes from run
to run) or 'split' (K6 then K7, a
deterministic backward that recomputes the score tiles twice).

Layouts are the JAX package's: q, k, v, o (B, H, T, D) in float32 or
bfloat16, lse and its cotangent dlse (B, H, T) float32. ``FlashAttention``
is the torch.autograd.Function over K4 and the backward, with outputs
(o, lse); ``flash_attention``, ``flash_attention_dropout`` and
``causal_attention`` are the entry points the model calls, and
``flash_attention_lse`` / ``flash_attention_lse_dropout`` the block
primitive of ring attention (ops/ring_attention.py): (o, lse) of a block,
causal or not, differentiable in both, the lse cotangent folded into the
backward's row term, ds = p (dp - (Drow - dlse)).

Routing, as in ops/flash_decode.py: a CUDA tensor goes to a kernel or
the call raises; a CPU tensor goes to the plain PyTorch version beside
it (``torch_flash_attention`` and ``torch_flash_attention_bwd``, the
backward kernels' arithmetic, which ``FlashAttention`` applies on the
CPU as it applies the kernels on CUDA; ``torch_flash_attention`` is
also differentiable by autograd, for comparison harnesses). There is
no probe and no fallback between the two. ``launches`` counts kernel
launches; ``plain_cuda_calls`` counts plain-version calls on CUDA
tensors (a comparison harness makes those on purpose; the training path
never does).

Activation checkpointing (remat, models/gpt.py): under the
'save_attention' policy a checkpointed block runs inside
``saving_attention(store)``. Its first run keeps every attention call's
(o, lse) in the ``SavedAttention`` store, in call order (the JAX
package's ``checkpoint_name("attn_out"/"attn_lse")`` tags); the
recompute in the backward takes them back from the store instead of
launching the forward kernel, so only the dense, LayerNorm and GELU work
runs again. ``FlashAttention`` is the one place that reads the store:
every attention call of the training path, the ring's blocks included,
goes through it.

Attention-probability dropout is the JAX kernels' counter-based hash
mask, bit for bit (``hash_dropout_keep_mask``): the same (5,) seed words
drop the same score elements in both packages. A head-sharded call (the
model axis: a rank's H / tp heads of H) carries a sixth word, the global
head count the stream id is linearised over (JAX's static
``hash_heads``); the kernels always read six (``_dropout_args`` adds a
0, "the call's H", to five). The Mosaic stat layouts
are not ported (on Hopper the lse is a plain (B*H, T) vector;
``attention_stat_layout`` selects nothing).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

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
           "flash_attention_lse", "flash_attention_lse_dropout",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "torch_flash_attention", "torch_flash_attention_bwd",
           "hash_dropout_keep_mask", "FlashAttention", "BWD_IMPL",
           "SavedAttention", "saving_attention", "launches",
           "plain_cuda_calls", "reset_counts"]

# Keyed by kernel, "/full" for the non-causal instance, "/dlse" for a
# backward given an lse cotangent: "flash_attention_fwd" is the causal K4,
# "flash_attention_bwd_fused/full/dlse" K5 on a non-causal ring block.
launches = {f"flash_attention_{kind}{full}{dl}": 0
            for kind in ("fwd", "bwd_fused", "bwd_dq", "bwd_dkv")
            for full in ("", "/full")
            for dl in (("",) if kind == "fwd" else ("", "/dlse"))}
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
    """The (SEED_WORDS,) int64 words (uint32 values) the kernels hash: a
    scalar or (1,) seed gets zero offsets (the non-ring path), a
    (SEED_WORDS,) vector, or one with the sixth word hash_heads of a
    head-sharded call (module docstring), is taken as it is; None is all
    zeros. A tensor stays on its device (a seed drawn on the card needs
    no host sync)."""
    if seed is None:
        return torch.zeros(SEED_WORDS, dtype=torch.int64, device=device)
    if isinstance(seed, torch.Tensor):
        words = seed.reshape(-1).to(device=device or seed.device,
                                    dtype=torch.int64) & _M32
    else:
        words = torch.tensor([int(x) & _M32 for x in
                              np.asarray(seed).reshape(-1).tolist()],
                             dtype=torch.int64, device=device)
    if words.numel() in (SEED_WORDS, SEED_WORDS + 1):
        return words.contiguous()
    if words.numel() != 1:
        raise ValueError(f"seed must hold 1 or {SEED_WORDS} words (or "
                         f"{SEED_WORDS + 1} with hash_heads), got "
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
    seed words. hash_heads: the argument, else the words' sixth, else
    H."""
    w = seed_words(seed, device).tolist()
    if hash_heads is None:
        hash_heads = w[SEED_WORDS] if len(w) > SEED_WORDS and w[
            SEED_WORDS] else H
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

def _scores(q, k, sm_scale, causal: bool = True) -> torch.Tensor:
    """f32 scores, scaled after the product; causal: NEG_INF above the
    diagonal (Tq == Tk, as every block here has)."""
    T = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if not causal:
        return s
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~mask, NEG_INF)


def _require_seed(seed, rate: float) -> None:
    # A silent constant seed would drop the same entries every step.
    if rate > 0.0 and seed is None:
        raise ValueError("flash attention dropout needs a per-step seed "
                         "when dropout_rate > 0")


def _keep(seed, rate, B, H, T, hash_seq_len,
          device) -> torch.Tensor | None:
    if rate <= 0.0:
        return None
    _require_seed(seed, rate)
    return hash_dropout_keep_mask(seed, B, H, T, T,
                                  hash_seq_len=hash_seq_len, rate=rate,
                                  device=device)


def torch_flash_attention(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None,
                          dropout_rate: float = 0.0, seed=None,
                          hash_seq_len: int | None = None):
    """Attention over (B, H, T, D) in f32 math, causal or not,
    differentiable in both outputs: (o in q's dtype, lse (B, H, T) f32).
    With dropout_rate > 0 the softmax weights go through the hash
    keep-mask and the 1/(1-rate) rescale before p.v; lse is that of the
    unmasked scores, as the kernels'."""
    if q.is_cuda:
        plain_cuda_calls["torch_flash_attention"] += 1
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    hash_seq_len = hash_seq_len or default_hash_seq_len(T)
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    s = _scores(q, k, sm_scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    keep = _keep(seed, dropout_rate, B, H, T, hash_seq_len, q.device)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def torch_flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                              dlse=None, sm_scale: float | None = None,
                              dropout_rate: float = 0.0, seed=None,
                              hash_seq_len: int | None = None):
    """(dq, dk, dv) from the forward's o and lse, in f32 math: the
    backward kernels' arithmetic without their casts. p = exp(s - lse)
    is recomputed; the dropout mask and rescale land on dp and on the p
    that multiplies dO; Drow = rowsum(dO o), less the lse cotangent dlse
    (B, H, T) when given."""
    if q.is_cuda:
        plain_cuda_calls["torch_flash_attention_bwd"] += 1
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    hash_seq_len = hash_seq_len or default_hash_seq_len(T)
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    p = torch.exp(_scores(q, k, sm_scale, causal) - lse.float()[..., None])
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    keep = _keep(seed, dropout_rate, B, H, T, hash_seq_len, q.device)
    p_v = p
    if keep is not None:
        scale = 1.0 / (1.0 - dropout_rate)
        p_v = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    drow = (dof * o.float()).sum(-1, keepdim=True)
    if dlse is not None:
        drow = drow - dlse.float()[..., None]
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
    leaves Python. named: (name, tensor) pairs, q first; a None tensor
    (no dlse) is skipped."""
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
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        stat = name in ("lse", "dlse")
        want = torch.float32 if stat else q.dtype
        shape = q.shape[:3] if stat else q.shape
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
    keep scale, hash_seq_len)) for a C entry point. The kernels read six
    words: the sixth, hash_heads, 0 when the call's own heads are the
    stream's."""
    hash_seq_len = hash_seq_len or default_hash_seq_len(q.shape[2])
    _check_dropout_seq_len(dropout_rate, hash_seq_len)
    if dropout_rate <= 0.0:
        return None, (None, 0, 0, 1.0, hash_seq_len)
    _require_seed(seed, dropout_rate)
    words = seed_words(seed, q.device)
    if words.numel() == SEED_WORDS:
        words = torch.cat([words, words.new_zeros(1)])
    return words, (words.data_ptr(), 1, dropout_threshold(dropout_rate),
                   1.0 / (1.0 - dropout_rate), hash_seq_len)


def _instance(causal: bool, dlse=None) -> str:
    """The launch-count suffix of a kernel instance."""
    return ("" if causal else "/full") + ("" if dlse is None else "/dlse")


def _on_wgmma(q, causal: bool) -> bool:
    """Whether a call runs the Hopper kernels of flash_attention_sm90.cu
    (wgmma, TMA): every non-causal bf16 call, forward or backward."""
    return q.dtype == torch.bfloat16 and not causal


def _on_ring_f32(q, causal: bool) -> bool:
    """Whether a call runs the fp32 kernels of csrc/flash_ring_f32.cuh:
    every non-causal fp32 call, forward or backward (nsb_flash_fwd and
    nsb_flash_bwd route them there)."""
    return q.dtype == torch.float32 and not causal


def wgmma_launch_shape(kind: str, BH: int, T: int, D: int) -> dict:
    """The grid, threads a block and blocks an SM (the occupancy the
    kernel's registers and shared memory allow) of the non-causal bf16
    K4 ("fwd") or of the main kernel of K5 ("fused"), K6 ("dq") or K7
    ("dkv") at (B*H, T, D), as the launcher computes them. Needs the
    card."""
    out = (ctypes.c_int * 4)()
    err = _build.library().nsb_flash_sm90_shape(
        -1 if kind == "fwd" else _BWD_MODE[kind], BH, T, D,
        ctypes.addressof(out))
    _raise_on(err, f"flash attention {kind} launch shape")
    return {"grid": (out[0], out[1]), "threads": out[2],
            "blocks_per_sm": out[3]}


def ring_f32_launch_shape(kind: str, BH: int, T: int, D: int) -> dict:
    """The grid, threads a block, blocks an SM, dynamic shared memory
    (bytes) and registers a thread of the non-causal fp32 K4 ("fwd"), K6
    ("dq") or the main kernel of K5 ("fused") or K7 ("dkv") at (B*H, T,
    D), without dropout, as the launcher computes them. Needs the
    card."""
    out = (ctypes.c_int * 6)()
    err = _build.library().nsb_flash_ring_f32_shape(
        -1 if kind == "fwd" else _BWD_MODE[kind], BH, T, D,
        ctypes.addressof(out))
    _raise_on(err, f"flash attention fp32 {kind} launch shape")
    return {"grid": (out[0], out[1]), "threads": out[2],
            "blocks_per_sm": out[3], "smem": out[4], "registers": out[5]}


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None,
                        dropout_rate: float = 0.0, seed=None,
                        hash_seq_len: int | None = None):
    """K4: (o in q's dtype, lse (B, H, T) f32) for attention over
    (B, H, T, D), causal or not. CUDA tensors launch
    flash_fwd_wgmma_kernel (bf16, non-causal), flash_fwd_mma_kernel (bf16,
    causal), flash_fwd_ring_f32_kernel (fp32, non-causal) or
    flash_fwd_f32_kernel (fp32, causal); CPU tensors get the plain
    version."""
    kw = dict(causal=causal, sm_scale=sm_scale, dropout_rate=dropout_rate,
              seed=seed, hash_seq_len=hash_seq_len)
    if not q.is_cuda:
        return torch_flash_attention(q, k, v, **kw)
    _check(("q", q), ("k", k), ("v", v))
    B, H, T, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch_fwd(q, k, v, o, lse, sm_scale, causal=causal,
                dropout_rate=dropout_rate, seed=seed,
                hash_seq_len=hash_seq_len)
    return o, lse


def _launch_fwd(q, k, v, o, lse, sm_scale, *, causal, dropout_rate, seed,
                hash_seq_len) -> None:
    """One forward kernel call into o and lse."""
    B, H, T, D = q.shape
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    words, dr = _dropout_args(q, seed, dropout_rate, hash_seq_len)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dr[0], B * H, H, T, D, float(sm_scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.library()
    if _on_wgmma(q, causal):
        err = lib.nsb_flash_fwd_sm90(*ptrs, *dr[1:], stream)
    else:
        err = lib.nsb_flash_fwd(*ptrs, _DTYPE_CODE[q.dtype], *dr[1:],
                                int(causal), stream)
    _raise_on(err, "flash attention forward")
    launches["flash_attention_fwd" + _instance(causal)] += 1
    # words may go now: the caching allocator hands its block only to work
    # queued after this launch on the same stream.
    del words


def _launch_bwd(mode: str, q, k, v, o, lse, do, dq, dk, dv, sm_scale, *,
                causal, dlse, dropout_rate, seed, hash_seq_len) -> None:
    """One backward kernel call. The mma.sync and causal f32 K5 take dq
    as their zeroed f32 accumulator; every other call writes dq in q's
    dtype."""
    B, H, T, D = q.shape
    words, dr = _dropout_args(q, seed, dropout_rate, hash_seq_len)
    sm90 = _on_wgmma(q, causal)
    # K5 and K7 compute Drow = rowsum(dO o) - dlse once per row into a
    # scratch before their key-parallel kernel: (B*H, T) f32, or on wgmma
    # (2, B*H, T rounded up to 4), lse beside it; the wgmma K5 also sums
    # dQ into an f32 accumulator. K6 computes Drow itself.
    drow = dq_acc = None
    if mode in ("fused", "dkv"):
        drow = torch.empty((2, B * H, -(-T // 4) * 4) if sm90 else
                           (B * H, T), dtype=torch.float32, device=q.device)
    if sm90 and mode == "fused":
        dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ptr(dlse), dr[0], ptr(drow))
    shape = (B * H, H, T, D, float(sm_scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.library()
    if sm90:
        err = lib.nsb_flash_bwd_sm90(*head, ptr(dq_acc), ptr(dq), ptr(dk),
                                     ptr(dv), *shape, *dr[1:],
                                     _BWD_MODE[mode], stream)
    else:
        err = lib.nsb_flash_bwd(*head, ptr(dq), ptr(dk), ptr(dv), *shape,
                                _DTYPE_CODE[q.dtype], *dr[1:], int(causal),
                                _BWD_MODE[mode], stream)
    _raise_on(err, f"flash attention backward ({mode})")
    launches[f"flash_attention_bwd_{mode}" + _instance(causal, dlse)] += 1
    del words, drow, dq_acc


def _bwd_args(q, k, v, o, lse, do, dlse, sm_scale):
    _check(("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse), ("do", do),
           ("dlse", dlse))
    return q.shape[3] ** -0.5 if sm_scale is None else sm_scale


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           dlse=None, sm_scale: float | None = None,
                           dropout_rate: float = 0.0, seed=None,
                           hash_seq_len: int | None = None
                           ) -> torch.Tensor:
    """K6: dq in q's dtype, parallel over query tiles. CUDA tensors
    launch flash_bwd_dq_wgmma_kernel (bf16, non-causal),
    flash_bwd_dq_mma_kernel (bf16, causal), flash_bwd_dq_ring_f32_kernel
    (fp32, non-causal) or flash_bwd_dq_f32_kernel (fp32, causal); CPU
    tensors get the plain version."""
    kw = dict(causal=causal, dlse=dlse, dropout_rate=dropout_rate, seed=seed,
              hash_seq_len=hash_seq_len)
    if not q.is_cuda:
        return torch_flash_attention_bwd(q, k, v, o, lse, do,
                                         sm_scale=sm_scale, **kw)[0]
    sm_scale = _bwd_args(q, k, v, o, lse, do, dlse, sm_scale)
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, o, lse, do, dq, None, None, sm_scale, **kw)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, *, causal: bool = True,
                            dlse=None, sm_scale: float | None = None,
                            dropout_rate: float = 0.0, seed=None,
                            hash_seq_len: int | None = None):
    """K7: (dk, dv) in k's and v's dtype, parallel over key tiles. CUDA
    tensors launch a pre-pass and flash_bwd_wgmma_kernel<D, false>
    (bf16, non-causal), flash_bwd_mma_kernel<D, false> (bf16, causal),
    flash_bwd_ring_f32_kernel<D, BK, false> (fp32, non-causal) or
    flash_bwd_kv_kernel<D, false> (fp32, causal); CPU tensors get the
    plain version."""
    kw = dict(causal=causal, dlse=dlse, dropout_rate=dropout_rate, seed=seed,
              hash_seq_len=hash_seq_len)
    if not q.is_cuda:
        return torch_flash_attention_bwd(q, k, v, o, lse, do,
                                         sm_scale=sm_scale, **kw)[1:]
    sm_scale = _bwd_args(q, k, v, o, lse, do, dlse, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, k, v, o, lse, do, None, dk, dv, sm_scale, **kw)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        dlse=None, sm_scale: float | None = None,
                        dropout_rate: float = 0.0, seed=None,
                        hash_seq_len: int | None = None):
    """(dq, dk, dv) from the forward's o and lse (and the lse cotangent
    dlse, if any): K5 alone, or K6 then K7 (BWD_IMPL 'fused' or 'split').
    CUDA tensors launch the kernels; CPU tensors get
    torch_flash_attention_bwd."""
    kw = dict(causal=causal, dlse=dlse, dropout_rate=dropout_rate, seed=seed,
              hash_seq_len=hash_seq_len)
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
    sm_scale = _bwd_args(q, k, v, o, lse, do, dlse, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _on_wgmma(q, causal) or _on_ring_f32(q, causal):
        # The kernels zero, fill and scale the f32 accumulator (on wgmma
        # also cast it) themselves: no elementwise op here.
        dq = torch.empty_like(q)
        _launch_bwd("fused", q, k, v, o, lse, do, dq, dk, dv, sm_scale, **kw)
        return dq, dk, dv
    # K5 adds into dq from every key tile: zeroed f32, scaled and cast
    # after (as the JAX wrapper does outside its pallas_call).
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    _launch_bwd("fused", q, k, v, o, lse, do, dq, dk, dv, sm_scale, **kw)
    return (dq * sm_scale).to(q.dtype), dk, dv


# ---------------------------------------------------------------------------
# The saved attention outputs of a checkpointed block (remat)
# ---------------------------------------------------------------------------

class SavedAttention:
    """The (o, lse) of each attention call of one checkpointed block run,
    in call order: kept by the first run, handed back one by one by the
    recompute (``replay``)."""

    def __init__(self):
        self.outs: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.replay = False
        self._next = 0

    def take(self):
        o, lse = self.outs[self._next]
        self._next += 1
        # Fresh aliases: the Function's output wrapping must not touch the
        # tensors the first run's graph holds.
        return o.detach(), lse.detach()


_current = threading.local()


@contextlib.contextmanager
def saving_attention(store: SavedAttention | None):
    """Within this context every FlashAttention call of the current
    thread keeps its (o, lse) in ``store`` (its first run) or takes them
    back from it (``store.replay``: the recompute, which starts at the
    first call again). ``store=None`` is a no-op: the 'full' policy."""
    outer = getattr(_current, "store", None)
    if store is not None:
        store._next = 0
    _current.store = store
    try:
        yield store
    finally:
        _current.store = outer


class FlashAttention(torch.autograd.Function):
    """(o, lse) = (dropout(softmax(q k^T * sm_scale)) v, logsumexp of the
    scores), causal or not, with the forward kernel (K4) and the backward
    of BWD_IMPL (K5, or K6 + K7); lse's cotangent, when lse reaches a loss,
    folds into the backward's row term. On CPU tensors the same entry
    points take the plain versions. Inside ``saving_attention(store)``
    the first run keeps (o, lse) in the store and a replay takes them
    from it without launching the forward."""

    @staticmethod
    def forward(ctx, q, k, v, seed, causal, sm_scale, dropout_rate,
                hash_seq_len):
        kw = dict(causal=causal, sm_scale=sm_scale,
                  dropout_rate=dropout_rate, hash_seq_len=hash_seq_len)
        store = getattr(_current, "store", None)
        if store is not None and store.replay:
            o, lse = store.take()
        else:
            o, lse = flash_attention_fwd(q, k, v, seed=seed, **kw)
            if store is not None:
                store.outs.append((o.detach(), lse.detach()))
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.kw = kw
        # An unused output's cotangent arrives as None: no dlse, no dO.
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seed = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), seed=seed,
            dlse=None if dlse is None else dlse.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_lse_dropout(q, k, v, seed, causal: bool = True,
                                sm_scale: float | None = None,
                                rate: float = 0.0,
                                hash_heads: int | None = None,
                                hash_seq_len: int | None = None):
    """(o, lse (B, H, T) f32) of attention over (B, H, T, D), causal or
    not, with attention-probability dropout keyed by GLOBAL coordinates:
    ``seed`` holds the (5,) words [seed, b_off, h_off, q_off, k_off] (or
    one seed, offsets 0), ``hash_heads`` / ``hash_seq_len`` the global
    head count and sequence length the mask hash runs over, so every ring
    block drops the elements the whole-sequence call would. lse is that
    of the unmasked scores. Differentiable in both outputs, through
    FlashAttention on either device. ``hash_heads`` larger than the
    call's H is a head-sharded call: the seed's head offset names its
    first head, and it rides in the words' sixth (None: the words' own,
    else the call's H)."""
    _require_seed(seed, rate)
    words = seed_words(seed, q.device)
    if hash_heads is not None and hash_heads != q.shape[1]:
        if hash_heads < q.shape[1]:
            raise ValueError(f"hash_heads {hash_heads} < the call's "
                             f"{q.shape[1]} heads")
        words = torch.cat([words[:SEED_WORDS],
                           words.new_tensor([hash_heads])])
    return FlashAttention.apply(q, k, v, words, bool(causal), sm_scale,
                                float(rate), hash_seq_len)


def flash_attention_lse(q, k, v, causal: bool = True,
                        sm_scale: float | None = None):
    """(o, lse (B, H, T) f32) of attention over (B, H, T, D), causal or
    not; differentiable in both (the block primitive of ring attention)."""
    return flash_attention_lse_dropout(q, k, v, None, causal, sm_scale)


def flash_attention_dropout(q, k, v, seed, *, sm_scale: float | None = None,
                            dropout_rate: float = 0.0,
                            hash_seq_len: int | None = None) -> torch.Tensor:
    """Causal flash attention with attention-probability dropout in the
    kernels: o = dropout(softmax(s)) v, the mask keyed by the seed words
    (seed_words) and the element's position. Differentiable."""
    return flash_attention_lse_dropout(q, k, v, seed, True, sm_scale,
                                       dropout_rate,
                                       hash_seq_len=hash_seq_len)[0]


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
