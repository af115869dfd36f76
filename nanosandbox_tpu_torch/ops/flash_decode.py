"""Decode and paged attention over the serve engine's KV pools.

The counterpart of nanosandbox_tpu/ops/flash_decode.py:

  flash_decode         (T = 1, contiguous slot rows) <- _flash_decode_kernel
  flash_decode_paged   (T = 1, block-paged pool)     <- _paged_decode_kernel
  flash_prefill_paged  (T > 1, block-paged pool)     <- _paged_prefill_kernel

and its quantizers (quantize_kv_rows, quantize_kv_rows_int4, unpack_int4).

Each wrapper takes the JAX function's layouts: q (B, H, D) or
(B, H, T, D); k/v (B, H, L, D) slot rows or (num_blocks, H, page, D)
blocks, in float32, bfloat16, int8, or packed int4 (uint8, trailing dim
D // 2: dim 2j in the low nibble, 2j+1 in the high one, both biased by
+8); int8/int4 pools come with k_scale / v_scale, f32 and shaped like the
pool without its last dim, and fp pools without them; block_table
(B, max_blocks) int32 whose entries >= num_blocks are the engine's "no
block" sentinel; lengths / start (B,) int32. All return q's dtype, with
f32 scores and accumulation. The scales fold into the math as in the JAX
functions: s = (q . k_int) * k_scale * sm_scale, the normaliser sums the
unscaled p, and the output is (p * v_scale) . v_int. Every path rounds
p (p * v_scale) to the dtype JAX feeds its p.v product in (``_dot_dtype``):
bf16 for a bf16 query over a bf16, int8 or int4 pool, f32 otherwise, as
the kernels do.

Routing: a CUDA tensor goes to the hand-written kernel
(csrc/flash_decode.cu, csrc/paged_attention.cu, built at first use by
ops/_build.py) or the wrapper raises; a CPU tensor goes to the plain
PyTorch version beside it. There is no probe and no fallback between
the two. ``launches`` counts kernel launches per wrapper and kv mode
(``flash_decode/int8``, ...), so a run can show which instances its main
path went through; ``plain_cuda_calls`` counts plain-version calls on
CUDA tensors (a comparison harness makes those on purpose; the serving
path never does).
"""

from __future__ import annotations

import ctypes

import torch

from nanosandbox_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
# Storage dtype of each kv mode's values (int4: two nibbles per uint8).
KV_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8, "int4": torch.uint8}
KV_MODES = tuple(KV_STORAGE)
_MODE = {dtype: mode for mode, dtype in KV_STORAGE.items()}
# Dtype codes of the C entry points (csrc/decode_common.cuh DType).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.uint8: 3}
_Q_DTYPES = (torch.float32, torch.bfloat16)

# The paged decode's split rule (decode_splits): blocks a launch aims at
# per SM, and the pages one split may hold (csrc/decode_common.cuh
# kMaxSplitPages).
SPLIT_BLOCKS_PER_SM = 2
MAX_SPLIT_PAGES = 256
# The dense decode's splits hold whole chunks of this many positions
# (csrc/flash_decode.cu kChunk).
DENSE_CHUNK = 64

__all__ = ["flash_decode", "flash_decode_paged", "flash_prefill_paged",
           "torch_decode_attention", "torch_decode_attention_paged",
           "torch_prefill_attention_paged", "masked_cache_attention",
           "quantize_kv_rows", "quantize_kv_rows_int4", "unpack_int4",
           "decode_splits",
           "dense_decode_splits", "dense_decode_launch_shape",
           "ticket_counters", "launches", "plain_cuda_calls", "reset_counts"]

launches = {f"{fn}/{mode}": 0
            for fn in ("flash_decode", "flash_decode_paged",
                       "flash_prefill_paged") for mode in KV_MODES}
plain_cuda_calls = {"torch_decode_attention": 0,
                    "torch_decode_attention_paged": 0,
                    "torch_prefill_attention_paged": 0}


def reset_counts() -> None:
    for d in (launches, plain_cuda_calls):
        for key in d:
            d[key] = 0


# ---------------------------------------------------------------------------
# Quantization (the JAX package's, op for op: jnp.round and torch.round
# both round half to even and the f32 divide is IEEE in both, so the ints
# and scales come out bit-identical)
# ---------------------------------------------------------------------------

def quantize_kv_rows(x: torch.Tensor, valid=None):
    """Per-row symmetric int8 quantization over the trailing (head_dim)
    axis: (values int8 x.shape, scales f32 x.shape[:-1]), scale =
    max|row| / 127. All-zero rows quantize to zeros exactly.

    ``valid`` (optional bool, broadcastable to x.shape[:-1]): False rows
    skip the scale chain (scale pinned to 1 for the divide, values and
    the returned scale zeroed); their writes are bound for the drop
    block anyway."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-30) / 127.0
    if valid is not None:
        scale = torch.where(valid, scale, 1.0)
        xf = torch.where(valid[..., None], xf, 0.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    if valid is not None:
        scale = torch.where(valid, scale, 0.0)
    return q, scale


def quantize_kv_rows_int4(x: torch.Tensor, valid=None):
    """Per-row symmetric int4 quantization, two nibbles per byte packed
    along head_dim: (packed uint8 x.shape[:-1] + (D // 2,), scales f32
    x.shape[:-1]), scale = max|row| / 7, levels [-7, 7] biased by +8
    (dim 2j low nibble, 2j+1 high). ``valid`` as in quantize_kv_rows;
    an all-zero or invalid row packs to 0x88 bytes, which decode to 0."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even head_dim, "
                         f"got {x.shape[-1]}")
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-30) / 7.0
    if valid is not None:
        scale = torch.where(valid, scale, 1.0)
        xf = torch.where(valid[..., None], xf, 0.0)
    q = (torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int32)
         + 8)                                       # nibbles in [1, 15]
    packed = (q[..., 0::2] | (q[..., 1::2] << 4)).to(torch.uint8)
    if valid is not None:
        scale = torch.where(valid, scale, 0.0)
    return packed, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 (..., D // 2) -> int8 (..., D): the inverse of
    quantize_kv_rows_int4's nibble layout (low nibble first)."""
    lo = (packed & 15).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def _kv_mode(q, k, v, k_scale, v_scale) -> str:
    """The pool's kv mode ('fp32' | 'bf16' | 'int8' | 'int4') after the
    checks every path makes: q in float32/bfloat16; v like k; scales f32,
    contiguous, shaped like the pool without its last dim, given as a
    pair, with int8/uint8 pools and only with them; q's D equal to the
    pool's logical D (twice the stored D of packed int4)."""
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 and "
                        "bfloat16 queries")
    if k.dtype not in _MODE:
        raise TypeError(f"k dtype {k.dtype}: pools are float32, bfloat16, "
                        "int8 or packed int4 (uint8)")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"v {v.dtype}{tuple(v.shape)} != k "
                         f"{k.dtype}{tuple(k.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be supplied together")
    mode = _MODE[k.dtype]
    quantized = mode in ("int8", "int4")
    if quantized and k_scale is None:
        raise ValueError(f"an {mode} pool needs k_scale / v_scale")
    if not quantized and k_scale is not None:
        raise ValueError(f"scales supplied for a non-quantized pool "
                         f"({k.dtype})")
    if quantized:
        for s, what in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if s.dtype != torch.float32:
                raise TypeError(f"{what} must be float32, got {s.dtype}")
            if tuple(s.shape) != tuple(k.shape[:-1]):
                raise ValueError(f"{what} shape {tuple(s.shape)} != "
                                 f"{tuple(k.shape[:-1])} (the pool without "
                                 "its last dim)")
            if not s.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
            if s.device != k.device:
                raise ValueError(f"{what} is on {s.device}, k on {k.device}")
    D = k.shape[-1] * (2 if mode == "int4" else 1)
    if q.shape[-1] != D:
        raise ValueError(f"q head_dim {q.shape[-1]} != the pool's {D}")
    return mode


def _values(pool: torch.Tensor) -> torch.Tensor:
    """A pool's values as f32 (packed int4 unpacked first)."""
    if pool.dtype == torch.uint8:
        pool = unpack_int4(pool)
    return pool.float()


def _gather_chain(pool: torch.Tensor, block_table: torch.Tensor):
    """(N, H, page, ...) pool + (B, nb) table -> (B, H, nb*page, ...)
    rows. Sentinel entries clamp to block N - 1; their positions lie past
    every frontier and are masked by the callers."""
    N, H, page = pool.shape[:3]
    B, nb = block_table.shape
    tbl = block_table.clamp(0, N - 1).long()
    g = pool[tbl].transpose(1, 2)                   # (B, H, nb, page, ...)
    return g.reshape(B, H, nb * page, *pool.shape[3:])


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and the reference the kernels are held to
# ---------------------------------------------------------------------------

def _attend(q, gk, gv, mask, ks, vs, sm_scale, p_dtype=torch.float32):
    """Masked softmax attention of q (..., T, D) over f32 rows (..., S, D)
    with the scale folds; ks / vs (..., S) or None. p (p * vs) is rounded
    to p_dtype before the p.v product, which sums in f32."""
    s = torch.einsum("...td,...sd->...ts", q.float(), gk)
    if ks is not None:
        s = s * ks[..., None, :]
    s = s * sm_scale
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    if vs is not None:
        p = p * vs[..., None, :]
    return torch.einsum("...ts,...sd->...td", p.to(p_dtype).float(), gv)


def _dot_dtype(q, k, k_scale) -> torch.dtype:
    """The dtype JAX's kernels feed p.v in (flash_decode.py
    _flash_decode_kernel's dot_dt): q's over an int8/int4 pool, else the
    promotion of q's and the pool's."""
    return (q.dtype if k_scale is not None
            else torch.promote_types(q.dtype, k.dtype))


def torch_decode_attention(q, k, v, lengths, *, k_scale=None, v_scale=None,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Single-query masked attention over contiguous slot rows: q
    (B, H, D) attends to positions [0, lengths[b]) of k/v (B, H, L, D).
    Returns (B, H, D); a row with lengths[b] <= 0 attends to nothing and
    returns zeros (JAX's xla_decode_attention has no such rows)."""
    _kv_mode(q, k, v, k_scale, v_scale)
    if q.is_cuda:
        plain_cuda_calls["torch_decode_attention"] += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    lengths = lengths.to(q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    mask = (kpos[None, :] < lengths[:, None])[:, None, None, :]
    out = _attend(q[:, :, None], _values(k), _values(v), mask, k_scale,
                  v_scale, sm_scale, _dot_dtype(q, k, k_scale))[:, :, 0]
    return torch.where((lengths > 0)[:, None, None], out, 0.0).to(q.dtype)


def torch_decode_attention_paged(q, k, v, block_table, lengths, *,
                                 sm_scale: float | None = None,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-query masked attention over a row's block chain, gathered:
    q (B, H, D) attends to positions [0, lengths[b]). Returns (B, H, D);
    a row with lengths[b] <= 0 attends to nothing and returns zeros."""
    _kv_mode(q, k, v, k_scale, v_scale)
    if q.is_cuda:
        plain_cuda_calls["torch_decode_attention_paged"] += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    gk = _gather_chain(_values(k), block_table)
    gv = _gather_chain(_values(v), block_table)
    gks = gvs = None
    if k_scale is not None:
        gks = _gather_chain(k_scale, block_table)
        gvs = _gather_chain(v_scale, block_table)
    lengths = lengths.to(q.device)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = (kpos[None, :] < lengths[:, None])[:, None, None, :]
    out = _attend(q[:, :, None], gk, gv, mask, gks, gvs, sm_scale,
                  _dot_dtype(q, k, k_scale))[:, :, 0]
    return torch.where((lengths > 0)[:, None, None], out, 0.0).to(q.dtype)


def torch_prefill_attention_paged(q, k, v, block_table, start, *,
                                  sm_scale: float | None = None,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Causal multi-query attention over a row's block chain, gathered:
    query t of row b sits at position start[b] + t and attends to every
    key position <= its own. Returns (B, H, T, D). p is rounded to JAX's
    dot dtype before p.v (flash_decode.py _paged_prefill_kernel): q's
    dtype over an int8/int4 pool, else the promotion of q's and the
    pool's, so only a bf16 query over a bf16, int8 or int4 pool rounds
    it."""
    _kv_mode(q, k, v, k_scale, v_scale)
    if q.is_cuda:
        plain_cuda_calls["torch_prefill_attention_paged"] += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    T = q.shape[2]
    gk = _gather_chain(_values(k), block_table)
    gv = _gather_chain(_values(v), block_table)
    gks = gvs = None
    if k_scale is not None:
        gks = _gather_chain(k_scale, block_table)
        gvs = _gather_chain(v_scale, block_table)
    qpos = (start.to(q.device).long()[:, None]
            + torch.arange(T, device=q.device)[None, :])        # (B, T)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # (B,1,T,S)
    return _attend(q, gk, gv, mask, gks, gvs, sm_scale,
                   _dot_dtype(q, k, k_scale)).to(q.dtype)


def masked_cache_attention(q, k, v, qpos, *, k_scale=None, v_scale=None,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Multi-query masked attention over contiguous slot rows: query t
    of row b sits at position qpos[b, t] and attends to every key
    position <= it of k/v (B, H, L, D), the whole buffer included.
    Returns (B, H, T, D) in q's dtype. The dense pool's speculative
    verify (a T = k+1 block at per-row frontiers) reads through this:
    JAX computes that read with the masked-score XLA path of
    models/gpt.py, outside any Pallas kernel, so it has no kernel here
    either and is not a plain version (plain_cuda_calls does not count
    it). p is rounded as JAX's path rounds it: to q's dtype over an
    int8/int4 pool, else to the pool's."""
    _kv_mode(q, k, v, k_scale, v_scale)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kpos = torch.arange(k.shape[2], device=q.device)
    mask = (kpos[None, None, :] <= qpos.long()[:, :, None])[:, None]
    p_dtype = q.dtype if k_scale is not None else v.dtype
    return _attend(q, _values(k), _values(v), mask, k_scale, v_scale,
                   sm_scale, p_dtype).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def decode_splits(B: int, H: int, nb: int, page: int,
                  sms: int) -> tuple[int, int]:
    """(S, Ls): the paged decode kernel splits each row's chain of nb
    pages into S splits of Ls positions, Ls a whole number of pages, so
    that the B*H*S blocks reach SPLIT_BLOCKS_PER_SM blocks on each of the
    ``sms`` SMs wherever nb pages allow (a split holds at least a page),
    as evenly as whole pages allow. The splits cover [0, nb*page), each
    position once; a split holds at most MAX_SPLIT_PAGES pages, and Ls *
    page stays below 2^31 (the kernel's page division). The lengths play
    no part: the grid is fixed before the device is asked anything."""
    if min(B, H, page, sms) < 1 or nb < 0:
        raise ValueError(f"decode_splits({B}, {H}, {nb}, {page}, {sms}): "
                         "B, H, page and sms must be >= 1, nb >= 0")
    if page * page >= 1 << 31:
        raise ValueError(f"page {page}: the paged decode kernel takes pages "
                         "of fewer than 46341 positions")
    want = max(1, min(-(-SPLIT_BLOCKS_PER_SM * sms // (B * H)), nb))
    pps = max(1, -(-nb // want))                  # pages a split
    while pps > 1 and -(-nb // pps) < want:
        pps -= 1
    pps = min(pps, MAX_SPLIT_PAGES, ((1 << 31) - 1) // (page * page))
    return max(1, -(-nb // pps)), pps * page


def dense_decode_splits(B: int, H: int, L: int,
                        sms: int) -> tuple[int, int]:
    """(S, Ls): the dense decode kernel's grid has S split slots for each
    (row, head) of a (B, H, L, D) pool, and S splits of Ls positions, Ls a
    whole number of DENSE_CHUNK-position chunks, cover [0, L) once: K2's
    rule (decode_splits) over those chunks, so that B*H*S reaches
    SPLIT_BLOCKS_PER_SM blocks on each of the ``sms`` SMs wherever L
    allows. The lengths play no part. At run time the kernel gives a row
    of len positions only as many slots as its length pays for (csrc/
    flash_decode.cu SplitAt), splitting it into that many runs of whole
    chunks; a row of L positions that takes every slot walks splits of at
    most Ls."""
    if min(B, H, L, sms) < 1:
        raise ValueError(f"dense_decode_splits({B}, {H}, {L}, {sms}): "
                         "B, H, L and sms must be >= 1")
    return decode_splits(B, H, -(-L // DENSE_CHUNK), DENSE_CHUNK, sms)


_sm_counts: dict = {}
_tickets: dict = {}


def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode kernels' (row, head) ticket counters, shared by K2 and
    K3: int32 zeros, one buffer per device (a tensor's device, with its
    index), made anew when a call has more rows. The kernels leave them
    zero, so calls on one stream share them; calls on two streams at once
    must not. A CUDA graph keeps the pointer it captured, and a buffer
    made anew frees the old one: whoever replays a graph holds the buffer
    this returned before the capture (serve/engine.py does)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = _tickets[device] = torch.zeros(n, dtype=torch.int32,
                                             device=device)
    return buf


def _check_kernel_args(tensors, vec, name: str) -> None:
    """Everything the kernels do not take raises here, before a pointer
    leaves Python: devices, index dtypes, head_dim, contiguity, and
    16-byte alignment of q and the pool."""
    q = tensors["q"]
    dev = q.device
    for what, t in (*tensors.items(), (name, vec)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if what in ("block_table", name) and t.dtype != torch.int32:
            raise TypeError(f"{what} must be int32, got {t.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernels' set {HEAD_DIMS}")
    for what in ("q", "k", "v"):
        if tensors[what].data_ptr() % 16:
            raise ValueError(f"{what} is not 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def dense_decode_launch_shape(q_dtype: torch.dtype, mode: str,
                              D: int) -> dict:
    """The threads a block, shared memory (the ring's dynamic bytes and the
    static ones), registers a thread, blocks an SM and split length (the
    positions a block walks before a row splits over more) of the dense
    decode kernel's (query, pool, head_dim) instance. Needs the card."""
    out = (ctypes.c_int * 6)()
    err = _build.library().nsb_flash_decode_shape(
        _DTYPE_CODE[q_dtype], _DTYPE_CODE[KV_STORAGE[mode]], D,
        ctypes.addressof(out))
    _raise_on(err, "flash decode launch shape")
    return {"threads": out[0], "smem": out[1], "static_smem": out[2],
            "registers": out[3], "blocks_per_sm": out[4],
            "split_at": out[5]}


def flash_decode(q, k, v, lengths, *, k_scale=None, v_scale=None,
                 sm_scale: float | None = None) -> torch.Tensor:
    """Single-query attention over contiguous slot rows: q (B, H, D)
    attends to positions [0, lengths[b]) of k/v (B, H, L, D') (D' = D or
    D // 2 packed int4). Returns (B, H, D) in q's dtype, zeros for a row
    with lengths[b] <= 0. CUDA tensors launch flash_decode_kernel, one
    launch over a grid of (head, row, split slot) blocks
    (dense_decode_splits), with a (B*H, S, D + 2) f32 scratch for the
    splits' states when S > 1."""
    mode = _kv_mode(q, k, v, k_scale, v_scale)
    if not q.is_cuda:
        return torch_decode_attention(q, k, v, lengths, k_scale=k_scale,
                                      v_scale=v_scale, sm_scale=sm_scale)
    if k.dim() != 4:
        raise ValueError(f"k must be (B, H, L, D), got {tuple(k.shape)}")
    B, H, L, _ = k.shape
    D = q.shape[-1]
    if tuple(q.shape) != (B, H, D):
        raise ValueError(f"q shape {tuple(q.shape)} != {(B, H, D)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    _check_kernel_args(dict(q=q, k=k, v=v, k_scale=k_scale,
                            v_scale=v_scale), lengths, "lengths")
    if sm_scale is None:
        sm_scale = D ** -0.5
    S, _ = dense_decode_splits(B, H, L, _sm_count(q.device))
    out = torch.empty_like(q)
    # Each split's (acc[D], m, l), merged by the last split to finish.
    part = (torch.empty(B * H * S * (D + 2), dtype=torch.float32,
                        device=q.device) if S > 1 else None)
    err = _build.library().nsb_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), lengths.data_ptr(), out.data_ptr(), _ptr(part),
        ticket_counters(q.device, B * H).data_ptr(), B, H, D, L, S,
        float(sm_scale), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash decode")
    launches[f"flash_decode/{mode}"] += 1
    return out


def flash_decode_paged(q, k, v, block_table, lengths, *,
                       sm_scale: float | None = None,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-query attention over a BLOCK-PAGED pool: q (B, H, D)
    attends to positions [0, lengths[b]) of row b's chain. Returns
    (B, H, D) in q's dtype, zeros for a row with lengths[b] <= 0. CUDA
    tensors launch paged_decode_kernel, one launch over a grid of
    (head, row, split) blocks (decode_splits), with a (B*H, S, D + 2) f32
    scratch for the splits' states when S > 1."""
    mode = _kv_mode(q, k, v, k_scale, v_scale)
    if not q.is_cuda:
        return torch_decode_attention_paged(q, k, v, block_table, lengths,
                                            sm_scale=sm_scale,
                                            k_scale=k_scale, v_scale=v_scale)
    if k.dim() != 4:
        raise ValueError(f"k must be (num_blocks, H, page, D), got "
                         f"{tuple(k.shape)}")
    N, H, page, _ = k.shape
    B, D = q.shape[0], q.shape[-1]
    if tuple(q.shape) != (B, H, D):
        raise ValueError(f"q shape {tuple(q.shape)} != {(B, H, D)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table shape {tuple(block_table.shape)} != "
                         f"({B}, max_blocks)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    _check_kernel_args(dict(q=q, k=k, v=v, k_scale=k_scale,
                            v_scale=v_scale, block_table=block_table),
                       lengths, "lengths")
    if sm_scale is None:
        sm_scale = D ** -0.5
    nb = block_table.shape[1]
    S, Ls = decode_splits(B, H, nb, page, _sm_count(q.device))
    out = torch.empty_like(q)
    # Each split's (acc[D], m, l), merged by the last split to finish.
    part = (torch.empty(B * H * S * (D + 2), dtype=torch.float32,
                        device=q.device) if S > 1 else None)
    err = _build.library().nsb_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(part),
        ticket_counters(q.device, B * H).data_ptr(), B, H, D, N, page, nb,
        S, Ls, float(sm_scale), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged decode")
    launches[f"flash_decode_paged/{mode}"] += 1
    return out


def flash_prefill_paged(q, k, v, block_table, start, *,
                        sm_scale: float | None = None,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """Multi-query causal attention over a BLOCK-PAGED pool: q
    (B, H, T, D) holds row b's queries at positions start[b] ..
    start[b]+T-1, and the pool must already hold their K/V. Returns
    (B, H, T, D) in q's dtype. CUDA tensors launch paged_prefill_mma_kernel
    (a bf16 query over a bf16, int8 or int4 pool, on the tensor cores) or
    paged_prefill_f32_kernel (an fp32 query, or an fp32 pool, on CUDA
    cores in f32)."""
    mode = _kv_mode(q, k, v, k_scale, v_scale)
    if not q.is_cuda:
        return torch_prefill_attention_paged(q, k, v, block_table, start,
                                             sm_scale=sm_scale,
                                             k_scale=k_scale,
                                             v_scale=v_scale)
    if k.dim() != 4 or q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, D) and k (num_blocks, H, "
                         f"page, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    N, H, page, _ = k.shape
    B, _, T, D = q.shape
    if tuple(q.shape) != (B, H, T, D):
        raise ValueError(f"q shape {tuple(q.shape)} != {(B, H, T, D)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table shape {tuple(block_table.shape)} != "
                         f"({B}, max_blocks)")
    if tuple(start.shape) != (B,):
        raise ValueError(f"start shape {tuple(start.shape)} != ({B},)")
    _check_kernel_args(dict(q=q, k=k, v=v, k_scale=k_scale,
                            v_scale=v_scale, block_table=block_table),
                       start, "start")
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    err = _build.library().nsb_paged_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_table.data_ptr(), start.data_ptr(),
        out.data_ptr(), B, H, T, D, N, page, block_table.shape[1],
        float(sm_scale), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged prefill")
    launches[f"flash_prefill_paged/{mode}"] += 1
    return out
