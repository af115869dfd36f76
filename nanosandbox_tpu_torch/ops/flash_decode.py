"""Paged attention over the serve engine's block-paged KV pool.

The counterpart of the paged half of nanosandbox_tpu/ops/flash_decode.py:

  flash_decode_paged   (T = 1)  <- _paged_decode_kernel
  flash_prefill_paged  (T > 1)  <- _paged_prefill_kernel

Each wrapper takes the JAX function's layouts: q (B, H, D) or
(B, H, T, D); k/v (num_blocks, H, page, D) in float32 or bfloat16;
block_table (B, max_blocks) int32 whose entries >= num_blocks are the
engine's "no block" sentinel; lengths / start (B,) int32. Both return
q's dtype, with f32 scores and accumulation.

Routing: a CUDA tensor goes to the hand-written kernel
(csrc/paged_attention.cu, built at first use by ops/_build.py) or the
wrapper raises; a CPU tensor goes to the plain PyTorch version beside
it. There is no probe and no fallback between the two. ``launches``
counts kernel launches per wrapper, so a run can show that its main
path went through the kernels; ``plain_cuda_calls`` counts plain-version
calls on CUDA tensors (a comparison harness makes those on purpose; the
serving path never does).

Quantized pools (int8 / packed int4 with per-position scales) are not
ported yet: passing scales raises NotImplementedError.
"""

from __future__ import annotations

import torch

from nanosandbox_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["flash_decode_paged", "flash_prefill_paged",
           "torch_decode_attention_paged", "torch_prefill_attention_paged",
           "launches", "plain_cuda_calls", "reset_counts"]

launches = {"flash_decode_paged": 0, "flash_prefill_paged": 0}
plain_cuda_calls = {"torch_decode_attention_paged": 0,
                    "torch_prefill_attention_paged": 0}


def reset_counts() -> None:
    for d in (launches, plain_cuda_calls):
        for key in d:
            d[key] = 0


def _no_scales(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8/int4 KV pools (k_scale/v_scale) are not ported yet")


def _gather_chain(pool: torch.Tensor, block_table: torch.Tensor):
    """(N, H, page, D) pool + (B, nb) table -> (B, H, nb*page, D) f32
    rows. Sentinel entries clamp to block N - 1; their positions lie past
    every frontier and are masked by the callers."""
    N, H, page, D = pool.shape
    B, nb = block_table.shape
    tbl = block_table.clamp(0, N - 1).long()
    return (pool[tbl].float().permute(0, 2, 1, 3, 4)
            .reshape(B, H, nb * page, D))


# ---------------------------------------------------------------------------
# Plain versions: the CPU path, and the reference the kernels are held to
# ---------------------------------------------------------------------------

def torch_decode_attention_paged(q, k, v, block_table, lengths, *,
                                 sm_scale: float | None = None,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-query masked attention over a row's block chain, gathered:
    q (B, H, D) attends to positions [0, lengths[b]). Returns (B, H, D);
    a row with lengths[b] <= 0 attends to nothing and returns zeros."""
    _no_scales(k_scale, v_scale)
    if q.is_cuda:
        plain_cuda_calls["torch_decode_attention_paged"] += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    gk, gv = _gather_chain(k, block_table), _gather_chain(v, block_table)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), gk) * sm_scale
    kpos = torch.arange(gk.shape[2], device=q.device)
    lengths = lengths.to(q.device)
    mask = kpos[None, None, :] < lengths[:, None, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, gv)
    return torch.where((lengths > 0)[:, None, None], out, 0.0).to(q.dtype)


def torch_prefill_attention_paged(q, k, v, block_table, start, *,
                                  sm_scale: float | None = None,
                                  k_scale=None, v_scale=None) -> torch.Tensor:
    """Causal multi-query attention over a row's block chain, gathered:
    query t of row b sits at position start[b] + t and attends to every
    key position <= its own. Returns (B, H, T, D)."""
    _no_scales(k_scale, v_scale)
    if q.is_cuda:
        plain_cuda_calls["torch_prefill_attention_paged"] += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    T = q.shape[2]
    gk, gv = _gather_chain(k, block_table), _gather_chain(v, block_table)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), gk) * sm_scale
    qpos = (start.to(q.device).long()[:, None]
            + torch.arange(T, device=q.device)[None, :])        # (B, T)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = kpos[None, None, None, :] <= qpos[:, None, :, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, gv).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_args(q, k, v, block_table, vec, name: str) -> None:
    """Everything the kernels do not take raises here, before a pointer
    leaves Python."""
    dev = q.device
    for t, what in ((k, "k"), (v, "v"), (block_table, "block_table"),
                    (vec, name)):
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE:
        raise TypeError(f"q/k dtypes {q.dtype}/{k.dtype}: the kernels take "
                        "float32 and bfloat16")
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"v {v.dtype}{tuple(v.shape)} != k "
                         f"{k.dtype}{tuple(k.shape)}")
    if k.dim() != 4:
        raise ValueError(f"k must be (num_blocks, H, page, D), got "
                         f"{tuple(k.shape)}")
    if block_table.dtype != torch.int32 or vec.dtype != torch.int32:
        raise TypeError(f"block_table/{name} must be int32, got "
                        f"{block_table.dtype}/{vec.dtype}")
    D = k.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in the kernels' set {HEAD_DIMS}")
    for t, what in ((q, "q"), (k, "k"), (v, "v"),
                    (block_table, "block_table"), (vec, name)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} is not 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_decode_paged(q, k, v, block_table, lengths, *,
                       sm_scale: float | None = None,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-query attention over a BLOCK-PAGED pool: q (B, H, D)
    attends to positions [0, lengths[b]) of row b's chain. Returns
    (B, H, D) in q's dtype, zeros for a row with lengths[b] <= 0. CUDA
    tensors launch paged_decode_kernel."""
    _no_scales(k_scale, v_scale)
    if not q.is_cuda:
        return torch_decode_attention_paged(q, k, v, block_table, lengths,
                                            sm_scale=sm_scale)
    N, H, page, D = k.shape
    B = q.shape[0]
    if tuple(q.shape) != (B, H, D):
        raise ValueError(f"q shape {tuple(q.shape)} != {(B, H, D)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table shape {tuple(block_table.shape)} != "
                         f"({B}, max_blocks)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    _check_kernel_args(q, k, v, block_table, lengths, "lengths")
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.nsb_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, D, N, page,
        block_table.shape[1], float(sm_scale), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged decode")
    launches["flash_decode_paged"] += 1
    return out


def flash_prefill_paged(q, k, v, block_table, start, *,
                        sm_scale: float | None = None,
                        k_scale=None, v_scale=None) -> torch.Tensor:
    """Multi-query causal attention over a BLOCK-PAGED pool: q
    (B, H, T, D) holds row b's queries at positions start[b] ..
    start[b]+T-1, and the pool must already hold their K/V. Returns
    (B, H, T, D) in q's dtype. CUDA tensors launch paged_prefill_kernel."""
    _no_scales(k_scale, v_scale)
    if not q.is_cuda:
        return torch_prefill_attention_paged(q, k, v, block_table, start,
                                             sm_scale=sm_scale)
    N, H, page, D = k.shape
    B, _, T, _ = q.shape
    if tuple(q.shape) != (B, H, T, D):
        raise ValueError(f"q shape {tuple(q.shape)} != {(B, H, T, D)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table shape {tuple(block_table.shape)} != "
                         f"({B}, max_blocks)")
    if tuple(start.shape) != (B,):
        raise ValueError(f"start shape {tuple(start.shape)} != ({B},)")
    _check_kernel_args(q, k, v, block_table, start, "start")
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.nsb_paged_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), block_table.data_ptr(),
        start.data_ptr(), out.data_ptr(), B, H, T, D, N, page,
        block_table.shape[1], float(sm_scale), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged prefill")
    launches["flash_prefill_paged"] += 1
    return out
