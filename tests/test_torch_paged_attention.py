"""The port's paged attention against the JAX package's paged kernels.

The port's plain versions (torch_decode_attention_paged,
torch_prefill_attention_paged) and the JAX package's Pallas kernels
(flash_decode_paged / flash_prefill_paged, run in interpret mode as
tests/test_flash_decode.py runs them) take the same numpy-seeded fp32
inputs: ragged lengths, prefill starts at 0 and at a page-aligned
prefix hit, and sentinel table entries. Tolerance atol = rtol = 1e-5:
the two differ only in summation order. On CPU tensors the wrappers
route to the plain versions and launch no kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.ops import flash_decode as jfd
from nanosandbox_tpu_torch.ops import flash_decode as tfd


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny models gain nothing from torch's full intra-op thread pool,
    and the suite's other workers run timing-sensitive tests beside
    these; two threads keep this module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pool_and_table(rng, B, H, page, D, nb, N, need):
    """fp32 (N, H, page, D) K/V pools and a (B, nb) table whose row b
    maps its first ceil(need[b] / page) chunks onto distinct blocks; the
    rest are sentinels (N, or past it)."""
    k = rng.normal(size=(N, H, page, D)).astype(np.float32)
    v = rng.normal(size=(N, H, page, D)).astype(np.float32)
    table = np.full((B, nb), N, np.int32)
    blocks = rng.permutation(N)
    used = 0
    for b in range(B):
        n = -(-int(need[b]) // page)
        table[b, :n] = blocks[used:used + n]
        used += n
        table[b, n:] = N + rng.integers(0, 3, size=nb - n)
    return k, v, table


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,H,page,D,nb,N", [
    (3, 2, 8, 32, 5, 16),
    (4, 2, 16, 64, 4, 16),
])
def test_decode_plain_matches_jax_kernel(B, H, page, D, nb, N):
    rng = np.random.default_rng(B * 100 + D)
    lengths = rng.integers(1, nb * page + 1, size=B).astype(np.int32)
    lengths[0] = 1                  # a parked row: first position only
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N, lengths)
    table[0, :] = N                 # ...with an all-sentinel table
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ref = jfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(table),
                                 jnp.asarray(lengths), interpret=True)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lengths)
    out = tfd.torch_decode_attention_paged(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,T,page,D,nb,N,starts", [
    (3, 2, 12, 8, 32, 6, 20, (0, 16, 8)),
    (2, 2, 20, 16, 64, 4, 10, (0, 32)),
])
def test_prefill_plain_matches_jax_kernel(B, H, T, page, D, nb, N, starts):
    rng = np.random.default_rng(T * 10 + D)
    start = np.asarray(starts, np.int32)
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N, start + T)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    ref = jfd.flash_prefill_paged(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(table),
                                  jnp.asarray(start), interpret=True)
    tq, tk, tv, tt, ts = _t(q, k, v, table, start)
    out = tfd.torch_prefill_attention_paged(tq, tk, tv, tt, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_wrappers_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(3)
    B, H, page, D, nb, N = 2, 2, 8, 32, 3, 8
    lengths = np.array([5, 24], np.int32)
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N, lengths)
    q1 = rng.normal(size=(B, H, D)).astype(np.float32)
    qT = rng.normal(size=(B, H, 6, D)).astype(np.float32)
    start = np.array([0, 8], np.int32)
    tq1, tqT, tk, tv, tt, tl, ts = _t(q1, qT, k, v, table, lengths, start)
    tfd.reset_counts()
    dec = tfd.flash_decode_paged(tq1, tk, tv, tt, tl)
    pre = tfd.flash_prefill_paged(tqT, tk, tv, tt, ts)
    assert torch.equal(dec, tfd.torch_decode_attention_paged(tq1, tk, tv,
                                                             tt, tl))
    assert torch.equal(pre, tfd.torch_prefill_attention_paged(tqT, tk, tv,
                                                              tt, ts))
    assert set(tfd.launches) == {
        f"{fn}/{mode}" for fn in ("flash_decode", "flash_decode_paged",
                                  "flash_prefill_paged")
        for mode in ("fp32", "bf16", "int8", "int4")}
    assert not any(tfd.launches.values())
    assert not any(tfd.plain_cuda_calls.values())


def test_bf16_pool_attends_in_f32():
    """A bf16 pool under a bf16 query: the plain version upcasts and
    returns bf16, within bf16 rounding of the fp32 answer."""
    rng = np.random.default_rng(5)
    B, H, page, D, nb, N = 2, 2, 8, 32, 4, 8
    lengths = np.array([7, 30], np.int32)
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N, lengths)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lengths)
    ref = tfd.torch_decode_attention_paged(tq, tk, tv, tt, tl)
    out = tfd.flash_decode_paged(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                                 tt, tl)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def test_decode_rows_without_keys_return_zeros():
    """lengths[b] <= 0: the row attends to nothing and its output is 0
    (the kernel's contract too); the other rows are unchanged."""
    rng = np.random.default_rng(7)
    B, H, page, D, nb, N = 3, 2, 8, 32, 3, 8
    lengths = np.array([0, 13, -2], np.int32)
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N,
                                  np.maximum(lengths, 0))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lengths)
    out = tfd.flash_decode_paged(tq, tk, tv, tt, tl)
    assert torch.equal(out[0], torch.zeros(H, D))
    assert torch.equal(out[2], torch.zeros(H, D))
    one = tfd.torch_decode_attention_paged(tq[1:2], tk, tv, tt[1:2], tl[1:2])
    torch.testing.assert_close(out[1:2], one, atol=1e-5, rtol=1e-5)


def test_quantized_pools_run_plain_on_cpu_and_scale_checks_raise():
    """Quantized pools are ported: an int8 pool with its scales runs on
    the CPU through the plain versions (no launch), equal to the fp32
    pool the scales dequantize to, and scales without an int8/int4 pool
    (or such a pool without scales) raise."""
    rng = np.random.default_rng(9)
    B, H, page, D, nb, N = 2, 2, 8, 32, 3, 8
    lengths = np.array([5, 24], np.int32)
    k, v, table = _pool_and_table(rng, B, H, page, D, nb, N, lengths)
    (kq, ks), (vq, vs) = (tfd.quantize_kv_rows(torch.from_numpy(x))
                          for x in (k, v))
    deq_k, deq_v = kq.float() * ks[..., None], vq.float() * vs[..., None]
    q1 = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    qT = torch.from_numpy(rng.normal(size=(B, H, 6, D)).astype(np.float32))
    tt, tl = _t(table, lengths)
    start = torch.tensor([0, 8], dtype=torch.int32)
    tfd.reset_counts()
    dec = tfd.flash_decode_paged(q1, kq, vq, tt, tl, k_scale=ks, v_scale=vs)
    pre = tfd.flash_prefill_paged(qT, kq, vq, tt, start, k_scale=ks,
                                  v_scale=vs)
    assert not any(tfd.launches.values())
    torch.testing.assert_close(dec, tfd.flash_decode_paged(
        q1, deq_k, deq_v, tt, tl), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pre, tfd.flash_prefill_paged(
        qT, deq_k, deq_v, tt, start), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="non-quantized"):
        tfd.flash_decode_paged(q1, deq_k, deq_v, tt, tl, k_scale=ks,
                               v_scale=vs)
    with pytest.raises(ValueError, match="needs k_scale"):
        tfd.flash_prefill_paged(qT, kq, vq, tt, start)
