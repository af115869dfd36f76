"""The port's dense and quantized decode against the JAX package's.

* quantize_kv_rows / quantize_kv_rows_int4 / unpack_int4: bit-identical
  to the JAX functions (ints and scales), all-zero rows and ``valid=``
  masks included.
* K3's plain version (torch_decode_attention) against the JAX Pallas
  kernel flash_decode in interpret mode, fp32 and bf16 pools within
  atol = rtol = 1e-5 and int8/int4 within 5e-5 (tests/test_flash_decode.py's
  own limit for the quantized kernels), over frontiers that include 1, L,
  lengths off the 32-row quantum, and 0, 63, 64, 65, L - 1 and L at an L
  that is neither a multiple of 64 nor of 4; and the dense decode
  kernel's split rule (dense_decode_splits), as the paged one's.
* The quantized paged plain versions against flash_decode_paged /
  flash_prefill_paged in interpret mode (5e-5), with sentinel table
  entries and a nonzero prefill start.
* init_cache / init_paged_cache in every kv mode and scatter_cache_rows
  against JAX's (ints equal, the other rows untouched); the model's
  per-row decode into an int8 dense cache against JAX's; the
  scalar-index-0 prefill into a dense cache equal to the no-cache
  forward. (The quantized paged model path is held to the JAX Engine's
  tokens in tests/test_torch_engine.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models import gpt as jgpt
from nanosandbox_tpu.ops import flash_decode as jfd
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models import gpt as tgpt
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.ops import flash_decode as tfd

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
QTOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny models gain nothing from torch's full intra-op thread pool,
    and the suite's other workers run timing-sensitive tests beside
    these; two threads keep this module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rows(rng, shape):
    """Normal rows at mixed magnitudes, with some all-zero rows."""
    x = (rng.normal(size=shape) * rng.uniform(0.1, 4.0, shape[:-1] + (1,))
         ).astype(np.float32)
    x[(rng.random(shape[:-1]) < 0.1)] = 0.0
    return x


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_quantizers_bit_identical_to_jax(bits, masked):
    rng = np.random.default_rng(bits * 10 + masked)
    x = _rows(rng, (3, 2, 17, 32))
    valid = rng.random((3, 1, 17)) < 0.7 if masked else None
    jq = jfd.quantize_kv_rows if bits == 8 else jfd.quantize_kv_rows_int4
    tq = tfd.quantize_kv_rows if bits == 8 else tfd.quantize_kv_rows_int4
    jv, js = jq(jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    tv, ts = tq(torch.from_numpy(x),
                None if valid is None else torch.from_numpy(valid))
    assert tv.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if bits == 4:
        np.testing.assert_array_equal(tfd.unpack_int4(tv).numpy(),
                                      np.asarray(jfd.unpack_int4(jv)))
    ints = tv if bits == 8 else tfd.unpack_int4(tv)
    zero = np.all(x == 0, axis=-1)
    assert zero.any() and not ints.numpy()[zero].any()


def test_bf16_rows_quantize_like_jax():
    rng = np.random.default_rng(9)
    x = _rows(rng, (2, 2, 8, 64))
    xb = torch.from_numpy(x).bfloat16()
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    for jq, tq in ((jfd.quantize_kv_rows, tfd.quantize_kv_rows),
                   (jfd.quantize_kv_rows_int4, tfd.quantize_kv_rows_int4)):
        jv, js = jq(jx)
        tv, ts = tq(xb)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------- K3 plain version

def _quantized(mode, k, v):
    """(k, v, k_scale, v_scale) numpy pools of a mode from fp32 k, v (a
    bf16 pool as its values, rounded, in f32)."""
    if mode == "fp32":
        return k, v, None, None
    if mode == "bf16":
        return _bf16(k), _bf16(v), None, None
    q = jfd.quantize_kv_rows if mode == "int8" else jfd.quantize_kv_rows_int4
    (kq, ks), (vq, vs) = q(jnp.asarray(k)), q(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("B,H,L,D", [(5, 2, 80, 32), (3, 2, 64, 64),
                                     (6, 2, 131, 64)])
def test_decode_plain_matches_jax_kernel(mode, B, H, L, D):
    """K3's plain version (what chip_smoke's phase 3 holds the kernel to)
    against JAX's flash_decode in interpret mode, under an fp32 query in
    every kv mode (a bf16 pool's values exact in f32, as JAX's dot dtype
    promotes them): at frontiers of 1 and L, off the 32-row quantum, and
    at L 131 (neither a multiple of 64 nor of 4) on and around the kernel's
    64-position chunk and split edges, 63, 64, 65, L - 1, L and 0. JAX's
    kernel divides by zero on a row without keys, so the 0 row is held to
    zeros instead."""
    rng = np.random.default_rng(L + D)
    lengths = np.asarray(([1, L, 37, 33, 5] if L < 131 else
                          [63, 64, 65, L - 1, L, 0])[:B], np.int32)
    k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
            for _ in range(2))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v, ks, vs = _quantized(mode, k, v)
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs))
    jk, jv = (jnp.asarray(x, jnp.bfloat16 if mode == "bf16" else None)
              for x in (k, v))
    ref = np.asarray(jfd.flash_decode(jnp.asarray(q), jk, jv,
                                      jnp.asarray(lengths), interpret=True,
                                      **scales))
    tsc = {} if ks is None else dict(zip(("k_scale", "v_scale"),
                                         _t(ks, vs)))
    tq, tk, tv, tl = _t(q, k, v, lengths)
    if mode == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    tfd.reset_counts()
    out = tfd.flash_decode(tq, tk, tv, tl, **tsc)
    tol = 1e-5 if mode in ("fp32", "bf16") else QTOL
    keys = lengths > 0
    np.testing.assert_allclose(out.numpy()[keys], ref[keys], atol=tol,
                               rtol=tol)
    assert not out[torch.from_numpy(~keys)].any()
    assert not any(tfd.launches.values())
    assert torch.equal(out, tfd.torch_decode_attention(tq, tk, tv, tl,
                                                       **tsc))


def test_decode_rows_without_keys_return_zeros():
    rng = np.random.default_rng(2)
    k, v = (torch.from_numpy(rng.normal(size=(3, 2, 16, 32))
                             .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(3, 2, 32)).astype(np.float32))
    out = tfd.flash_decode(q, k, v, torch.tensor([0, 7, -1],
                                                 dtype=torch.int32))
    assert not out[0].any() and not out[2].any() and out[1].abs().sum() > 0


# ----------------------------------------------- quantized paged versions

def _paged(rng, mode, B, H, page, D, nb, N, need):
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
    return (*_quantized(mode, k, v), table)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_paged_decode_quantized_plain_matches_jax_kernel(mode):
    rng = np.random.default_rng(21)
    B, H, page, D, nb, N = 4, 2, 16, 64, 4, 16
    lengths = np.asarray([1, 64, 23, 40], np.int32)
    k, v, ks, vs, table = _paged(rng, mode, B, H, page, D, nb, N, lengths)
    table[0, :] = N                      # a parked row's all-sentinel table
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ref = jfd.flash_decode_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    tq, tk, tv, tt, tl, tks, tvs = _t(q, k, v, table, lengths, ks, vs)
    out = tfd.flash_decode_paged(tq, tk, tv, tt, tl, k_scale=tks,
                                 v_scale=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=QTOL,
                               rtol=QTOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_paged_prefill_quantized_plain_matches_jax_kernel(mode):
    rng = np.random.default_rng(22)
    B, H, T, page, D, nb, N = 2, 2, 12, 8, 32, 6, 20
    start = np.asarray([0, 24], np.int32)
    k, v, ks, vs, table = _paged(rng, mode, B, H, page, D, nb, N, start + T)
    q = rng.normal(size=(B, H, T, D)).astype(np.float32)
    ref = jfd.flash_prefill_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(start), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    tq, tk, tv, tt, ts, tks, tvs = _t(q, k, v, table, start, ks, vs)
    out = tfd.flash_prefill_paged(tq, tk, tv, tt, ts, k_scale=tks,
                                  v_scale=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=QTOL,
                               rtol=QTOL)


@pytest.mark.parametrize("mode,D", [("bf16", 64), ("bf16", 128),
                                    ("int8", 32), ("int8", 64),
                                    ("int4", 64), ("int4", 128)])
def test_paged_prefill_bf16_plain_matches_jax_kernel(mode, D):
    """A bf16 query over a bf16, int8 or int4 pool: the plain version (the
    yardstick the tensor-core kernel is held to on the card) against JAX's
    kernel in interpret mode, at a start off the page grid, a ragged last
    page and sentinel table entries, within 2e-2 (bf16 outputs, compared
    in f32; both round p to bf16 before p.v)."""
    rng = np.random.default_rng(23 + D)
    B, H, T, page, nb, N = 2, 2, 100, 8, 19, 40
    start = np.asarray([0, 37], np.int32)
    k, v, ks, vs, table = _paged(rng, "fp32", B, H, page, D, nb, N,
                                 start + T)
    if mode == "bf16":
        k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (k, v))
    else:
        k, v, ks, vs = _quantized(mode, k, v)
    q = np.asarray(jnp.asarray(rng.normal(size=(B, H, T, D)), jnp.bfloat16))
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs))
    ref = jfd.flash_prefill_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(start), interpret=True, **scales)
    tsc = {} if ks is None else dict(zip(("k_scale", "v_scale"),
                                         _t(ks, vs)))
    tq, tt, ts = _t(q.astype(np.float32), table, start)
    tk, tv = ((torch.from_numpy(x.astype(np.float32)).bfloat16()
               if mode == "bf16" else torch.from_numpy(np.array(x)))
              for x in (k, v))
    out = tfd.flash_prefill_paged(tq.bfloat16(), tk, tv, tt, ts, **tsc)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               atol=2e-2, rtol=0)


def _bf16(x):
    """x rounded to bf16, kept as an f32 numpy array."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_decode_bf16_plain_matches_jax_kernel(mode, paged):
    """A bf16 query over a bf16, int8 or int4 pool, dense (K3) and paged
    (K2): the plain version against JAX's kernel in interpret mode within
    2e-2 (bf16 outputs, compared in f32; both round p, or p * v_scale, to
    bf16 before p.v), over frontiers of 1, a full row and one off the
    page grid, sentinel table entries included."""
    rng = np.random.default_rng(31 + 2 * paged + len(mode))
    B, H, D, page, nb, N, L = 3, 2, 64, 16, 5, 16, 80
    lengths = np.asarray([1, L, 37], np.int32)
    if paged:
        k, v, ks, vs, table = _paged(rng, "fp32", B, H, page, D, nb, N,
                                     lengths)
    else:
        k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
                for _ in range(2))
        ks = vs = table = None
    if mode == "bf16":
        k, v = _bf16(k), _bf16(v)
        jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (k, v))
        tk, tv = (torch.from_numpy(x).bfloat16() for x in (k, v))
    else:
        k, v, ks, vs = _quantized(mode, k, v)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = _t(k, v)
    q = _bf16(rng.normal(size=(B, H, D)))
    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                        v_scale=jnp.asarray(vs))
    tsc = {} if ks is None else dict(zip(("k_scale", "v_scale"),
                                         _t(ks, vs)))
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    if paged:
        ref = jfd.flash_decode_paged(jq, jk, jv, jnp.asarray(table),
                                     jnp.asarray(lengths), interpret=True,
                                     **scales)
        out = tfd.flash_decode_paged(tq, tk, tv, *_t(table, lengths), **tsc)
    else:
        ref = jfd.flash_decode(jq, jk, jv, jnp.asarray(lengths),
                               interpret=True, **scales)
        out = tfd.flash_decode(tq, tk, tv, *_t(lengths), **tsc)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_bf16_query_rounds_p_to_bf16(mode):
    """The bf16-query plain decode is _attend with p (p * v_scale) rounded
    to bf16, bit for bit, and that rounding shows: keeping p in f32 gives
    another result on the same seeded inputs. An fp32 query keeps f32."""
    rng = np.random.default_rng(41)
    B, H, L, D = 2, 2, 48, 32
    lengths = torch.tensor([48, 29], dtype=torch.int32)
    k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
            for _ in range(2))
    if mode == "bf16":
        tk, tv = (torch.from_numpy(x).bfloat16() for x in (k, v))
        tks = tvs = None
    else:
        tk, tv, tks, tvs = _t(*_quantized(mode, k, v))
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    kpos = torch.arange(L)
    mask = (kpos[None, :] < lengths[:, None])[:, None, None, :]

    def attend(qq, p_dtype):
        return tfd._attend(qq[:, :, None], tfd._values(tk), tfd._values(tv),
                           mask, tks, tvs, D ** -0.5,
                           p_dtype)[:, :, 0].to(qq.dtype)

    got = tfd.torch_decode_attention(q.bfloat16(), tk, tv, lengths,
                                     k_scale=tks, v_scale=tvs)
    assert torch.equal(got, attend(q.bfloat16(), torch.bfloat16))
    assert not torch.equal(got, attend(q.bfloat16(), torch.float32))
    got32 = tfd.torch_decode_attention(q, tk, tv, lengths, k_scale=tks,
                                       v_scale=tvs)
    assert torch.equal(got32, attend(q, torch.float32))


def test_scale_checks_raise():
    q = torch.zeros(1, 1, 32)
    k8 = torch.zeros(2, 1, 8, 32, dtype=torch.int8)
    kf = torch.zeros(2, 1, 8, 32)
    s = torch.ones(2, 1, 8)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs k_scale"):
        tfd.flash_decode_paged(q, k8, k8, tbl, n)
    with pytest.raises(ValueError, match="non-quantized"):
        tfd.flash_decode_paged(q, kf, kf, tbl, n, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="together"):
        tfd.flash_prefill_paged(q[:, :, None], k8, k8, tbl, n - 1,
                                k_scale=s)
    with pytest.raises(ValueError, match="shape"):
        tfd.flash_decode(q, k8, k8, n, k_scale=s[:, :, :4],
                         v_scale=s[:, :, :4])
    with pytest.raises(TypeError, match="float32"):
        tfd.flash_decode(q, k8, k8, n, k_scale=s.double(),
                         v_scale=s.double())
    k4 = torch.zeros(2, 1, 8, 32, dtype=torch.uint8)      # logical D = 64
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode(q, k4, k4, n, k_scale=s, v_scale=s)
    with pytest.raises(TypeError, match="queries"):
        tfd.flash_decode(q.to(torch.int8), k8, k8, n, k_scale=s,
                         v_scale=s)


def test_paged_decode_split_rule():
    """The paged decode kernel's host-side split rule: S splits of Ls
    positions, Ls a whole number of pages, cover every position of the
    chain exactly once; B*H*S reaches SPLIT_BLOCKS_PER_SM blocks an SM
    wherever the chain has pages enough; the kernel's page division and
    page list stay in range; and the rule takes no lengths."""
    import inspect

    assert list(inspect.signature(tfd.decode_splits).parameters) == [
        "B", "H", "nb", "page", "sms"]
    for B in (1, 2, 3, 8, 16, 64):
        for H in (1, 4, 12, 25):
            for nb in (0, 1, 2, 5, 7, 16, 64, 300, 1000):
                for page in (1, 3, 16, 64, 4096):
                    for sms in (1, 7, 132):
                        S, Ls = tfd.decode_splits(B, H, nb, page, sms)
                        cap = nb * page
                        assert S >= 1 and Ls >= page and Ls % page == 0
                        assert Ls // page <= tfd.MAX_SPLIT_PAGES
                        assert Ls * page < 2 ** 31
                        # [s Ls, min((s+1) Ls, cap)) partition [0, cap).
                        assert S * Ls >= cap and (S - 1) * Ls < max(cap, 1)
                        if B * H * nb >= tfd.SPLIT_BLOCKS_PER_SM * sms:
                            assert B * H * S >= tfd.SPLIT_BLOCKS_PER_SM * sms
                        if cap <= 2000:
                            seen = [p for s in range(S)
                                    for p in range(s * Ls,
                                                   min((s + 1) * Ls, cap))]
                            assert seen == list(range(cap))
    # The serving shape on 132 SMs: 8 slots x 12 heads, 64 pages of 16.
    assert tfd.decode_splits(8, 12, 64, 16, 132) == (3, 352)
    with pytest.raises(ValueError, match="page"):
        tfd.decode_splits(1, 1, 4, 1 << 16, 132)


def test_dense_decode_split_rule():
    """The dense decode kernel's host-side split rule: its grid's S slots
    of Ls positions, Ls a whole number of 64-position chunks, cover every
    position of a row [0, L) exactly once, L a multiple of 64 or not;
    B*H*S reaches SPLIT_BLOCKS_PER_SM blocks an SM wherever the row has
    chunks enough; and the rule takes no lengths (the kernel fits each
    row's splits to its length at run time)."""
    import inspect

    assert list(inspect.signature(tfd.dense_decode_splits).parameters) == [
        "B", "H", "L", "sms"]
    C = tfd.DENSE_CHUNK
    for B in (1, 2, 3, 8, 16):
        for H in (1, 4, 12, 25):
            for L in (1, 63, 64, 65, 131, 512, 1000, 1001, 1024, 4200,
                      20000):
                for sms in (1, 7, 132):
                    S, Ls = tfd.dense_decode_splits(B, H, L, sms)
                    assert S >= 1 and Ls >= C and Ls % C == 0
                    assert S * Ls >= L and (S - 1) * Ls < L
                    if B * H * -(-L // C) >= tfd.SPLIT_BLOCKS_PER_SM * sms:
                        assert B * H * S >= tfd.SPLIT_BLOCKS_PER_SM * sms
                    if L <= 5000:
                        seen = [p for s in range(S)
                                for p in range(s * Ls, min((s + 1) * Ls, L))]
                        assert seen == list(range(L))
    # K3's timed shapes on 132 SMs (H 12): phase 3's (B 8, L 1024), the
    # dense server's steady state (8 x 512) and the sampler's (1 x 1024).
    assert tfd.dense_decode_splits(8, 12, 1024, 132) == (3, 384)
    assert tfd.dense_decode_splits(8, 12, 512, 132) == (3, 192)
    assert tfd.dense_decode_splits(1, 12, 1024, 132) == (16, 64)
    with pytest.raises(ValueError, match="L"):
        tfd.dense_decode_splits(1, 1, 0, 132)


# ------------------------------------------------------ caches and model

@pytest.fixture(scope="module")
def twin():
    jcfg = JaxGPTConfig(**DIMS, compute_dtype="float32",
                        attention_impl="xla", decode_impl="pallas_interpret")
    jmodel = jgpt.GPT(jcfg)
    # Compiled: the op-by-op init takes four times as long on the CPU.
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    model = tgpt.GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jcfg, jmodel, params, cfg, model.eval()


@pytest.mark.parametrize("kvd", [None, "bf16", "int8", "int4"])
def test_cache_layouts_match_jax(twin, kvd):
    jcfg, _, _, cfg, _ = twin
    for jax_fn, torch_fn, lead in (
            (lambda: jgpt.init_cache(jcfg, 3, 16, kv_dtype=kvd),
             lambda: tgpt.init_cache(cfg, 3, 16, kv_dtype=kvd), 0),
            (lambda: jgpt.init_paged_cache(jcfg, 5, 8, kv_dtype=kvd),
             lambda: tgpt.init_paged_cache(cfg, 5, 8, kv_dtype=kvd), 1)):
        jl, tl = jax_fn()[0], torch_fn()[0]
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            # The port's paged pool carries one extra (drop) block.
            assert b.shape == (b.shape[0],) + tuple(a.shape[1:])
            assert b.shape[0] == a.shape[0] + lead
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")


@pytest.mark.parametrize("kvd", ["fp32", "int8", "int4"])
def test_scatter_cache_rows_matches_jax(twin, kvd):
    jcfg, _, _, cfg, _ = twin
    rng = np.random.default_rng(5)
    ck, cv = (_rows(rng, (3, 2, 16, 32)) for _ in range(2))
    jpool = jgpt.init_cache(jcfg, 4, 32, kv_dtype=kvd)
    jout = jgpt.scatter_cache_rows(
        jpool, [(jnp.asarray(ck), jnp.asarray(cv))] * 2,
        jnp.asarray([2, 0, 4], jnp.int32))    # slot 4: JAX's padding row
    tpool = tgpt.init_cache(cfg, 4, 32, kv_dtype=kvd)
    tgpt.scatter_cache_rows(
        tpool, [(torch.from_numpy(ck[:2]), torch.from_numpy(cv[:2]))] * 2,
        torch.tensor([2, 0]))
    for jl, tl in zip(jout, tpool):
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b[2].any() and not b[1].any() and not b[3].any()


def test_scatter_refuses_quantized_rows_into_fp_pool(twin):
    """scatter_cache_rows takes full-precision rows only, into any pool."""
    cfg = twin[3]
    rows = tgpt.init_cache(cfg, 1, 8, kv_dtype="int8")
    for pool_kvd in (None, "int8"):
        with pytest.raises(ValueError, match="full-precision"):
            tgpt.scatter_cache_rows(
                tgpt.init_cache(cfg, 2, 8, kv_dtype=pool_kvd), rows,
                torch.tensor([0]))


def test_scalar_index_prefill_equals_no_cache_forward(twin):
    """Prefill into a fresh dense cache at scalar index 0 is causal
    attention over the call's own keys, so its logits equal the no-cache
    forward; the cache then holds the call's K/V and feeds the sampler's
    scalar-index decode steps (K3's plain version), which match a full
    recompute."""
    *_, cfg, model = twin
    seq = torch.from_numpy(np.random.default_rng(7).integers(0, 65, (2, 20)))
    cache = tgpt.init_cache(cfg, 2, 24)
    with torch.no_grad():
        cached = model(seq[:, :17], cache=cache, cache_index=0)
        assert torch.equal(cached, model(seq[:, :17]))
        assert cache[0][0][:, :, :17].abs().sum() > 0
        assert not cache[0][0][:, :, 17:].any()
        for p in range(17, 20):
            step = model(seq[:, p:p + 1], cache=cache, cache_index=p)[:, 0]
            full = model(seq[:, :p + 1])[:, -1]
            np.testing.assert_allclose(step.numpy(), full.numpy(),
                                       atol=1e-4)


def test_dense_per_row_decode_matches_jax(twin):
    """The dense engine's decode step: per-row frontiers into an int8
    dense cache, against JAX's per-row path (flash_decode interpret)."""
    jcfg, jmodel, params, cfg, model = twin
    rng = np.random.default_rng(8)
    rows = [(_rows(rng, (2, 2, 10, 32)), _rows(rng, (2, 2, 10, 32)))
            for _ in range(cfg.n_layer)]
    jpool = jgpt.scatter_cache_rows(
        jgpt.init_cache(jcfg, 2, 32, kv_dtype="int8"),
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in rows],
        jnp.asarray([0, 1], jnp.int32))
    tpool = tgpt.init_cache(cfg, 2, 32, kv_dtype="int8")
    tgpt.scatter_cache_rows(tpool, [tuple(_t(a, b)) for a, b in rows],
                            torch.tensor([0, 1]))
    pos = np.asarray([6, 10], np.int32)
    tok = rng.integers(0, 65, (2, 1))
    # Compiled: the same function as the op-by-op apply, in a fraction of
    # its time on the CPU.
    jl, _ = jax.jit(lambda p, t, c, i: jmodel.apply(
        {"params": p}, t, cache=c, cache_index=i))(
        params, jnp.asarray(tok, jnp.int32), jpool, jnp.asarray(pos))
    with torch.no_grad():
        tl = model(torch.from_numpy(tok), cache=tpool,
                   cache_index=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_unported_dense_calls_raise(twin):
    *_, cfg, model = twin
    cache = tgpt.init_cache(cfg, 1, 16)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="not ported yet"):
        model(torch.zeros(1, 3, dtype=torch.int64), cache=cache,
              cache_index=4)
