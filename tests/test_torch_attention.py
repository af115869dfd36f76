"""The port's training attention against the JAX package's flash kernels.

Plain versions only: on the CPU the wrappers of
nanosandbox_tpu_torch/ops/attention.py route to torch_flash_attention
and torch_flash_attention_bwd, which chip_smoke.py holds the CUDA
kernels to on the card. The JAX side runs its Pallas kernels in
interpret mode, as its own tests do. Inputs are numpy-seeded, fp32, at
B 2, H 2, T <= 128, D 32 (tests/conftest.py tiny_cfg's head size).
Tolerances: 2e-5 on o and lse, 2e-4 on gradients (f32 sums in another
order; the JAX kernels pad D to 128 and T to the block); the non-causal
cases (ring attention's blocks) at phase 7's fp32 limits, 1e-5 and 1e-4,
which the ring's fp32 kernels are held to on the card. One test feeds
both sides bf16 inputs at D 64, T up to 200, the yardstick of the bf16
tensor-core kernels, within phase 7's 2e-2.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.ops import attention as jattn
from nanosandbox_tpu_torch.ops import attention as tattn

B, H, D = 2, 2, 32
TOL_O, TOL_G = 2e-5, 2e-4
RING_O, RING_G = 1e-5, 1e-4  # chip_smoke.TRAIN_TOL's fp32 limits


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D), dtype=np.float32)
            for _ in range(4)]                      # q, k, v, dO


def _torch_grads(fn, q, k, v, do):
    """(o, lse or None, dq, dk, dv) of a torch function of (q, k, v)."""
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt)
    o, lse = out if isinstance(out, tuple) else (out, None)
    o.backward(torch.from_numpy(do))
    return (o.detach().numpy(), None if lse is None else lse.detach().numpy(),
            qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy())


def _jax_grads(fn, q, k, v, do):
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(o), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


@pytest.mark.parametrize("T,causal", [
    pytest.param(128, True, id="128"), pytest.param(96, True, id="96"),
    # The JAX kernels' non-causal path takes whole blocks only.
    pytest.param(128, False, id="128-non_causal")])
def test_plain_flash_attention_matches_jax(T, causal):
    """The plain forward (o, lse) and its autograd gradients against JAX's
    flash attention, causal or not (ring attention's blocks)."""
    tol_o, tol_g = (TOL_O, TOL_G) if causal else (RING_O, RING_G)
    q, k, v, do = _inputs(T)
    jo, jlse = jattn.flash_attention_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal, None, True)
    _, *jg = _jax_grads(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, None, True), q, k, v, do)
    o, lse, *g = _torch_grads(lambda q, k, v: tattn.torch_flash_attention(
        q, k, v, causal=causal), q, k, v, do)
    np.testing.assert_allclose(o, np.asarray(jo), atol=tol_o)
    np.testing.assert_allclose(lse, np.asarray(jlse), atol=tol_o)
    for got, ref in zip(g, jg):
        np.testing.assert_allclose(got, ref, atol=tol_g)


@pytest.mark.parametrize("impl,causal,with_dlse", [
    pytest.param("fused", True, False, id="fused"),
    pytest.param("split", True, False, id="split"),
    pytest.param("fused", False, False, id="fused-non_causal"),
    pytest.param("split", False, False, id="split-non_causal"),
    pytest.param("fused", False, True, id="fused-non_causal-dlse"),
    pytest.param("split", False, True, id="split-non_causal-dlse"),
    pytest.param("split", True, True, id="split-dlse")])
def test_backward_from_o_and_lse_matches_jax(impl, causal, with_dlse,
                                             monkeypatch):
    """flash_attention_bwd on CPU tensors (the plain version of K5 / K6+K7)
    from the forward's o and lse, causal or not (ring attention's
    off-diagonal blocks), given a seeded lse cotangent or none, gives the
    gradients of JAX's backward under the same strategy (BWD_IMPL, its
    Pallas kernels in interpret mode)."""
    monkeypatch.setattr(tattn, "BWD_IMPL", impl)
    monkeypatch.setattr(jattn, "BWD_IMPL", impl)
    q, k, v, do = _inputs(128, seed=1)
    dlse = (0.1 * np.random.default_rng(7).standard_normal(
        (B, H, 128), dtype=np.float32) if with_dlse else None)
    if with_dlse:
        _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention_lse(
            q, k, v, causal, None, True), *(jnp.asarray(x) for x in (q, k, v)))
        jg = [np.asarray(g) for g in vjp((jnp.asarray(do),
                                          jnp.asarray(dlse)))]
    else:
        _, *jg = _jax_grads(lambda q, k, v: jattn.flash_attention(
            q, k, v, causal, None, True), q, k, v, do)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    kw = dict(causal=causal,
              dlse=None if dlse is None else torch.from_numpy(dlse))
    o, lse = tattn.flash_attention_fwd(qt, kt, vt, causal=causal)
    got = tattn.flash_attention_bwd(qt, kt, vt, o, lse, dot, **kw)
    for g, ref in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=TOL_G if causal else RING_G)
    dq = tattn.flash_attention_bwd_dq(qt, kt, vt, o, lse, dot, **kw)
    dk, dv = tattn.flash_attention_bwd_dkv(qt, kt, vt, o, lse, dot, **kw)
    for g, ref in zip((dq, dk, dv), got):
        np.testing.assert_array_equal(g.numpy(), ref.numpy())
    assert not any(tattn.launches.values())   # CPU: no kernel launched


@pytest.mark.parametrize("T", [96, 128])
def test_hash_dropout_keep_mask_is_bit_exact(T):
    for seed in ([7], [0xFFFFFFF0, 3, 1, 2**31 + 5, 17]):
        for offs in (dict(), dict(q_off=4, k_off=9, b_off=1, h_off=2,
                                  hash_heads=5)):
            ref = np.asarray(jattn.hash_dropout_keep_mask(
                jnp.asarray(seed, jnp.uint32), B, H, T, T, rate=0.1, **offs))
            got = tattn.hash_dropout_keep_mask(seed, B, H, T, T, rate=0.1,
                                               **offs).numpy()
            np.testing.assert_array_equal(got, ref)
            assert 0.85 < got.mean() < 0.95


@pytest.mark.parametrize("T,seed", [(128, [5]), (96, [11, 0, 0, 3, 40])])
def test_flash_attention_dropout_matches_jax(T, seed):
    q, k, v, do = _inputs(T, seed=2)
    rate = 0.2
    jseed = jnp.asarray(seed, jnp.uint32)
    jo, *jg = _jax_grads(lambda q, k, v: jattn.flash_attention_dropout(
        q, k, v, jseed, True, None, rate, True), q, k, v, do)
    o, _, *g = _torch_grads(lambda q, k, v: tattn.flash_attention_dropout(
        q, k, v, seed, dropout_rate=rate), q, k, v, do)
    np.testing.assert_allclose(o, jo, atol=TOL_O)
    for got, ref in zip(g, jg):
        np.testing.assert_allclose(got, ref, atol=TOL_G)
    # The autograd.Function the CUDA path uses, wired here to the plain
    # versions its kernel entry points take for CPU tensors.
    words = tattn.seed_words(seed)
    o, _, *g = _torch_grads(lambda q, k, v: tattn.FlashAttention.apply(
        q, k, v, words, True, None, rate, None)[0], q, k, v, do)
    np.testing.assert_allclose(o, jo, atol=TOL_O)
    for got, ref in zip(g, jg):
        np.testing.assert_allclose(got, ref, atol=TOL_G)
    # The explicit backward from (o, lse) drops the same elements.
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o2, lse = tattn.flash_attention_fwd(qt, kt, vt, dropout_rate=rate,
                                        seed=seed)
    got = tattn.flash_attention_bwd(qt, kt, vt, o2, lse, dot,
                                    dropout_rate=rate, seed=seed)
    for g2, ref in zip(got, jg):
        np.testing.assert_allclose(g2.numpy(), ref, atol=TOL_G)


def test_causal_attention_routing_and_seeds(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(64, seed=3))
    base = tattn.causal_attention(q, k, v)
    # Dropout needs a seed: without one the model's call is deterministic,
    # the explicit dropout entry point refuses.
    assert torch.equal(tattn.causal_attention(q, k, v, dropout_rate=0.1),
                       base)
    with pytest.raises(ValueError, match="per-step seed"):
        tattn.flash_attention_dropout(q, k, v, None, dropout_rate=0.1)
    a = tattn.causal_attention(q, k, v, dropout_rate=0.1, seed=3)
    assert torch.equal(a, tattn.causal_attention(q, k, v, dropout_rate=0.1,
                                                 seed=torch.tensor([3])))
    assert not torch.equal(a, base)
    words = tattn.seed_words(2**32 + 9)
    assert words.tolist() == [9, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="1 or 5 words"):
        tattn.seed_words([1, 2])
    monkeypatch.setattr(tattn, "BWD_IMPL", "nope")
    with pytest.raises(ValueError, match="unknown BWD_IMPL"):
        tattn.flash_attention_bwd(q, k, v, q, q[..., 0], q)


@pytest.mark.parametrize("mode", ["fwd", "fused", "dq", "dkv"])
def test_wgmma_route_is_every_non_causal_bf16_call(mode, monkeypatch):
    """Every bf16 non-causal call (ring attention's off-diagonal blocks),
    forward, fused backward, dQ or dK/dV, goes to the C entry points of
    csrc/flash_attention_sm90.cu (wgmma, TMA) with its mode and the
    scratch that mode takes; every other dtype and causality goes to
    those of csrc/flash_attention.cu. Driven through the launch code with
    a stand-in for the built library, on CPU tensors."""
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tattn._build, "library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tattn, "launches", dict(tattn.launches))
    T = 6
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            x = torch.zeros(1, 2, T, 32, dtype=dtype)
            lse = torch.zeros(1, 2, T)
            kw = dict(causal=causal, dropout_rate=0.0, seed=None,
                      hash_seq_len=None)
            if mode == "fwd":
                tattn._launch_fwd(x, x, x, x, lse, None, **kw)
            else:
                tattn._launch_bwd(mode, x, x, x, x, lse, x, x, x, x, 0.1,
                                  dlse=None, **kw)
            name, args = calls.pop()
            sm90 = dtype == torch.bfloat16 and not causal
            assert tattn._on_wgmma(x, causal) == sm90
            assert tattn._on_ring_f32(x, causal) == (
                dtype == torch.float32 and not causal)
            assert name == ("nsb_flash_" + ("fwd" if mode == "fwd" else "bwd")
                            + ("_sm90" if sm90 else ""))
            if mode == "fwd":
                continue
            assert args[-2] == tattn._BWD_MODE[mode]
            # The row-statistics scratch (args[8]) of K5 and K7, none for
            # K6; the wgmma K5's f32 dQ accumulator (args[9]).
            assert (args[8] is None) == (mode == "dq")
            if sm90:
                assert (args[9] is None) == (mode != "fused")


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("with_dlse", [False, True], ids=["no_dlse", "dlse"])
@pytest.mark.parametrize("mode", ["dq", "dkv"])
def test_ring_f32_route_is_every_non_causal_fp32_split_call(
        mode, with_dlse, rate, monkeypatch):
    """Every fp32 non-causal dQ (K6) or dK/dV (K7) call, the split
    backward on ring attention's off-diagonal blocks, goes to nsb_flash_bwd
    as fp32 and non-causal with the mode it asked for (K7 with its
    (B*H, T) Drow scratch, K6 without), with and without dlse and dropout,
    and counts one launch of that instance; and csrc/flash_attention.cu
    sends those two modes, fp32 and non-causal, to the kernels of
    csrc/flash_ring_f32.cuh (flash_bwd_dq_ring_f32_kernel, and the pre-pass
    and flash_bwd_ring_f32_kernel without dQ). Driven through the launch
    code with a stand-in for the built library, on CPU tensors."""
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tattn._build, "library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tattn, "launches", dict(tattn.launches))
    x = torch.zeros(1, 2, 6, 32)
    lse = torch.zeros(1, 2, 6)
    dlse = lse.clone() if with_dlse else None
    allocated = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: allocated.append(
        a[0]) or empty(*a, **kw))
    assert tattn._on_ring_f32(x, False) and not tattn._on_wgmma(x, False)
    tattn._launch_bwd(mode, x, x, x, x, lse, x, x, x, x, 0.1, causal=False,
                      dlse=dlse, dropout_rate=rate, seed=3 if rate else None,
                      hash_seq_len=None)
    (name, args), = calls
    assert name == "nsb_flash_bwd"
    # (..., dtype, dropout on, threshold, keep scale, hash_seq_len,
    #  causal, mode, stream)
    assert args[-8] == tattn._DTYPE_CODE[torch.float32]
    assert args[-7] == int(rate > 0)
    assert args[-3] == 0 and args[-2] == tattn._BWD_MODE[mode]
    assert (args[6] is None) == (not with_dlse)
    assert (args[8] is None) == (mode == "dq")
    assert ((2, 6) in allocated) == (mode == "dkv")
    assert tattn.launches[f"flash_attention_bwd_{mode}/full"
                          + ("/dlse" if with_dlse else "")] == 1
    assert sum(tattn.launches.values()) == 1
    # The C side: run<float, D, false> dispatches the two modes to the
    # ring launchers, and those launch the ring kernels.
    from pathlib import Path

    csrc = Path(tattn.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "flash_attention.cu").read_text()
    non_causal = src.split("} else if constexpr (!kCausal) {", 1)[1].split(
        "} else {", 1)[0]
    launcher = {"dq": "run_bwd_dq_ring<D>(c)",
                "dkv": "run_bwd_ring<D, false>(c)"}[mode]
    case = {"dq": "kDq", "dkv": "kDkv"}[mode]
    assert f"case {case}: return {launcher};" in non_causal

    def body(fn):
        return src.split(f"cudaError_t {fn}(", 1)[1].split("\n}\n", 1)[0]

    launch = {"dq": "launch_bwd_dq_ring", "dkv": "launch_bwd_ring"}[mode]
    kernel = {"dq": "flash_bwd_dq_ring_f32_kernel<D, kBQ, ",
              "dkv": "flash_bwd_ring_f32_kernel<D, kBK, kWithDq, "}[mode]
    code = body(launcher.split("<")[0]) + body(launch)
    assert f"{launch}<D, " in code and kernel in code
    ring = (csrc / "flash_ring_f32.cuh").read_text()
    assert kernel.split("<")[0].join("\n(") in ring
    assert "flash_bwd_kv_kernel" not in non_causal + code
    assert "flash_bwd_dq_f32_kernel" not in non_causal + code


@pytest.mark.parametrize("dtype", [pytest.param(torch.bfloat16, id="bf16"),
                                   pytest.param(torch.float32, id="fp32")])
def test_chip_smoke_ring_checks_rehearse_on_cpu(dtype, monkeypatch):
    """chip_smoke.py's phase-7 checks of the non-causal instances at their
    tile edges (RING_EDGES in bf16, RING_EDGES_F32 in fp32: head_dim 32
    and 128, ragged, partial and one-key tiles, with and without dlse and
    dropout), with the fp32 fused backward's dK and dV held to equal bits
    on two calls, run on the CPU, where both sides are the plain versions,
    and pass."""
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    assert chip_smoke.RING_BLOCKS == ((1, 12, 1024, 64), (4, 12, 1024, 64))
    edges = (chip_smoke.RING_EDGES if dtype == torch.bfloat16
             else chip_smoke.RING_EDGES_F32)
    assert {e[3] for e in edges} == {32, 64, 128}
    assert 1 in {e[2] for e in edges} and {0.0, 0.1} <= {e[5] for e in edges}
    rows = []
    # The plain versions' (T, T) scores: keep it small.
    chip_smoke.check_ring_edges(tattn, np.random.default_rng(0), dtype,
                                [e for e in edges
                                 if e[0] * e[1] * e[2] <= 4096], rows)
    assert rows and all(e["err"] == 0.0 for r in rows
                        for k, e in r.items() if k != "case")


def test_kernel_argument_checks():
    """What the kernels do not take raises before a pointer leaves
    Python (the checks are device-independent)."""
    q = torch.zeros(1, 2, 8, 64)
    tattn._check(("q", q), ("k", q), ("v", q))
    with pytest.raises(ValueError, match="head_dim 48"):
        tattn._check(("q", torch.zeros(1, 2, 8, 48)),)
    with pytest.raises(TypeError, match="float16"):
        tattn._check(("q", q.half()),)
    with pytest.raises(ValueError, match="contiguous"):
        tattn._check(("q", q), ("k", q.transpose(2, 3).contiguous()
                                .transpose(2, 3)))
    with pytest.raises(ValueError, match="lse"):
        tattn._check(("q", q), ("lse", torch.zeros(1, 2, 8,
                                                   dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="65536"):
        tattn.torch_flash_attention(q, q, q, dropout_rate=0.1, seed=1,
                                    hash_seq_len=70000)


@pytest.mark.parametrize("T,rate", [(96, 0.0), (96, 0.1), (200, 0.0),
                                    (200, 0.1)])
def test_plain_versions_on_bf16_match_jax(T, rate):
    """The yardstick the bf16 tensor-core kernels are held to on the card
    (chip_smoke.py phase 7: the plain versions fed the same bf16 inputs)
    against the JAX package's flash kernels in interpret mode on the
    same numpy-seeded inputs cast to bf16: o, lse, dq, dk, dv within
    2e-2, compared in f32. D 64; dO scaled by 0.1, as phase 7's (a mean
    loss's gradients are small). Both sides round their outputs to bf16
    and JAX also rounds p and ds before its products: 2e-2 is phase 7's
    bf16 limit and covers both."""
    rng = np.random.default_rng(6)
    shape = (B, H, T, 64)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    do = 0.1 * rng.standard_normal(shape, dtype=np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    seed = [9, 0, 0, 2, 4] if rate else None
    if rate:
        jseed = jnp.asarray(seed, jnp.uint32)
        jo, jlse = jattn.flash_attention_lse_dropout(jq, jk, jv, jseed, True,
                                                     None, rate, True)

        def fn(q, k, v):
            return jattn.flash_attention_dropout(q, k, v, jseed, True, None,
                                                 rate, True)
    else:
        jo, jlse = jattn.flash_attention_lse(jq, jk, jv, True, None, True)

        def fn(q, k, v):
            return jattn.flash_attention(q, k, v, True, None, True)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    refs = [jo, jlse, *vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    o, lse = tattn.flash_attention_fwd(tq, tk, tv, dropout_rate=rate,
                                       seed=seed)
    grads = tattn.flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                      dropout_rate=rate, seed=seed)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grads)
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse, *grads), refs):
        ref = np.asarray(ref, dtype=np.float32)
        assert np.abs(ref).max() > 0.05, name      # not a vacuous check
        np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2,
                                   err_msg=name)
