"""The port's GPT against the JAX package's flax GPT.

The tiny config of tests/conftest.py::tiny_cfg (2 layers, 2 heads, 64
wide, block 64) in fp32, initialised in JAX and carried over with
state_dict_from_jax_params. The no-cache logits must match GPT.apply
within atol 1e-4; so must a paged prefill (cold, then at a page-aligned
start like a prefix hit) followed by 3 decode steps through the port's
cache path, against the JAX cached path on an identical block table
(decode_impl='pallas_interpret', the Pallas kernels' interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.models.gpt import init_paged_cache as jax_paged_cache
from nanosandbox_tpu_torch.checkpoint import (load_for_serving,
                                              save_for_serving)
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT, init_paged_cache, kv_mode

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny models gain nothing from torch's full intra-op thread pool,
    and the suite's other workers run timing-sensitive tests beside
    these; two threads keep this module from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twin():
    """(jax cfg, flax model, params, port cfg, port model) with one set
    of weights."""
    jcfg = JaxGPTConfig(**DIMS, compute_dtype="float32",
                        attention_impl="xla", decode_impl="pallas_interpret")
    jmodel = JaxGPT(jcfg)
    # Compiled: the op-by-op init takes four times as long on the CPU.
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jcfg, jmodel, params, cfg, model.eval()


def test_no_cache_logits_match_jax(twin):
    jcfg, jmodel, params, cfg, model = twin
    idx = np.random.default_rng(0).integers(0, 65, size=(2, 40))
    ref = jmodel.apply({"params": params}, jnp.asarray(idx, jnp.int32))
    with torch.no_grad():
        out = model(torch.from_numpy(idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_paged_prefill_and_decode_match_jax(twin):
    jcfg, jmodel, params, cfg, model = twin
    page, N = 16, 8
    # Row 0 owns blocks 3, 0, 5 and a sentinel; row 1 owns 1, 6, 2, 7.
    table = np.array([[3, 0, 5, N], [1, 6, 2, 7]], np.int32)
    rng = np.random.default_rng(1)
    first = rng.integers(0, 65, size=(2, 16))     # positions [0, 16)
    second = rng.integers(0, 65, size=(2, 20))    # [16, 36): start 16
    jpool = jax_paged_cache(jcfg, N, page)
    tpool = init_paged_cache(cfg, N, page)
    jtbl, ttbl = jnp.asarray(table), torch.from_numpy(table)
    # Compiled once a shape (T 16, 20 and 1): the same function as the
    # op-by-op apply, in a fifth of its time on the CPU.
    japply = jax.jit(lambda p, t, c, i, b: jmodel.apply(
        {"params": p}, t, cache=c, cache_index=i, block_table=b))

    def both(tokens, pos):
        nonlocal jpool
        jl, jpool = japply(params, jnp.asarray(tokens, jnp.int32), jpool,
                           jnp.asarray(pos, jnp.int32), jtbl)
        with torch.no_grad():
            tl = model(torch.from_numpy(np.asarray(tokens, np.int64)),
                       cache=tpool,
                       cache_index=torch.tensor(pos, dtype=torch.int32),
                       block_table=ttbl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        return tl

    both(first, [0, 0])
    logits = both(second, [16, 16])
    pos = 36
    for _ in range(3):
        nxt = logits[:, -1].argmax(-1).numpy()[:, None]
        logits = both(nxt, [pos, pos])
        pos += 1


def test_paged_cache_matches_no_cache_recompute(twin):
    """The port against itself: the cached path's last-position logits
    equal a full recompute of the same sequence."""
    _, _, _, cfg, model = twin
    page, N = 16, 8
    table = torch.tensor([[4, 2, 7, 0]], dtype=torch.int32)
    pool = init_paged_cache(cfg, N, page)
    seq = torch.from_numpy(np.random.default_rng(2).integers(0, 65, (1, 30)))
    with torch.no_grad():
        model(seq[:, :27], cache=pool,
              cache_index=torch.zeros(1, dtype=torch.int32),
              block_table=table)
        for p in range(27, 30):
            cached = model(seq[:, p:p + 1], cache=pool,
                           cache_index=torch.tensor([p], dtype=torch.int32),
                           block_table=table)[0, -1]
            full = model(seq[:, :p + 1])[0, -1]
            np.testing.assert_allclose(cached.numpy(), full.numpy(),
                                       atol=ATOL)


def test_sentinel_writes_land_in_the_drop_block(twin):
    """A write bound for the sentinel (a parked row's table) touches no
    real block: only the drop block at index N changes."""
    _, _, _, cfg, model = twin
    page, N = 16, 4
    pool = init_paged_cache(cfg, N, page)
    before = [k.clone() for k, _ in pool]
    with torch.no_grad():
        model(torch.ones(1, 5, dtype=torch.int64), cache=pool,
              cache_index=torch.zeros(1, dtype=torch.int32),
              block_table=torch.full((1, 4), N, dtype=torch.int32))
    for (k, _), k0 in zip(pool, before):
        assert torch.equal(k[:N], k0[:N])
        assert not torch.equal(k[N], k0[N])


def test_state_dict_round_trips_through_serving_checkpoint(twin, tmp_path):
    _, _, _, cfg, model = twin
    save_for_serving(str(tmp_path), cfg, model.state_dict())
    cfg2, sd = load_for_serving(str(tmp_path))
    assert cfg2 == cfg
    ref = model.state_dict()
    assert sd.keys() == ref.keys()
    for name, t in ref.items():
        assert torch.equal(sd[name], t), name


def test_kv_dtype_modes(twin):
    cfg = twin[3]
    assert kv_mode(cfg, None) == "fp32" and kv_mode(cfg, "bfloat16") == "bf16"
    k = init_paged_cache(cfg, 3, 8)[0][0]
    assert k.shape == (4, 2, 8, 32) and k.dtype == torch.float32
    assert init_paged_cache(cfg, 3, 8, kv_dtype="bf16")[0][0].dtype == (
        torch.bfloat16)
    # int8 / int4: 4-tuples (K, V, k_scale, v_scale) with the drop block,
    # int4 packing two dims per byte.
    for mode, dtype, d in (("int8", torch.int8, 32), ("int4", torch.uint8,
                                                      16)):
        assert kv_mode(cfg, mode) == mode
        k, v, ks, vs = init_paged_cache(cfg, 3, 8, kv_dtype=mode)[0]
        assert k.shape == v.shape == (4, 2, 8, d) and k.dtype == dtype
        assert ks.shape == vs.shape == (4, 2, 8)
        assert ks.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        kv_mode(cfg, "int2")
