"""Activation checkpointing (remat) of the port's GPT, on the CPU.

* Both policies leave the loss and every parameter gradient bit for bit
  what they are without remat, with and without dropout 0.1: the
  recompute replays the dropout generator from the block's first state
  (torch.utils.checkpoint restores only the default generators), and
  under 'save_attention' takes back each attention call's (o, lse).
* Against the JAX model with remat=True (its Pallas kernels in interpret
  mode, the 'attn_out' / 'attn_lse' tags) on carried-over weights: the
  loss within 1e-5 and every gradient within 1e-4 (the limits of
  tests/test_torch_train.py).
* The plain attention forward runs n_layer times a micro-step without
  remat and under 'save_attention', 2 n_layer times under 'full' (JAX:
  2 / 3 / 2 pallas_calls a layer, forward and backward, in
  tests/test_model.py).
* Bytes kept for the backward, counted with saved_tensors_hooks (plus
  what remat keeps beside them: each block's input and, under
  'save_attention', the saved (o, lse)): fewer under both policies than
  without remat.
* An unknown policy raises JAX's ValueError; the cached decode path and
  no-grad evaluation never remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu import config as jconfig
from nanosandbox_tpu.models import gpt as jgpt
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models import gpt as tgpt
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.ops import attention as at

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=32, vocab_size=65)
POLICIES = ("save_attention", "full")


def _batch():
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.integers(0, 65, (2, 32))),
            torch.from_numpy(rng.integers(0, 65, (2, 32))))


def _model(remat=False, policy="save_attention", dropout=0.0):
    cfg = GPTConfig(**DIMS, compute_dtype="float32", dropout=dropout,
                    remat=remat, remat_policy=policy)
    return tgpt.GPT(cfg, generator=torch.Generator().manual_seed(0))


def _step(model, dropout):
    """(loss, {name: grad}) of one micro-step."""
    x, y = _batch()
    gen = torch.Generator().manual_seed(11) if dropout else None
    loss = tgpt.cross_entropy_loss(model(x, dropout_generator=gen), y)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_leaves_loss_and_gradients_bit_equal(policy, dropout):
    ref_loss, ref = _step(_model(dropout=dropout), dropout)
    loss, got = _step(_model(True, policy, dropout), dropout)
    assert torch.equal(loss, ref_loss)
    for name, g in ref.items():
        assert torch.equal(got[name], g), name


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax(policy):
    jcfg = jconfig.GPTConfig(**DIMS, compute_dtype="float32",
                             attention_impl="pallas_interpret", remat=True,
                             remat_policy=policy)
    jmodel = jgpt.GPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    model = _model(True, policy)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), model.cfg))
    x, y = (t.numpy() for t in _batch())

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x, jnp.int32))
        return jgpt.cross_entropy_loss(logits, jnp.asarray(y, jnp.int32))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    ref = state_dict_from_jax_params(jax.device_get(jg), model.cfg)
    loss, got = _step(model, 0.0)
    assert abs(loss.item() - float(jl)) <= 1e-5
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("remat,policy,per_layer", [
    (False, "save_attention", 1), (True, "full", 2),
    (True, "save_attention", 1)])
def test_attention_forward_calls_a_micro_step(remat, policy, per_layer,
                                              monkeypatch):
    calls = []
    plain = at.torch_flash_attention

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(at, "torch_flash_attention", counted)
    _step(_model(remat, policy, 0.1), 0.1)
    assert len(calls) == per_layer * DIMS["n_layer"]


def test_remat_keeps_fewer_bytes(monkeypatch):
    stores = []

    class Recorded(at.SavedAttention):
        def __init__(self):
            super().__init__()
            stores.append(self)

    monkeypatch.setattr(tgpt, "SavedAttention", Recorded)
    x, y = _batch()
    kept = {}
    for remat, policy in ((False, "full"), (True, "full"),
                          (True, "save_attention")):
        model = _model(remat, policy)
        packed = []

        def pack(t):
            packed.append(t.numel() * t.element_size())
            return t

        stores.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h = model.hidden(x)
        loss = tgpt.cross_entropy_loss(model.head(h), y)
        # What a checkpoint keeps outside the hooks: each block's input,
        # and the attention outputs under 'save_attention'.
        extra = (DIMS["n_layer"] * h.numel() * h.element_size()
                 if remat else 0)
        kept[(remat, policy)] = (sum(packed) + extra + sum(
            t.numel() * t.element_size()
            for s in stores for pair in s.outs for t in pair))
        if policy == "save_attention":
            assert len(stores) == DIMS["n_layer"]
            assert all(len(s.outs) == 1 for s in stores)
        loss.backward()
    base = kept[(False, "full")]
    assert kept[(True, "full")] < kept[(True, "save_attention")] < base, kept


def test_unknown_policy_and_where_remat_does_not_apply(monkeypatch):
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GPTConfig(**DIMS, remat=True, remat_policy="dots_saveable")
    model = _model(True, "full")
    calls = []
    monkeypatch.setattr(tgpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or None)
    x, _ = _batch()
    with torch.no_grad():
        model(x)
        model(x[:, :1], cache=tgpt.init_cache(model.cfg, 2, 32),
              cache_index=0)
    assert calls == []
