"""The port's offline sampler against the JAX package's.

Greedy ``generate`` (temperature 0) on the tiny fp32 model of
tests/test_torch_model.py must give exactly the JAX ``generate``'s
tokens on the same weights, on the cached branch (prompt + new tokens
within block_size: a dense-cache prefill, then single-token steps) and
on the windowed branch (past block_size: the sliding-window re-forward).
Sampled generation replays under a seed and keys sample i by seed + i.
The CLI runs end to end on the CPU from an out_dir the port's trainer
wrote.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.sample import generate as jax_generate
from nanosandbox_tpu_torch import sample as tsample
from nanosandbox_tpu_torch import train as ttrain
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import GPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)


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
    jcfg = JaxGPTConfig(**DIMS, compute_dtype="float32",
                        attention_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**DIMS, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jmodel, params, model.eval()


@pytest.mark.parametrize("T0,new", [(9, 20), (50, 24)])
def test_greedy_generate_matches_jax(twin, T0, new):
    """(9, 20) stays within block_size 64 (cached); (50, 24) passes it
    (windowed)."""
    jmodel, params, model = twin
    idx = np.random.default_rng(T0).integers(0, 65, (2, T0))
    ref = jax_generate(jmodel, params, jnp.asarray(idx, jnp.int32), new,
                       temperature=0.0, top_k=0, rng=jax.random.key(0),
                       block_size=64)
    out = tsample.generate(model, torch.from_numpy(idx), new)
    assert out.shape == (2, T0 + new)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_generate_replays_per_sample_seeds(twin):
    *_, model = twin
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 65, (1, 6)))
    kw = dict(temperature=0.9, top_k=20, seed=11)
    a = tsample.generate(model, idx.repeat(2, 1), 12, **kw)
    b = tsample.generate(model, idx.repeat(2, 1), 12, **kw)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    # Sample 1 of a run seeded 11 is sample 0 of a run seeded 12.
    c = tsample.generate(model, idx, 12, **dict(kw, seed=12))
    assert torch.equal(a[1:], c)


def test_cli_samples_from_a_trained_out_dir(char_dataset, tmp_path,
                                            capsys):
    out = str(tmp_path / "out")
    ttrain.main([os.path.join(REPO, "configs", "smoke_cpu.py"),
                 f"--data_dir={char_dataset}", f"--out_dir={out}",
                 "--device=cpu", "--block_size=32", "--batch_size=4",
                 "--n_layer=1", "--max_iters=4", "--lr_decay_iters=4",
                 "--eval_interval=0", "--eval_iters=1", "--log_interval=0",
                 "--tensorboard=False", "--run_name=r"])
    with open(os.path.join(char_dataset, "shakespeare_char", "meta.pkl"),
              "rb") as f:
        itos = pickle.load(f)["itos"]
    start = "".join(itos[i] for i in range(1, 4))
    flags = [f"--out_dir={out}", "--device=cpu", f"--start={start}",
             "--num_samples=2", "--max_new_tokens=12"]
    greedy = tsample.main(flags + ["--temperature=0"])
    assert len(greedy) == 2 and greedy[0] == greedy[1]
    assert greedy[0].startswith(start) and len(greedy[0]) == len(start) + 12
    sampled = tsample.main(flags + ["--temperature=1.0", "--top_k=5"])
    assert all(t.startswith(start) for t in sampled)
    assert capsys.readouterr().out.count("---------------") == 4
    # 40 new tokens past block_size 32: the windowed branch.
    long = tsample.main(flags[:3] + ["--num_samples=1",
                                     "--max_new_tokens=40",
                                     "--temperature=0"])
    assert len(long[0]) == len(start) + 40


def test_byte_tokenizer_decodes_ids_past_the_byte_range():
    """A byte-trained model with a wider head can sample ids >= 256; the
    sampler prints them as U+FFFD instead of failing."""
    from nanosandbox_tpu_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ids = tok.encode("héllo")
    assert tok.decode(ids) == "héllo"
    assert tok.decode(ids[:2] + [300] + ids[3:] + [50000]) == \
        "h\ufffd\ufffdllo\ufffd"
