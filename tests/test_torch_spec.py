"""The port's speculative decoding against the JAX package's.

On the tiny fp32 model (2 layers, n_embd 64, block_size 64, vocab 65)
whose weights JAX initialises and models/convert.py carries across:

  * the verify block (T = k+1 = 5 at per-row cache_index) gives the JAX
    model's logits, dense and paged, fp32 within 1e-5 and int8 within
    1e-4 (the tolerance of tests/test_torch_model.py), with the same
    greedy argmax; the dense cache is 40 positions and one row's block
    starts 2 from its end (three columns dropped, as JAX's scatter-drop
    write drops them), and a paged row runs past its reserved blocks into
    the drop block; the pools agree after the writes;
  * greedy outputs with spec (NGramDrafter, ModelDrafter over both pools,
    an oracle ModelDrafter of the target's own weights) equal the port's
    non-spec engine's and the JAX Engine(spec=NGramDrafter)'s, on a mixed
    batch whose random prompts draft nothing (draft_len 0 rows); an
    always-wrong drafter (full reject every step) and an eos inside an
    accepted run are exact;
  * rejection sampling keeps the target distribution: at temperature 1
    the spec engine's second tokens over 800 seeds pass a chi-square
    goodness-of-fit test (p > 0.001) against the model's own conditional
    probabilities, and a row with draft_len 0 draws the non-spec token;
  * the sampler CLI's --spec and the drafter flag.
"""

import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax
import jax.numpy as jnp
from nanosandbox_tpu.config import GPTConfig as JaxGPTConfig
from nanosandbox_tpu.models.gpt import GPT as JaxGPT
from nanosandbox_tpu.models.gpt import init_cache as jax_init_cache
from nanosandbox_tpu.models.gpt import \
    init_paged_cache as jax_init_paged_cache
from nanosandbox_tpu.serve import Engine as JaxEngine
from nanosandbox_tpu.serve import NGramDrafter as JaxNGramDrafter
from nanosandbox_tpu_torch.config import GPTConfig
from nanosandbox_tpu_torch.models.convert import state_dict_from_jax_params
from nanosandbox_tpu_torch.models.gpt import (GPT, init_cache,
                                              init_paged_cache)
from nanosandbox_tpu_torch.serve.drafters import (ModelDrafter, NGramDrafter,
                                                  drafter_from_flag)
from nanosandbox_tpu_torch.serve.engine import Engine

DIMS = dict(n_layer=2, n_head=2, n_embd=64, block_size=64, vocab_size=65)
DRAFT_DIMS = dict(n_layer=1, n_head=2, n_embd=32, block_size=64,
                  vocab_size=65)
K = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(dims, key):
    jcfg = JaxGPTConfig(**dims, compute_dtype="float32",
                        attention_impl="xla")
    jmodel = JaxGPT(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(key),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**dims, compute_dtype="float32")
    model = GPT(cfg)
    model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(params), cfg))
    return jmodel, params, model


@pytest.fixture(scope="module")
def models():
    return _pair(DIMS, 0)


@pytest.fixture(scope="module")
def draft_model():
    return GPT(GPTConfig(**DRAFT_DIMS, compute_dtype="float32"),
               generator=torch.Generator().manual_seed(1))


def _workload(seed=7, n=10):
    """tests/test_spec.py's mix: repetitive prompts (the drafter's
    regime) and random ones (draft_len 0 rows), 1-15 new tokens."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(n):
        L = int(rng.integers(2, 30))
        if i % 2 == 0:
            motif = rng.integers(0, 65, int(rng.integers(2, 4)))
            prompt = np.tile(motif, L // len(motif) + 1)[:L].tolist()
        else:
            prompt = [int(x) for x in rng.integers(0, 65, L)]
        work.append((prompt, int(rng.integers(1, 16))))
    return work


def _run(engine, work, **kw):
    rids = [engine.submit(p, m, **kw) for p, m in work]
    done = {r.rid: r for r in engine.drain()}
    return [done[r].tokens for r in rids]


@pytest.fixture(scope="module")
def plain_tokens(models):
    """The port's non-spec greedy tokens of the mix (paged; the dense
    engine's equal them, tests/test_torch_engine.py)."""
    return _run(Engine(models[2], num_slots=4, max_len=64, device="cpu"),
                _workload())


# --------------------------------------------------------------- verify

def _verify_rounds(rng, B, T):
    return [rng.integers(0, 65, (B, T)) for _ in range(2)]


def _japply(jmodel):
    """JAX's cached forward at a traced per-row cache_index, jitted (one
    compile instead of one per primitive)."""
    return jax.jit(lambda params, toks, cache, index, table: jmodel.apply(
        {"params": params}, toks, deterministic=True, cache=cache,
        cache_index=index, block_table=table))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_dense_verify_block_matches_jax(models, kv_dtype):
    """Per-row T = 5 blocks into a 40-position dense cache after a
    prefill, one row starting 2 from the end: logits and the cache
    agree with JAX's."""
    jmodel, params, model = models
    L, B = 40, 3
    tol = 1e-5 if kv_dtype == "fp32" else 1e-4
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 65, (B, 20))
    jc = jax_init_cache(jmodel.cfg, B, L, kv_dtype=kv_dtype)
    tc = init_cache(model.cfg, B, L, kv_dtype)
    if kv_dtype == "fp32":
        # History from a prefill (the quantized dense pool takes its
        # prefill through scatter_cache_rows in the engine).
        _, jc = jmodel.apply({"params": params}, jnp.asarray(prompt),
                             deterministic=True, cache=jc, cache_index=0)
        with torch.no_grad():
            model(torch.from_numpy(prompt), cache=tc, cache_index=0)
    starts = np.array([5, 20, L - 2], np.int32)
    japply = _japply(jmodel)
    for toks in _verify_rounds(rng, B, K + 1):
        jl, jc = japply(params, jnp.asarray(toks), jc, jnp.asarray(starts),
                        None)
        with torch.no_grad():
            tl = model(torch.from_numpy(toks), cache=tc,
                       cache_index=torch.from_numpy(starts))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
        assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()
        starts = starts + 1
    for jlayer, tlayer in zip(jc, tc):
        for j, t in zip(jlayer, tlayer):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_verify_block_matches_jax(models, kv_dtype):
    """Per-row T = 5 blocks over a paged pool (page 8) through block
    tables: row 0 mid-chain, row 1 across a block boundary, row 2 past
    its two reserved blocks (those columns go to the drop block, JAX
    drops them). Logits agree with JAX's at every column inside a row's
    reservation (a query past it reads keys that exist in neither pool;
    the engine caps drafts so that it never uses one), and so do the
    allocated blocks; the drop block took row 2's overrun."""
    jmodel, params, model = models
    page, N, nb, B = 8, 12, 4, 3
    tol = 1e-5 if kv_dtype == "fp32" else 1e-4
    table = np.full((B, nb), N, np.int32)
    table[0, :3] = [3, 0, 7]
    table[1, :4] = [1, 5, 9, 2]
    table[2, :2] = [4, 6]
    jc = jax_init_paged_cache(jmodel.cfg, N, page, kv_dtype=kv_dtype)
    tc = init_paged_cache(model.cfg, N, page, kv_dtype)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 65, (B, 8))
    zeros = np.zeros(B, np.int32)
    japply = _japply(jmodel)
    _, jc = japply(params, jnp.asarray(prompt), jc, jnp.asarray(zeros),
                   jnp.asarray(table))
    with torch.no_grad():
        model(torch.from_numpy(prompt), cache=tc,
              cache_index=torch.from_numpy(zeros),
              block_table=torch.from_numpy(table))
    starts = np.array([9, 13, 14], np.int32)
    reserved = (table < N).sum(axis=1) * page
    for toks in _verify_rounds(rng, B, K + 1):
        jl, jc = japply(params, jnp.asarray(toks), jc, jnp.asarray(starts),
                        jnp.asarray(table))
        with torch.no_grad():
            tl = model(torch.from_numpy(toks), cache=tc,
                       cache_index=torch.from_numpy(starts),
                       block_table=torch.from_numpy(table))
        inside = starts[:, None] + np.arange(K + 1)[None] < reserved[:, None]
        assert not inside.all()
        np.testing.assert_allclose(tl.numpy()[inside], np.asarray(jl)[inside],
                                   atol=tol, rtol=tol)
        assert (tl.argmax(-1).numpy()[inside]
                == np.asarray(jl).argmax(-1)[inside]).all()
        starts = starts + 1
    if kv_dtype == "fp32":      # a quantized drop write stores zeros
        assert tc[0][0][N].abs().sum() > 0
    used = sorted(int(b) for b in table.reshape(-1) if b < N)
    for jlayer, tlayer in zip(jc, tc):
        for j, t in zip(jlayer, tlayer):
            np.testing.assert_allclose(t[used].float().numpy(),
                                       np.asarray(j, np.float32)[used],
                                       atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- engines

def test_ngram_spec_greedy_matches_plain_and_jax(models, plain_tokens):
    """The mix through the port's NGram spec engine, paged and dense,
    equals its non-spec engine and the JAX spec engine token for token;
    the repetitive half speculates (tokens accepted), and the verify is
    one step a dispatch."""
    jmodel, params, model = models
    jeng = JaxEngine(jmodel, params, num_slots=4, max_len=64,
                     spec=JaxNGramDrafter(k=K))
    want = _run(jeng, _workload())
    assert want == plain_tokens
    for paged in (True, False):
        eng = Engine(model, num_slots=4, max_len=64, paged=paged,
                     spec=NGramDrafter(k=K), device="cpu")
        assert _run(eng, _workload()) == plain_tokens, paged
        st = eng.stats()
        assert st["pipeline"] is False and st["scan_k"] == 1
        assert st["spec"]["tokens_accepted"] > 0
        assert st["spec"]["verify_steps"] == st["host_dispatches"]["verify"]
        assert st["host_dispatches"]["decode"] == 0
        assert st["spec_acceptance_rate"] == pytest.approx(
            st["spec"]["tokens_accepted"] / st["spec"]["tokens_drafted"])
        assert st["spec_accepted_len_mean"] is not None
    js = jeng.stats()["spec"]
    assert js["tokens_accepted"] == st["spec"]["tokens_accepted"]
    assert js["tokens_drafted"] == st["spec"]["tokens_drafted"]


@pytest.mark.parametrize("paged", [True, False])
def test_model_drafter_greedy_parity(models, draft_model, plain_tokens,
                                     paged):
    """A smaller ModelDrafter, paged (its pool indexed by the engine's
    block ids) and dense, and an oracle drafter with the target's own
    weights: tokens equal the non-spec engine's; the oracle accepts every
    draft and needs fewer target forwards than tokens."""
    _, _, model = models
    eng = Engine(model, num_slots=4, max_len=64, paged=paged,
                 spec=ModelDrafter(draft_model, k=3), device="cpu")
    assert _run(eng, _workload()) == plain_tokens
    assert eng._spec.drafter.pool[0][0].shape[0] == (
        eng.kv_pool_blocks + 1 if paged else 4)
    oracle = Engine(model, num_slots=4, max_len=64, paged=paged,
                    spec=ModelDrafter(_copy(model), k=3), device="cpu")
    assert _run(oracle, _workload()) == plain_tokens
    st = oracle.stats()
    assert st["spec_acceptance_rate"] == 1.0
    forwards = st["host_dispatches"]["verify"] + st["prefill_waves"]
    assert forwards < st["tokens_generated"]


def _copy(model):
    twin = GPT(model.cfg)
    twin.load_state_dict(model.state_dict())
    return twin


class _Scripted:
    """A host drafter proposing from a script indexed by the tokens
    generated so far (tests/test_spec.py's _ScriptedDrafter)."""

    kind = "host"

    def __init__(self, scripts, k=4):
        self.scripts, self.k = scripts, k

    def propose(self, context, max_tokens=None):
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        ctx = tuple(context)
        for prompt, script in self.scripts.items():
            if ctx[:len(prompt)] == prompt:
                done = len(ctx) - len(prompt)
                return script[done:done + cap]
        return []


def _lively():
    """A tiny model whose greedy streams vary (the JAX-initialised one
    repeats a prompt's last token): seeded GPT-2 init, matrices x 8."""
    model = GPT(GPTConfig(**DIMS, compute_dtype="float32"),
                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(8)
    return model


def test_full_reject_rollback_and_eos_mid_run():
    """An always-wrong drafter rejects every draft, the frontier rolls
    back each step, and the tokens are still the plain engine's at one a
    verify; an oracle drafter puts an eos inside an accepted run, which
    truncates exactly there, and the next request in the same slot is
    unaffected."""
    model = _lively()
    plain = Engine(model, num_slots=1, max_len=64, device="cpu")
    prompt = (5, 3, 1, 4)
    ref = _run(plain, [(list(prompt), 12)])[0]
    wrong = [(t + 1) % 65 for t in ref]
    eng = Engine(model, num_slots=1, max_len=64, device="cpu",
                 spec=_Scripted({prompt: wrong}))
    assert _run(eng, [(list(prompt), 12)])[0] == ref
    st = eng.stats()
    assert st["spec"]["tokens_accepted"] == 0
    assert st["spec"]["verify_steps"] == 11
    for cand in ((5, 3), (6, 6, 2), (42, 13, 27, 33), (49, 48, 47)):
        ref = _run(plain, [(list(cand), 12)])[0]
        novel = [i for i in range(2, len(ref) - 1) if ref[i] not in ref[:i]]
        if novel:
            prompt, idx = cand, novel[0]
            break
    else:
        pytest.fail("no prompt with a novel greedy token mid-stream")
    eos = ref[idx]
    eng = Engine(model, num_slots=1, max_len=64, device="cpu",
                 spec=_Scripted({prompt: ref}))
    a = eng.submit(prompt, 12, eos_id=eos)
    b = eng.submit([9, 9], 6)
    done = {r.rid: r for r in eng.drain()}
    assert done[a].tokens == ref[:idx + 1]
    assert done[a].finish_reason == "eos"
    assert done[b].tokens == _run(plain, [([9, 9], 6)])[0]


class _Const:
    kind = "host"

    def __init__(self, token, k=2):
        self.token, self.k = token, k

    def propose(self, context, max_tokens=None):
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        return [self.token] * max(cap, 0)


def test_rejection_sampling_keeps_the_target_distribution():
    """Temperature 1, 800 seeds, a constant drafter (accept probability
    exactly p(token)): the first token is the prefill's (equal to the
    non-spec engine's), and the second, drawn by the accept / resample
    rule, fits the model's own conditional distribution given the first
    (chi-square over the 13-token vocabulary, p > 0.001). A row whose
    drafter proposes nothing draws the non-spec token, key and all."""
    V = 13
    cfg = GPTConfig(n_layer=1, n_head=2, n_embd=16, block_size=16,
                    vocab_size=V, compute_dtype="float32")
    model = GPT(cfg, generator=torch.Generator().manual_seed(4))
    prompt, n = [1, 2, 1, 2], 800
    draft = 5

    def collect(spec):
        eng = Engine(model, num_slots=8, max_len=16, spec=spec,
                     device="cpu")
        rids = [eng.submit(prompt, 3, temperature=1.0, seed=s)
                for s in range(n)]
        done = {r.rid: r.tokens for r in eng.drain()}
        return np.asarray([done[r] for r in rids]), eng

    base, _ = collect(None)
    spec, eng = collect(_Const(draft))
    assert 0.0 < eng.stats()["spec_acceptance_rate"] < 1.0
    np.testing.assert_array_equal(spec[:, 0], base[:, 0])
    with torch.no_grad():
        firsts = sorted(set(spec[:, 0].tolist()))
        ctx = torch.tensor([prompt + [t] for t in firsts])
        probs = torch.softmax(model(ctx)[:, -1], dim=-1).numpy()
    expected = np.zeros(V)
    for i, t in enumerate(firsts):
        expected += (spec[:, 0] == t).sum() * probs[i]
    observed = np.bincount(spec[:, 1], minlength=V)
    keep = expected > 0
    chi2 = ((observed[keep] - expected[keep]) ** 2 / expected[keep]).sum()
    p = sps.chi2.sf(chi2, keep.sum() - 1)
    assert p > 1e-3, (chi2, p, observed, expected.round(1))
    # A drafter that proposes nothing: every row has draft_len 0, and
    # every token is the non-spec engine's.
    empty, _ = collect(_Scripted({}))
    np.testing.assert_array_equal(empty, base)


# ------------------------------------------------------------------ CLI

def test_drafter_flag_and_sampler_spec(models, char_dataset, tmp_path):
    """drafter_from_flag's values and its vocabulary check; `sample
    --spec` (ngram, and model: over a serving checkpoint of the same
    weights) on a training checkpoint of a tiny char model: greedy
    samples equal the plain sampler's; prompt + max_new_tokens past
    block_size is refused."""
    import pickle

    from nanosandbox_tpu_torch import sample
    from nanosandbox_tpu_torch.checkpoint import (TrainCheckpointer,
                                                  save_for_serving)
    from nanosandbox_tpu_torch.config import TrainConfig

    _, _, model = models
    assert drafter_from_flag("off") is None
    assert drafter_from_flag("") is None
    assert isinstance(drafter_from_flag("ngram", k=3), NGramDrafter)
    with pytest.raises(ValueError, match="model:<out_dir>"):
        drafter_from_flag("model:")
    with pytest.raises(ValueError, match="unknown --spec"):
        drafter_from_flag("bogus")
    bad = GPT(GPTConfig(**dict(DRAFT_DIMS, vocab_size=66),
                        compute_dtype="float32"))
    with pytest.raises(ValueError, match="vocab_size"):
        Engine(model, num_slots=2, max_len=64, device="cpu",
               spec=ModelDrafter(bad, k=2))

    with open(f"{char_dataset}/shakespeare_char/meta.pkl", "rb") as f:
        meta = pickle.load(f)
    tcfg = TrainConfig(data_dir=char_dataset, dataset="shakespeare_char",
                       n_layer=1, n_head=2, n_embd=32, block_size=32,
                       compute_dtype="float32", dropout=0.0)
    cfg = GPTConfig.from_train_config(tcfg, meta["vocab_size"])
    tiny = GPT(cfg, generator=torch.Generator().manual_seed(3))
    out = str(tmp_path / "out")
    TrainCheckpointer(out).save(1, model=tiny.state_dict(), optimizer={},
                                iter_num=1, best_val_loss=9.0,
                                config=tcfg.to_dict(), opt_step=1)
    save_for_serving(str(tmp_path / "draft"), cfg, tiny.state_dict())
    start = "".join(meta["itos"][i] for i in (1, 2, 3, 1, 2, 3))
    flags = [f"--out_dir={out}", "--device=cpu", f"--start={start}",
             "--num_samples=2", "--max_new_tokens=12", "--temperature=0"]
    plain = sample.main(flags)
    assert sample.main(flags + ["--spec=ngram", "--spec_k=3"]) == plain
    assert sample.main(flags + [f"--spec=model:{tmp_path / 'draft'}",
                                "--spec_k=2"]) == plain
    with pytest.raises(SystemExit):
        sample.main(flags[:3] + ["--max_new_tokens=40", "--spec=ngram"])
