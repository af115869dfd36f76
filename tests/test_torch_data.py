"""The port's BPE tokenizer and data.prepare against the JAX package's,
on the CPU.

* ``LocalBPETokenizer``: the port's standard-library byte-level BPE
  gives the JAX package's HF-``tokenizers`` ids id for id, on the first
  256 KB of the XL corpus and on generated text (hypothesis, fixed seed)
  that covers every Unicode letter and number category, marks, CJK,
  emoji, runs of ``\\r\\n\\t`` and U+3000, control characters the two
  regex engines' ``\\s`` disagree on, and ``'s`` / ``'S``; decode gives
  the same string on random id runs (invalid UTF-8 included).
* ``data.prepare``: each dataset's train.bin, val.bin and meta.pkl,
  written by the port's CLI, are byte-equal to the JAX CLI's:
  english_prose_char, english_prose_bpe (a 1 MB slice), shakespeare_char
  and openwebtext --tokenizer=bpe from a --source_file; the synthetic
  corpus is the same text; the offline errors are the same (the JAX
  package's network calls stubbed to fail as they fail offline).
* The port encodes with ``tokenizers`` and ``regex`` blocked.
* chip_smoke.py's BPE_SHA256 constants are the JAX package's prepare of
  the whole XL corpus.
"""

import hashlib
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
from hypothesis import given, seed, settings
from hypothesis import strategies as st

from nanosandbox_tpu.data import prepare as jprepare
from nanosandbox_tpu.data import tokenizer as jtok
from nanosandbox_tpu_torch.data import prepare as tprepare
from nanosandbox_tpu_torch.data import tokenizer as ttok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(REPO, "data", "fixtures", "english_prose_xl.txt")


@pytest.fixture(scope="module")
def toks():
    return ttok.get_tokenizer("bpe"), jtok.get_tokenizer("bpe")


def _xl(n_chars: int) -> str:
    with open(XL, encoding="utf-8") as f:
        return f.read(n_chars)


def test_bpe_ids_match_jax_on_the_corpus(toks):
    port, ref = toks
    text = _xl(256 * 1024)
    assert port.encode(text) == ref.encode(text)
    assert port.meta() == ref.meta()
    assert port.vocab_size == ref.vocab_size == 50257


# Every letter and number category, marks and a few others, beside
# snippets the split pattern treats specially.
_CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Nd", "Nl", "No", "Mn", "Mc",
               "Me", "Pc", "Pd", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Cc",
               "Cf")
_SNIPPETS = ("'s", "'S", "'t", "'re", "'ve", "'m", "'ll", "'d", "'D", " ",
             "  ", "\r\n", "\n\n", "\t", "　", "　　", "\xa0",
             "\x1c", "\x1f", "\x85", " ", "​", "᠎", "中文",
             "字", "😀", "👍🏽", "é", "²", "Ⅻ", "٣", " 12", "x²y",
             " the", " The")


@seed(15)
@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.one_of(
    st.characters(categories=_CATEGORIES),
    st.sampled_from(_SNIPPETS)), max_size=40).map("".join))
def test_bpe_ids_match_jax_on_unicode_text(toks, text):
    port, ref = toks
    assert port.encode(text) == ref.encode(text), repr(text)
    assert port.decode(port.encode(text)) == text


def test_bpe_decode_matches_jax(toks):
    """Random runs of ids, of single-byte tokens (most runs of random
    bytes are invalid UTF-8) and of both, decode to the same string."""
    port, ref = toks
    rng = np.random.default_rng(0)
    for i in range(300):
        n = int(rng.integers(1, 24))
        pool = (50257, 256, 50257)[i % 3]
        ids = rng.integers(0, pool, n).tolist()
        if i % 3 == 2:
            ids[::2] = rng.integers(0, 256, len(ids[::2])).tolist()
        assert port.decode(ids) == ref.decode(ids), ids


def _prepare(module, argv):
    module.main(argv)


@pytest.mark.parametrize("dataset", ["english_prose_char",
                                     "english_prose_bpe", "shakespeare_char",
                                     "openwebtext"])
def test_prepared_bins_match_jax(dataset, tmp_path):
    """The port's CLI writes the JAX CLI's bytes: train.bin, val.bin and
    meta.pkl, so a dataset prepared by either trains in both."""
    flags = [dataset]
    if dataset == "english_prose_bpe":
        src = tmp_path / "slice.txt"
        src.write_text(_xl(1 << 20), encoding="utf-8")
        flags.append(f"--source_file={src}")
    elif dataset in ("shakespeare_char", "openwebtext"):
        src = tmp_path / "input.txt"
        src.write_text(_xl(300_000), encoding="utf-8")
        flags += [f"--source_file={src}"]
        if dataset == "openwebtext":
            flags += ["--tokenizer=bpe", "--num_chars=200000"]
    for module, name in ((jprepare, "jax"), (tprepare, "port")):
        _prepare(module, flags + [f"--data_dir={tmp_path / name}"])
    for f in ("train.bin", "val.bin", "meta.pkl"):
        got = (tmp_path / "port" / dataset / f).read_bytes()
        want = (tmp_path / "jax" / dataset / f).read_bytes()
        assert got == want, (dataset, f)
    assert len(got) > 0


def test_synthetic_corpus_matches_jax():
    for n, s in ((200_000, 1337), (5000, 3)):
        assert (tprepare._synthetic_corpus(n, s)
                == jprepare._synthetic_corpus(n, s))


def _offline(monkeypatch):
    """The JAX package's network steps (the corpus fetch, the OpenWebText
    stream, tiktoken's gpt2 download) fail as they do offline, without
    reaching for the network."""
    import tiktoken

    def no_network(*a, **k):
        raise ConnectionError("offline")

    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    monkeypatch.setattr(jprepare, "download_openwebtext", no_network)
    monkeypatch.setattr(tiktoken, "get_encoding", no_network)


@pytest.mark.parametrize("argv,env", [
    (["shakespeare_char", "--no-allow_synthetic"], {}),
    (["openwebtext"], {}),
    (["openwebtext", "--tokenizer=gpt2"], {"DATASET_ALLOW_SYNTHETIC": "1"}),
    (["english_prose_bpe", "--source_file=/nonexistent/x.txt"], {}),
    (["openwebtext", "--tokenizer=nope", "--allow_synthetic"], {})])
def test_cli_offline_errors_match_jax(argv, env, monkeypatch, tmp_path):
    """Offline, each CLI refuses the same way: the same exception type,
    and the same message where the JAX package wrote it (the network
    libraries' own messages differ)."""
    _offline(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    errors = []
    for module, name in ((jprepare, "jax"), (tprepare, "port")):
        with pytest.raises(Exception) as info:
            _prepare(module, argv + [f"--data_dir={tmp_path / name}",
                                     "--num_chars=5000"])
        errors.append(info.value)
    assert type(errors[1]) is type(errors[0]), errors
    if not isinstance(errors[0], ConnectionError):
        assert str(errors[1]) == str(errors[0])


@pytest.mark.parametrize("argv", [
    ["shakespeare_char"],
    ["openwebtext", "--allow_synthetic", "--tokenizer=byte"],
    ["openwebtext", "--allow_synthetic", "--tokenizer=gpt2",
     "--allow_byte_fallback"]])
def test_cli_offline_fallbacks_match_jax(argv, monkeypatch, tmp_path, capfd):
    """Where the JAX package falls back offline (the synthetic corpus,
    the byte downgrade), the port writes the same bins and warns."""
    _offline(monkeypatch)
    for module, name in ((jprepare, "jax"), (tprepare, "port")):
        _prepare(module, argv + [f"--data_dir={tmp_path / name}",
                                 "--num_chars=20000"])
        assert "WARNING" in capfd.readouterr().err
    for f in ("train.bin", "val.bin", "meta.pkl"):
        assert ((tmp_path / "port" / argv[0] / f).read_bytes()
                == (tmp_path / "jax" / argv[0] / f).read_bytes()), f


def test_bpe_encodes_without_tokenizers_or_regex(toks):
    text = "It's a test — of the 3 tokenizers' fallback?  中文 😀\n"
    code = ("import sys\n"
            "for name in ('tokenizers', 'regex', 'tiktoken'):\n"
            "    sys.modules[name] = None\n"
            "from nanosandbox_tpu_torch.data.tokenizer import get_tokenizer\n"
            "tok = get_tokenizer('bpe')\n"
            f"print(tok.encode({text!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(toks[1].encode(text))


def test_chip_smoke_bpe_sha256_is_the_jax_prepare(tmp_path):
    """chip_smoke.py holds the port-prepared english_prose_bpe bins of
    the whole XL corpus to BPE_SHA256: they must be what the JAX
    package's prepare writes."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    jprepare.prepare_english_prose_bpe_dataset(
        str(tmp_path), source_file=os.path.join(REPO, chip_smoke.BPE_CORPUS))
    got = {name: hashlib.sha256((tmp_path / name).read_bytes()).hexdigest()
           for name in chip_smoke.BPE_SHA256}
    assert got == chip_smoke.BPE_SHA256
