"""Dataset preparation: corpus -> train.bin / val.bin / meta.pkl.

This package's own copy of nanosandbox_tpu/data/prepare.py, with the
same CLI,

    python -m nanosandbox_tpu_torch.data.prepare <dataset> [--data_dir=...]
        [--source_file=...] [--num_chars=N] [--tokenizer=gpt2|bpe|byte]
        [--allow_synthetic | --no-allow_synthetic] [--allow_byte_fallback]

(``DATA_DIR``, ``DATASET_NUM_CHARS`` and ``DATASET_ALLOW_SYNTHETIC`` as
defaults), the same 90/10 uint16 bins and the same ``meta.pkl``, byte
for byte: a dataset prepared by either package trains in both.

The two network steps, the tiny-shakespeare URL fetch and the streamed
OpenWebText download, are not ported: this package runs where there is
no network. Where the JAX package would try one, this one takes it as a
failed download and goes on as JAX does offline: the synthetic corpus
(with JAX's warning) when synthetic data is allowed, a ConnectionError
otherwise. The committed corpora (``english_prose_char``,
``english_prose_bpe``) and local ``--source_file`` text need no network.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np

from nanosandbox_tpu_torch.data.tokenizer import (_REPO_ROOT, ByteTokenizer,
                                                  CharTokenizer, get_tokenizer)

TINY_SHAKESPEARE_URL = (
    "https://raw.githubusercontent.com/karpathy/char-rnn/master/data/"
    "tinyshakespeare/input.txt"
)


def _warn_synthetic(what: str) -> None:
    print(f"WARNING: {what} unavailable — using a SYNTHETIC corpus. "
          "This is only valid for smoke tests; do not train real models "
          "on it. Pass allow_synthetic=False to fail instead.",
          file=sys.stderr)


def _no_download(what: str) -> None:
    """The port's stand-in for a network step: a failed download."""
    raise ConnectionError(
        f"{what}: downloads are not ported (this package runs without a "
        "network); pass --source_file with the corpus")


def _synthetic_corpus(n_chars: int = 200_000, seed: int = 1337) -> str:
    """Deterministic pseudo-text for offline smoke tests: the JAX
    package's, character for character."""
    rng = np.random.default_rng(seed)
    words = ["the", "and", "lord", "king", "thou", "hath", "speak", "good",
             "night", "come", "what", "shall", "more", "love", "death",
             "crown", "sword", "blood", "heart", "light"]
    parts: list[str] = []
    total = 0
    while total < n_chars:
        n = int(rng.integers(4, 12))
        sent = " ".join(words[int(i)] for i in rng.integers(0, len(words), n))
        sent = sent.capitalize() + ".\n"
        parts.append(sent)
        total += len(sent)
    return "".join(parts)[:n_chars]


def fetch_corpus(out_path: str, source_file: str | None = None,
                 allow_synthetic: bool = True) -> str:
    """The raw corpus text: local file > cached copy > synthetic (the
    download between them always fails here)."""
    if source_file and os.path.exists(source_file):
        with open(source_file, "r", encoding="utf-8") as f:
            return f.read()
    if os.path.exists(out_path):
        with open(out_path, "r", encoding="utf-8") as f:
            return f.read()
    what = f"download of {TINY_SHAKESPEARE_URL}"
    if not allow_synthetic:
        _no_download(what)
    _warn_synthetic(what)
    return _synthetic_corpus()


def write_bins(ids: np.ndarray, out_dir: str, meta: dict,
               val_fraction: float = 0.1) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    n = len(ids)
    split = int(n * (1 - val_fraction))
    train_ids = ids[:split].astype(np.uint16)
    val_ids = ids[split:].astype(np.uint16)
    train_ids.tofile(os.path.join(out_dir, "train.bin"))
    val_ids.tofile(os.path.join(out_dir, "val.bin"))
    with open(os.path.join(out_dir, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)
    return {"train_tokens": len(train_ids), "val_tokens": len(val_ids),
            "vocab_size": meta["vocab_size"]}


def _encode_bins(tok, text: str, out_dir: str) -> dict:
    """Encode text (printing the seconds: a corpus's BPE encode is host
    work of seconds) and write the bins."""
    t0 = time.monotonic()
    ids = np.asarray(tok.encode(text), dtype=np.uint16)
    print(f"encoded {out_dir}: {len(text):,} chars -> {len(ids):,} tokens "
          f"in {time.monotonic() - t0:.1f} s")
    return write_bins(ids, out_dir, tok.meta())


def prepare_char_dataset(out_dir: str, source_file: str | None = None,
                         allow_synthetic: bool = True) -> dict:
    """tiny-shakespeare char-level prep (a local source, a cached
    input.txt, or the synthetic corpus)."""
    text = fetch_corpus(os.path.join(out_dir, "input.txt"),
                        source_file=source_file,
                        allow_synthetic=allow_synthetic)
    return _encode_bins(CharTokenizer.from_text(text), text, out_dir)


REAL_FIXTURE = os.path.join(_REPO_ROOT, "data", "fixtures",
                            "english_prose.txt")
XL_FIXTURE = os.path.join(_REPO_ROOT, "data", "fixtures",
                          "english_prose_xl.txt")


def _prepare_fixture_dataset(out_dir: str, fixture: str, build_hint: str,
                             make_tokenizer, source_file: str | None) -> dict:
    """Shared prep of the committed real-text fixtures: the source
    (explicit file > fixture) or a loud failure with the build command,
    no synthetic fallback."""
    src = source_file or fixture
    if not os.path.exists(src):
        raise FileNotFoundError(
            f"{src} not found — run `{build_hint}` (or pass --source_file)")
    with open(src, "r", encoding="utf-8") as f:
        text = f.read()
    return _encode_bins(make_tokenizer(text), text, out_dir)


def prepare_english_prose_dataset(out_dir: str,
                                  source_file: str | None = None) -> dict:
    """Char-level prep of the committed real-text fixture
    (data/fixtures/english_prose.txt)."""
    return _prepare_fixture_dataset(
        out_dir, REAL_FIXTURE, "python scripts/make_real_corpus.py",
        CharTokenizer.from_text, source_file)


def prepare_english_prose_bpe_dataset(out_dir: str,
                                      source_file: str | None = None) -> dict:
    """The committed XL fixture (data/fixtures/english_prose_xl.txt)
    through the committed 50,257-entry byte-level BPE vocabulary."""
    return _prepare_fixture_dataset(
        out_dir, XL_FIXTURE,
        "python scripts/make_real_corpus.py --out "
        "data/fixtures/english_prose_xl.txt --max_mb 100 --profile xl",
        lambda _text: get_tokenizer("bpe"), source_file)


def prepare_bpe_dataset(out_dir: str, source_files: list[str] | None = None,
                        text: str | None = None, tokenizer: str = "gpt2",
                        num_chars: int | None = None,
                        allow_synthetic: bool = True,
                        allow_byte_fallback: bool = False) -> dict:
    """OpenWebText-style prep. Source order: explicit ``text`` >
    ``source_files`` > the OpenWebText download (always failed here) >
    synthetic (only when ``allow_synthetic``, with a warning); capped at
    ``num_chars``.
    A tokenizer that cannot be built ('gpt2' offline) fails unless
    ``allow_byte_fallback`` accepts vocab-256 byte bins, recorded in
    meta.pkl."""
    if text is None:
        chunks = []
        for p in source_files or []:
            with open(p, "r", encoding="utf-8") as f:
                chunks.append(f.read())
        text = "\n".join(chunks)
    if not text:
        if not allow_synthetic:
            _no_download("openwebtext download")
        _warn_synthetic("openwebtext download")
        text = _synthetic_corpus(n_chars=num_chars or 1_000_000)
    if num_chars:
        text = text[:num_chars]
    try:
        tok = get_tokenizer(tokenizer)
    except (RuntimeError, FileNotFoundError, ImportError) as e:
        if not allow_byte_fallback:
            raise RuntimeError(
                f"tokenizer {tokenizer!r} unavailable and byte fallback is "
                "opt-in (pass allow_byte_fallback=True / "
                "--allow_byte_fallback to accept vocab-256 bins)") from e
        print(f"WARNING: tokenizer {tokenizer!r} unavailable — downgrading "
              "to the vocab-256 BYTE tokenizer (allow_byte_fallback=True). "
              f"Cause: {e}", file=sys.stderr)
        tok = ByteTokenizer()
    return _encode_bins(tok, text, out_dir)


def main(argv: list[str] | None = None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description="prepare dataset bins")
    ap.add_argument("dataset", choices=["shakespeare_char", "openwebtext",
                                        "english_prose_char",
                                        "english_prose_bpe"])
    ap.add_argument("--data_dir", default=os.environ.get("DATA_DIR", "data"))
    ap.add_argument("--source_file", default=None)
    ap.add_argument("--num_chars", type=int, default=int(
        os.environ.get("DATASET_NUM_CHARS", "0")) or None)
    ap.add_argument("--tokenizer", default="gpt2")
    # shakespeare_char is the smoke-test dataset: synthetic fallback on by
    # default; openwebtext is a real training corpus and fails instead,
    # unless allowed. None falls through to DATASET_ALLOW_SYNTHETIC, then
    # the per-dataset default.
    ap.add_argument("--allow_synthetic", default=None,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--allow_byte_fallback", action="store_true",
                    help="accept a vocab-256 byte downgrade when the "
                         "requested BPE tokenizer is unavailable (off by "
                         "default: a silent downgrade invalidates runs "
                         "configured for a 50k vocab)")
    args = ap.parse_args(argv)
    allow_synth = args.allow_synthetic
    if allow_synth is None:
        env = os.environ.get("DATASET_ALLOW_SYNTHETIC", "")
        allow_synth = ((env == "1") if env
                       else args.dataset == "shakespeare_char")

    out_dir = os.path.join(args.data_dir, args.dataset)
    if args.dataset == "english_prose_char":
        stats = prepare_english_prose_dataset(out_dir,
                                              source_file=args.source_file)
    elif args.dataset == "english_prose_bpe":
        stats = prepare_english_prose_bpe_dataset(
            out_dir, source_file=args.source_file)
    elif args.dataset == "shakespeare_char":
        stats = prepare_char_dataset(out_dir, source_file=args.source_file,
                                     allow_synthetic=allow_synth)
    else:
        stats = prepare_bpe_dataset(
            out_dir,
            source_files=[args.source_file] if args.source_file else None,
            tokenizer=args.tokenizer, num_chars=args.num_chars,
            allow_synthetic=allow_synth,
            allow_byte_fallback=args.allow_byte_fallback)
    print(f"prepared {args.dataset} -> {out_dir}: {stats}")
    return stats


if __name__ == "__main__":
    main()
