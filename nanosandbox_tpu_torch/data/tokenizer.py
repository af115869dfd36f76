"""Tokenizers for the serving front end: char-level and byte-level.

This package's own copy of the char and byte tokenizers of
nanosandbox_tpu/data/tokenizer.py. The char vocabulary comes from the
dataset's ``meta.pkl`` (written by the JAX package's data.prepare), so
both packages encode a prompt to the same ids. The BPE kinds ('bpe',
'gpt2') are not ported yet and raise.
"""

from __future__ import annotations

import os
import pickle
from typing import Protocol


class Tokenizer(Protocol):
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class CharTokenizer:
    """Char-level tokenizer; vocabulary = sorted unique chars of the corpus."""

    def __init__(self, stoi: dict[str, int], itos: dict[int, str]):
        self.stoi = stoi
        self.itos = itos
        self.vocab_size = len(stoi)

    @classmethod
    def from_meta(cls, meta: dict) -> "CharTokenizer":
        return cls(meta["stoi"], meta["itos"])

    def encode(self, text: str) -> list[int]:
        return [self.stoi[c] for c in text]

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in ids)


class ByteTokenizer:
    """UTF-8 byte tokenizer, vocab 256."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        """UTF-8, with invalid sequences and ids outside [0, 256) as
        U+FFFD: a model whose head is wider than 256 (GPT-2's 50304
        trained on bytes) can sample such ids, and the JAX copy raises
        on them."""
        out, run = [], bytearray()
        for i in ids:
            i = int(i)
            if 0 <= i < 256:
                run.append(i)
            else:
                out.append(run.decode("utf-8", errors="replace") + "\ufffd")
                run = bytearray()
        out.append(run.decode("utf-8", errors="replace"))
        return "".join(out)


def get_tokenizer(kind: str, meta: dict | None = None) -> Tokenizer:
    if kind == "char":
        if meta is None:
            raise ValueError("char tokenizer needs meta.pkl contents")
        return CharTokenizer.from_meta(meta)
    if kind == "byte":
        return ByteTokenizer()
    if kind in ("bpe", "gpt2"):
        raise NotImplementedError(
            f"tokenizer kind {kind!r} is not ported yet (char and byte are)")
    raise ValueError(f"unknown tokenizer kind: {kind!r}")


def load_meta(data_dir: str, dataset: str) -> dict:
    """<data_dir>/<dataset>/meta.pkl, the prepared dataset's vocabulary
    (a file this project's own prepare step writes)."""
    path = os.path.join(data_dir, dataset, "meta.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)


def tokenizer_for_dataset(data_dir: str, dataset: str) -> Tokenizer:
    meta = load_meta(data_dir, dataset)
    return get_tokenizer(meta.get("kind", "char"), meta)
