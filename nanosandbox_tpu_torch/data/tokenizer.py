"""Tokenizers: char-level, byte-level and the committed byte-level BPE.

This package's own copy of nanosandbox_tpu/data/tokenizer.py. The char
vocabulary comes from the dataset's ``meta.pkl`` (written by either
package's data.prepare), so both packages encode a prompt to the same
ids.

The 'bpe' kind (``LocalBPETokenizer``) reads the committed
``data/fixtures/bpe_english_prose/tokenizer.json`` with ``json`` and
runs in the standard library: GPT-2's ByteLevel pre-tokenizer (its
split pattern, with the Unicode classes \\p{L}, \\p{N} and \\s built from
``unicodedata``), the byte<->unicode map, and the merges applied by
rank. It gives the JAX package's HF-``tokenizers`` ids id for id and its
decode (UTF-8, invalid sequences as U+FFFD) string for string. The
'gpt2' kind needs a download (tiktoken's encoding or a vendored HF
file) and raises.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import sys
import unicodedata
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
    def from_text(cls, text: str) -> "CharTokenizer":
        chars = sorted(set(text))
        stoi = {ch: i for i, ch in enumerate(chars)}
        itos = {i: ch for i, ch in enumerate(chars)}
        return cls(stoi, itos)

    @classmethod
    def from_meta(cls, meta: dict) -> "CharTokenizer":
        return cls(meta["stoi"], meta["itos"])

    def encode(self, text: str) -> list[int]:
        return [self.stoi[c] for c in text]

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in ids)

    def meta(self) -> dict:
        return {"vocab_size": self.vocab_size, "stoi": self.stoi,
                "itos": self.itos, "kind": "char"}


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

    def meta(self) -> dict:
        return {"vocab_size": self.vocab_size, "kind": "byte"}


_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BPE_ASSET = "data/fixtures/bpe_english_prose/tokenizer.json"

# Unicode's White_Space property: what the reference's regex engine takes
# for \s. Python's \s differs (it adds U+001C-U+001F).
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003"
                "\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


def _char_class(keep) -> str:
    """The body of a regex character class holding every code point c
    with keep(c), as escaped ranges."""
    out, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if keep(chr(cp)):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            out.append(f"\\U{start:08x}-\\U{prev:08x}")
            start = None
    if start is not None:
        out.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(out)


def _split_pattern() -> re.Pattern:
    """GPT-2's pre-tokenizer pattern, ``'s|'t|'re|'ve|'m|'ll|'d|
    ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, with \\p{L}
    the general categories L*, \\p{N} the N* (``[^\\W\\d_]`` would admit
    No/Nl characters such as '²' and 'Ⅻ') and \\s White_Space."""
    letter = _char_class(lambda c: unicodedata.category(c)[0] == "L")
    number = _char_class(lambda c: unicodedata.category(c)[0] == "N")
    space = "".join(f"\\U{ord(c):08x}" for c in _WHITE_SPACE)
    return re.compile(
        f"'s|'t|'re|'ve|'m|'ll|'d| ?[{letter}]+| ?[{number}]+"
        f"| ?[^{space}{letter}{number}]+|[{space}]+(?![^{space}])"
        f"|[{space}]+")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class LocalBPETokenizer:
    """Byte-level BPE from the committed vocab asset (the JAX package's
    LocalBPETokenizer, same meta), in the standard library.

    encode: the text splits into pre-tokens by ``_split_pattern``; each
    pre-token's UTF-8 bytes map to characters (``bytes_to_unicode``),
    and the lowest-ranked adjacent pair merges until none is in the
    merge table. A pre-token's ids are cached on the instance, so a
    corpus costs one BPE per distinct word. decode: the ids' strings
    joined, mapped back to bytes, UTF-8 with errors replaced; ids
    outside the vocabulary (a padded head's) are skipped, as HF's decode
    skips them."""

    def __init__(self, asset: str | None = None):
        rel = asset or DEFAULT_BPE_ASSET
        path = rel if os.path.isabs(rel) else os.path.join(_REPO_ROOT, rel)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"BPE vocab asset {path} not found — run `python "
                "scripts/make_bpe_vocab.py` (after building the xl corpus) "
                "or pass the asset path")
        self.asset = rel
        with open(path, encoding="utf-8") as f:
            model = json.load(f)["model"]
        self.vocab: dict[str, int] = model["vocab"]
        self.vocab_size = len(self.vocab)
        self.itos = {i: s for s, i in self.vocab.items()}
        self.ranks = {tuple(m.split(" ") if isinstance(m, str) else m): r
                      for r, m in enumerate(model["merges"])}
        self.byte_char = bytes_to_unicode()
        self.char_byte = {c: b for b, c in self.byte_char.items()}
        self.pattern = _split_pattern()
        self.cache: dict[str, tuple[int, ...]] = {}

    def _bpe(self, word: str) -> tuple[int, ...]:
        parts = [self.byte_char[b] for b in word.encode("utf-8")]
        ranks = self.ranks
        while len(parts) > 1:
            best, at = None, -1
            for i in range(len(parts) - 1):
                r = ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            pair = (parts[at], parts[at + 1])
            merged, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == pair[0]
                        and parts[i + 1] == pair[1]):
                    merged.append(pair[0] + pair[1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(self.vocab[p] for p in parts)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        cache = self.cache
        for word in self.pattern.findall(text):
            got = cache.get(word)
            if got is None:
                got = cache[word] = self._bpe(word)
            ids.extend(got)
        return ids

    def decode(self, ids) -> str:
        itos, char_byte = self.itos, self.char_byte
        text = "".join(itos.get(int(i), "") for i in ids)
        return bytes(char_byte[c] for c in text).decode("utf-8",
                                                        errors="replace")

    def meta(self) -> dict:
        return {"vocab_size": self.vocab_size, "kind": "bpe",
                "asset": self.asset}


def get_tokenizer(kind: str, meta: dict | None = None) -> Tokenizer:
    if kind == "char":
        if meta is None:
            raise ValueError("char tokenizer needs meta.pkl contents")
        return CharTokenizer.from_meta(meta)
    if kind == "byte":
        return ByteTokenizer()
    if kind == "bpe":
        return LocalBPETokenizer((meta or {}).get("asset"))
    if kind == "gpt2":
        raise RuntimeError(
            "the 'gpt2' tokenizer needs tiktoken's gpt2 encoding or a "
            "vendored HF tokenizer.json, both a download away; use the "
            "committed offline 'bpe' vocabulary instead")
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
