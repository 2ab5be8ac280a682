"""CLIP byte-pair-encoding tokenizer; counterpart of
``univtg_tpu/extract/clip/tokenizer.py``.

The same token ids as the JAX package's tokenizer over the released
bpe_simple_vocab_16e6 merges (a copy under extract/assets/), with
``tokenize``'s SOT/EOT framing and truncation before EOT.

The JAX tokenizer splits words with the ``regex`` package's pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE. This module runs on the standard library alone (the
card's machine has no ``regex``), so ``_words`` scans for that pattern by
hand, with the alternatives tried in the same order at each position, as
``findall`` does:

  * ``\\p{L}`` and ``\\p{N}`` are the ``L*`` and ``N*`` categories of
    ``unicodedata`` (never ``[^\\W\\d_]``, which takes ``No`` and ``Nl`` such
    as ``²`` for letters);
  * ``\\s`` is ``str.isspace`` less ``\\x1c-\\x1f``, which the standard
    library counts as whitespace and ``regex`` does not (``_clean`` too);
  * IGNORECASE folds, among the characters that can reach the literals after
    ``_clean``'s ``lower()``, only U+017F (long s) onto ``s``; and it keeps
    U+0345 (a mark that folds to a Greek iota) out of the last class, so
    that no alternative takes it and ``findall`` skips it.

Held against the JAX tokenizer over every code point that Unicode 15.0
assigns (tests/test_torch_clip.py). ``regex``'s own Unicode tables are newer:
they differ from ``unicodedata``'s only on code points that 15.0 leaves
unassigned.
"""
from __future__ import annotations

import gzip
import html
import os
import re
import unicodedata
from typing import List, Union

import numpy as np

VOCAB_PATH = os.path.join(
    os.path.dirname(__file__), "..", "assets", "bpe_simple_vocab_16e6.txt.gz"
)

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_WHITESPACE_RE = re.compile(r"[^\S\x1c-\x1f]+")
_NOT_SPACE = "\x1c\x1d\x1e\x1f"
_MATCHES_NOTHING = "\u0345"


def _fold(c: str) -> str:
    """The character a literal of the word pattern compares ``c`` as
    (``regex``'s simple case folding, for the literals' letters)."""
    if c == "\u017f":
        return "s"
    return c.lower() if c.isascii() else c


def _kind(c: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, '' nothing, else 'O'."""
    cat = unicodedata.category(c)
    if cat[0] in "LN":
        return cat[0]
    if c.isspace() and c not in _NOT_SPACE:
        return "S"
    return "" if c == _MATCHES_NOTHING else "O"


def _literal_at(text: str, i: int, literal: str) -> bool:
    if len(text) - i < len(literal):
        return False
    return all(_fold(text[i + j]) == ch for j, ch in enumerate(literal))


def _words(text: str) -> List[str]:
    """``regex.findall`` of the word pattern (module docstring) over
    ``text``."""
    out = []
    i, n = 0, len(text)
    while i < n:
        literal = next((w for w in _SPECIALS + _CONTRACTIONS
                        if _literal_at(text, i, w)), None)
        if literal is not None:
            out.append(text[i:i + len(literal)])
            i += len(literal)
            continue
        kind = _kind(text[i])
        if kind == "N":
            out.append(text[i])
            i += 1
        elif kind in ("L", "O"):
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
            out.append(text[i:j])
            i = j
        else:  # whitespace, or the one character no alternative takes
            i += 1
    return out


def _byte_unicode_table():
    """Reversible byte <-> printable-unicode mapping (GPT-2 convention)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(printable, [chr(c) for c in chars]))


def _clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return _WHITESPACE_RE.sub(" ", text).strip().lower()


class BPETokenizer:
    def __init__(self, vocab_path: str = VOCAB_PATH):
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]

        byte_enc = _byte_unicode_table()
        self.byte_encoder = byte_enc
        vocab = list(byte_enc.values())
        vocab = vocab + [f"{v}</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(_SPECIALS)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank = {m: i for i, m in enumerate(merges)}
        self.cache = {s: s for s in _SPECIALS}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _words(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


_TOKENIZER = None


def get_tokenizer() -> BPETokenizer:
    global _TOKENIZER
    if _TOKENIZER is None:
        _TOKENIZER = BPETokenizer()
    return _TOKENIZER


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = 77,
    max_valid_length: int = 32,
) -> np.ndarray:
    """Texts -> (B, context_length) int32 with SOT/EOT framing; token runs
    longer than max_valid_length-2 are truncated before EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = tok.encode(text)[: max_valid_length - 2]
        row = [sot] + ids + [eot]
        out[i, : len(row)] = row
    return out
