"""Tokenizers for the sentence-metadata datasets (a copy of
``skinjax/data/tokenize.py``, which cannot be imported without JAX: importing
``skinjax.data`` imports it).

The reference tokenizes LLM-generated sentences with HF ``AutoTokenizer``:
``padding='max_length'``, ``truncation=True``, ``max_length`` 256 (dataset
default) or 512, and for GPT-2 sets ``pad_token = eos_token`` with right
padding. These are pure-Python implementations of the two algorithms it uses,
BERT WordPiece (uncased) and GPT-2 byte-level BPE, read from the files HF
ships (``vocab.txt``; ``vocab.json`` + ``merges.txt``), so they need no
network. ``tests/test_torch_tokenize.py`` holds them to skinjax's on the same
vocabulary files.

GPT-2's pre-split pattern needs the ``regex`` package (for its Unicode
letter and number classes); without it the byte-level BPE tokenizer raises,
as skinjax's does. WordPiece needs only the standard library.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # GPT-2's split pattern needs \p{L}/\p{N} classes
    import regex as _regex
except ImportError:  # pragma: no cover - regex is in the image
    _regex = None


# ---------------------------------------------------------------------------
# BERT WordPiece (uncased)
# ---------------------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (matches BERT's
    # BasicTokenizer, which splits "$" or "`" even though unicode says So)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT-uncased tokenization: basic (clean, lowercase, strip accents,
    punctuation/CJK split) + greedy longest-match WordPiece.

    Matches ``transformers.BertTokenizer(vocab_file)`` with default flags
    (``do_lower_case=True``) — the configuration ``bert-base-uncased``
    resolves to in the reference (``skinLesionDatasetsWithBert.py:31``).
    """

    def __init__(self, vocab: Dict[str, int],
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.unk_token = unk_token
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab[unk_token]
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    # -- basic tokenization --------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokens(self, text: str) -> List[str]:
        text = self._clean(text)
        # CJK chars get surrounding spaces (rare in this corpus but part of
        # the algorithm)
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )
        tokens: List[str] = []
        for word in text.split():
            word = word.lower()
            # strip accents (NFD, drop Mn)
            word = "".join(
                ch for ch in unicodedata.normalize("NFD", word)
                if unicodedata.category(ch) != "Mn"
            )
            # split on punctuation
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # -- wordpiece ----------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokens(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        """[CLS] toks [SEP], truncated to max_length, padded with [PAD]."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = [self.cls_id] + ids[: max_length - 2] + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [self.pad_id] * pad, mask + [0] * pad

    def encode_batch(self, texts: Sequence[str],
                     max_length: int = 256) -> Dict[str, np.ndarray]:
        ids, masks = zip(*(self.encode(t, max_length) for t in texts))
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
        }


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_GPT2_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


class ByteLevelBPETokenizer:
    """GPT-2 tokenization: regex pre-split, byte→unicode remap, rank-greedy
    BPE merges. Matches ``transformers.GPT2Tokenizer(vocab_file,
    merges_file)``; like the reference, ``pad_token`` is set to
    ``eos_token`` with right padding, and encoding adds NO special tokens
    (plain ``tokenizer(text)`` semantics)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        if _regex is None:  # pragma: no cover
            raise RuntimeError("GPT-2 BPE needs the 'regex' module")
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_map = _bytes_to_unicode()
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.eos_id  # reference: pad_token = eos_token
        self.pat = _regex.compile(_GPT2_SPLIT)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.pat.findall(text):
            mapped = "".join(self.byte_map[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        ids = [self.vocab[t] for t in self.tokenize(text)][:max_length]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [self.pad_id] * pad, mask + [0] * pad

    def encode_batch(self, texts: Sequence[str],
                     max_length: int = 256) -> Dict[str, np.ndarray]:
        ids, masks = zip(*(self.encode(t, max_length) for t in texts))
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
        }


# ---------------------------------------------------------------------------
# loader matching the reference's model-name dispatch
# ---------------------------------------------------------------------------

def load_tokenizer(model_name: str, artifacts_dir: Optional[str] = None):
    """'bert-base-uncased' → WordPiece from ``<dir>/vocab.txt``;
    'gpt2' → byte-level BPE from ``<dir>/vocab.json`` + ``<dir>/merges.txt``.

    ``artifacts_dir`` defaults to ``$SKINJAX_TOKENIZERS/<model_name>`` so a
    one-time copy of the HF artifacts enables the sentence path offline
    (reference relies on the HF network cache instead)."""
    base = artifacts_dir or os.path.join(
        os.environ.get("SKINJAX_TOKENIZERS", "tokenizers"), model_name
    )
    if "gpt2" in model_name.lower():
        return ByteLevelBPETokenizer.from_files(
            os.path.join(base, "vocab.json"), os.path.join(base, "merges.txt")
        )
    return WordPieceTokenizer.from_vocab_file(os.path.join(base, "vocab.txt"))


def tokenize_sentences(sentences: Sequence[str], tokenizer,
                       max_length: int = 256) -> Dict[str, np.ndarray]:
    """Batch encode for ``TokenSource`` (input_ids/attention_mask int32,
    padding='max_length', truncation=True — the reference's call at
    ``skinLesionDatasetsWithBert.py:66-73``)."""
    return tokenizer.encode_batch(sentences, max_length=max_length)
