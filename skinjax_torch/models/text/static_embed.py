"""model2vec static-embedding ingestion (counterpart of
``skinjax/models/text/static_embed.py``): the PubMedBERT-embeddings path.

The reference encodes its sentence datasets with a model2vec ``StaticModel``:
tokenize, look each token id up in a static table, mean-pool, and (per the
artifact's ``config.json``) L2-normalize. This module reads the artifact's
files as skinjax does:

  ``model.safetensors``  the table (key ``embeddings``, ``embedding`` or
                         ``weight``, or the file's one 2-D tensor), read by
                         ``read_safetensors``, a numpy reader of the format
                         (the card's machine has no ``safetensors`` package);
                         else ``embeddings.npy``
  ``tokenizer.json``     the HF tokenizer, through the ``tokenizers`` package,
                         imported when such a file is read; where it is
                         missing an ImportError names the ``vocab.txt`` route
  ``vocab.txt``          else a WordPiece vocabulary, through the port's
                         ``data/tokenize.py``
  ``config.json``        ``{"normalize": ...}``

The (B, E) sentence vectors feed ``StaticEmbeddingTower``
(``models/text/__init__.py``). Everything here is numpy on the host.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np

# the format's dtype names → numpy; BF16 is widened to float32 (numpy has none)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_, "U16": np.uint16, "U32": np.uint32, "U64": np.uint64}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array: an 8-byte
    little-endian header length, a JSON header ``{name: {"dtype", "shape",
    "data_offsets": [begin, end]}}`` (offsets into the bytes after the
    header; ``__metadata__`` is skipped), then the raw little-endian tensors.
    BF16 tensors come back as float32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw, shape = data[begin:end], tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        else:
            dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
            out[name] = np.frombuffer(raw, dtype=dt).reshape(shape).astype(dt.newbyteorder("="))
    return out


class StaticSentenceEncoder:
    """Token-embedding mean-pooler over a static table. ``tokenize_ids(text)``
    returns a list of int ids; ids outside the table are dropped, rows are
    mean-pooled (no ids → zeros) and, with ``normalize``, L2-normalized."""

    def __init__(self, embeddings: np.ndarray, tokenize_ids, normalize: bool = False):
        self.embeddings = np.asarray(embeddings, np.float32)
        self._tokenize_ids = tokenize_ids
        self.normalize = bool(normalize)

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ids = [j for j in self._tokenize_ids(t) if 0 <= j < len(self.embeddings)]
            if ids:
                v = self.embeddings[ids].mean(axis=0)
                if self.normalize:
                    n = np.linalg.norm(v)
                    if n > 0:
                        v = v / n
                out[i] = v
        return out


def _load_embeddings(path: str) -> np.ndarray:
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        tensors = read_safetensors(st)
        for key in ("embeddings", "embedding", "weight"):
            if key in tensors:
                return tensors[key]
        mats = [v for v in tensors.values() if v.ndim == 2]
        if len(mats) == 1:
            return mats[0]
        raise ValueError(f"no embeddings tensor in {st} (keys: {list(tensors)})")
    npy = os.path.join(path, "embeddings.npy")
    if os.path.exists(npy):
        return np.load(npy)
    raise FileNotFoundError(f"no model.safetensors / embeddings.npy under {path}")


def _load_tokenize_ids(path: str):
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f"{tj} needs the 'tokenizers' package, which is not installed; give the "
                "artifact a WordPiece vocab.txt instead of tokenizer.json (the port reads it "
                "with skinjax_torch.data.tokenize)") from e
        tok = Tokenizer.from_file(tj)
        return lambda text: tok.encode(text, add_special_tokens=False).ids
    vt = os.path.join(path, "vocab.txt")
    if os.path.exists(vt):
        from skinjax_torch.data.tokenize import WordPieceTokenizer

        wp = WordPieceTokenizer.from_vocab_file(vt)
        unk = wp.unk_id
        return lambda text: [wp.vocab.get(t, unk) for t in wp.tokenize(text)]
    raise FileNotFoundError(f"no tokenizer.json / vocab.txt under {path}")


def load_model2vec(path: str, normalize: Optional[bool] = None) -> StaticSentenceEncoder:
    """A model2vec artifact directory as a ``StaticSentenceEncoder``;
    ``normalize`` defaults to the artifact's ``config.json``, else False."""
    if normalize is None:
        cfg = os.path.join(path, "config.json")
        normalize = False
        if os.path.exists(cfg):
            with open(cfg) as f:
                normalize = bool(json.load(f).get("normalize", False))
    return StaticSentenceEncoder(_load_embeddings(path), _load_tokenize_ids(path),
                                 normalize=normalize)


def encode_sentences(sentences: Sequence[str], model_dir: str) -> np.ndarray:
    """Raw sentences → (B, E) float32 with the artifact under ``model_dir``."""
    return load_model2vec(model_dir).encode(sentences)

