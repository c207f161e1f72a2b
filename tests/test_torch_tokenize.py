"""The port's vendored tokenizers (``skinjax_torch.data.tokenize``) and
``TokenSource`` against skinjax's, on vocabulary files written to
``tmp_path``: BERT WordPiece and GPT-2 byte-level BPE give the same ids and
masks at max_length 16 and 64 (padding, truncation, GPT-2's pad = eos);
``load_tokenizer`` dispatches by model name; ``TokenSource`` batches the
same arrays."""

import json
import os

import numpy as np
import pytest

from skinjax.data import pipeline as jpipe
from skinjax.data import tokenize as jtok
from skinjax_torch.data import pipeline as tpipe
from skinjax_torch.data import tokenize as ttok
from tests.xla_compile_cache import xla_compile_cache  # noqa: F401

SENTENCES = [
    "The patient, a 55-year-old male, presents a lesion on the left arm.",
    "Smoker: no. Drinks alcohol: yes. Fitzpatrick skin type III.",
    "História de câncer de pele na família — região: BRAZIL.",
    "Itches and bleeds; diameter 8mm, evolution over 2 years!",
    "",
    "EMPTY",
    "word " * 100,  # truncated at max_length
]


def _bert_vocab(d):
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = ["the", "patient", "a", "55", "year", "old", "male", "presents", "lesion", "##s",
             "on", "left", "arm", "smoke", "##r", "no", "drink", "alcohol", "yes", "fitz",
             "##pat", "##rick", "skin", "type", "iii", "historia", "de", "cancer", "pele", "na",
             "familia", "regiao", "brazil", "itch", "##es", "and", "bleed", "diameter", "8mm",
             "evolution", "over", "2", "years", "word", "empty", ",", ".", ":", ";", "-", "!",
             "—"]
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(specials + words))
    return path


def _gpt2_files(d):
    alphabet = list(ttok._bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("Ġ", "a"), ("h", "e"), ("i", "n"), ("r", "e"), ("o", "n"),
              ("Ġt", "he"), ("e", "s"), ("Ġ", "p"), ("a", "t"), ("i", "e"), ("n", "t"),
              ("Ġp", "at"), ("Ġpat", "ie"), ("Ġpatie", "nt"), ("l", "es"), ("Ġ", "les"),
              ("Ġles", "i"), ("Ġlesi", "on"), ("5", "5"), ("y", "e"), ("a", "r"),
              ("ye", "ar"), ("Ġ", "ye"), ("s", "k"), ("sk", "in"), ("Ġ", "sk"), ("Ġsk", "in"),
              ("w", "o"), ("r", "d"), ("wo", "rd"), ("Ġ", "wo"), ("Ġwo", "rd")]
    vocab_list = alphabet + ["".join(m) for m in merges] + ["<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(vocab_list))}
    os.makedirs(d, exist_ok=True)
    vf, mf = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    with open(vf, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(mf, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return vf, mf


def _same(got, want):
    assert set(got) == set(want) == {"input_ids", "attention_mask"}
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("max_length", [16, 64])
def test_wordpiece_matches_skinjax(tmp_path, max_length):
    vf = _bert_vocab(str(tmp_path))
    ours = ttok.WordPieceTokenizer.from_vocab_file(vf)
    ref = jtok.WordPieceTokenizer.from_vocab_file(vf)
    for s in SENTENCES:
        assert ours.tokenize(s) == ref.tokenize(s), s
    _same(ttok.tokenize_sentences(SENTENCES, ours, max_length),
          jtok.tokenize_sentences(SENTENCES, ref, max_length))
    got = ours.encode_batch(SENTENCES, max_length)
    assert got["input_ids"].shape == (len(SENTENCES), max_length)
    assert (got["input_ids"][:, 0] == ours.cls_id).all()


@pytest.mark.parametrize("max_length", [16, 64])
def test_byte_level_bpe_matches_skinjax(tmp_path, max_length):
    vf, mf = _gpt2_files(str(tmp_path))
    ours = ttok.ByteLevelBPETokenizer.from_files(vf, mf)
    ref = jtok.ByteLevelBPETokenizer.from_files(vf, mf)
    texts = SENTENCES + ["the patient skin 55year lesion word"]
    for s in texts:
        assert ours.tokenize(s) == ref.tokenize(s), s
    _same(ttok.tokenize_sentences(texts, ours, max_length),
          jtok.tokenize_sentences(texts, ref, max_length))
    assert ours.pad_id == ours.eos_id == ref.pad_id  # pad = eos, right padding


def test_load_tokenizer_dispatches_by_name(tmp_path, monkeypatch):
    """``bert*`` → WordPiece from ``<dir>/vocab.txt``; a name with ``gpt2``
    → byte-level BPE from ``vocab.json`` + ``merges.txt``; the directory
    defaults to ``$SKINJAX_TOKENIZERS/<name>``."""
    _bert_vocab(str(tmp_path / "bert-base-uncased"))
    _gpt2_files(str(tmp_path / "gpt2"))
    _gpt2_files(str(tmp_path / "distilgpt2"))
    monkeypatch.setenv("SKINJAX_TOKENIZERS", str(tmp_path))
    for name, cls in (("bert-base-uncased", ttok.WordPieceTokenizer),
                      ("gpt2", ttok.ByteLevelBPETokenizer),
                      ("distilgpt2", ttok.ByteLevelBPETokenizer)):
        ours, ref = ttok.load_tokenizer(name), jtok.load_tokenizer(name)
        assert type(ours) is cls and type(ref).__name__ == cls.__name__
        explicit = ttok.load_tokenizer(name, str(tmp_path / name))
        _same(explicit.encode_batch(SENTENCES[:4], 16), ref.encode_batch(SENTENCES[:4], 16))
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer("bert-base-uncased", str(tmp_path / "missing"))


def test_token_source_matches_skinjax(tmp_path):
    """``TokenSource`` over an image array: the same images, token dict and
    labels for the same index as skinjax's."""
    vf = _bert_vocab(str(tmp_path))
    enc = ttok.tokenize_sentences(SENTENCES, ttok.WordPieceTokenizer.from_vocab_file(vf), 16)
    rng = np.random.default_rng(0)
    n = len(SENTENCES)
    images = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, n)
    ours = tpipe.TokenSource(images, None, enc["input_ids"], enc["attention_mask"], labels)
    ref = jpipe.TokenSource(images, None, enc["input_ids"], enc["attention_mask"], labels)
    assert len(ours) == len(ref) == n
    idx = np.array([3, 0, 5])
    a, b = ours.batch(idx), ref.batch(idx)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])
    _same(a["metadata"], b["metadata"])
