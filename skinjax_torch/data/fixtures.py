"""A PAD-UFES-20-shaped dataset on disk, made from a seed: the 26 columns of
the published ``metadata.csv`` and one PNG per row under ``images/``.

The rows carry the quirks of the real file that the schema has to handle:
blank cells in the boolean and the float columns (so ``fitspatrick`` is a
float column), the strings " ", "  ", "NÃO  ENCONTRADO" and "BRASIL", "UNK"
answers, pandas' other missing-value strings ("NA", "NaN"), and several
images per patient. Images are uint8 noise with a per-class brightness, so a
model can learn something; ``paeth=True`` writes each row Paeth-filtered,
the costly case for the stdlib PNG reader. ``sentences=True`` adds the
sentence datasets' ``sentence`` column (a clinical sentence made from the
row's cells), and ``write_wordpiece_vocab`` writes a ``vocab.txt`` that
covers its words, for the BERT tokenizer. ``write_model2vec`` writes a
model2vec artifact (a static embedding table, its ``vocab.txt`` and
``config.json``).
"""

from __future__ import annotations

import csv
import json
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from skinjax_torch.serve import png

PAD20_COLUMNS = (
    "patient_id", "lesion_id", "smoke", "drink", "background_father", "background_mother",
    "age", "pesticide", "gender", "skin_cancer_history", "cancer_history", "has_piped_water",
    "has_sewage_system", "fitspatrick", "region", "diameter_1", "diameter_2", "diagnostic",
    "itch", "grew", "hurt", "changed", "bleed", "elevation", "img_id", "biopsed",
)
PAD20_CLASSES = ("ACK", "BCC", "MEL", "NEV", "SCC", "SEK")
_ORIGINS = ("POMERANIA", "GERMANY", "ITALY", "BRAZIL", "BRASIL", "NETHERLANDS", "POLAND",
            "UNK", " ", "NÃO  ENCONTRADO")
_REGIONS = ("FACE", "NOSE", "ARM", "FOREARM", "BACK", "CHEST", "NECK", "HAND", "SCALP", "EAR")


def pad_ufes20_table(n: int, seed: int = 0) -> Dict[str, List[str]]:
    """Raw CSV cells (strings, "" for a blank) of n rows, column by column."""
    rng = np.random.default_rng(seed)
    pick = lambda options, p_blank=0.0: [  # noqa: E731
        "" if rng.random() < p_blank else str(options[rng.integers(len(options))])
        for _ in range(n)]
    patients = rng.integers(0, max(2, n // 3), n)
    labels = np.arange(n) % len(PAD20_CLASSES)
    lesions = rng.integers(1, 3000, n)
    return {
        "patient_id": [f"PAT_{p}" for p in patients],
        "lesion_id": [str(x) for x in lesions],
        "smoke": pick(("True", "False"), 0.3),
        "drink": pick(("True", "False", "NA"), 0.3),
        "background_father": pick(_ORIGINS, 0.3),
        "background_mother": pick(_ORIGINS + ("  ",), 0.3),
        "age": [str(x) for x in rng.integers(6, 94, n)],
        "pesticide": pick(("True", "False"), 0.3),
        "gender": pick(("FEMALE", "MALE"), 0.3),
        "skin_cancer_history": pick(("True", "False"), 0.3),
        "cancer_history": pick(("True", "False", "NaN"), 0.3),
        "has_piped_water": pick(("True", "False"), 0.3),
        "has_sewage_system": pick(("True", "False"), 0.3),
        "fitspatrick": pick(("1.0", "2.0", "3.0", "4.0", "5.0", "6.0"), 0.3),
        "region": pick(_REGIONS),
        "diameter_1": pick(("4.0", "6.0", "8.5", "10.0", "15.0", "20.0", "12"), 0.3),
        "diameter_2": pick(("3.0", "5.0", "7.5", "9.0", "11.0"), 0.3),
        "diagnostic": [PAD20_CLASSES[i] for i in labels],
        "itch": pick(("True", "False", "UNK")),
        "grew": pick(("True", "False", "UNK")),
        "hurt": pick(("True", "False", "UNK")),
        "changed": pick(("True", "False", "UNK")),
        "bleed": pick(("True", "False", "UNK")),
        "elevation": pick(("True", "False", "UNK")),
        "img_id": [f"PAT_{p}_{les}_{i}.png" for i, (p, les) in enumerate(zip(patients, lesions))],
        "biopsed": pick(("True", "False")),
    }


def row_sentences(table: Dict[str, List[str]]) -> List[str]:
    """One clinical sentence per row, from its cells."""
    return [f"A {age} year old {gender or 'UNK'} patient has a lesion on the {region}; "
            f"itch: {itch}, bleeding: {bleed}, grew: {grew}."
            for age, gender, region, itch, bleed, grew in zip(
                table["age"], table["gender"], table["region"], table["itch"], table["bleed"],
                table["grew"])]


def write_wordpiece_vocab(path: str, texts: List[str]) -> int:
    """A BERT ``vocab.txt`` ([PAD], [UNK], [CLS], [SEP], [MASK], the texts'
    lower-cased words and punctuation, and a few ``##`` pieces); returns its size."""
    from skinjax_torch.data.tokenize import WordPieceTokenizer

    basic = WordPieceTokenizer({t: i for i, t in enumerate(("[PAD]", "[UNK]", "[CLS]",
                                                            "[SEP]"))})
    words = sorted({w for t in texts for w in basic._basic_tokens(t)})
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words, "##s", "##ing", "##ed"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return len(vocab)


def write_csv(path: str, table: Dict[str, List[str]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = list(table)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(zip(*(table[c] for c in cols)))


def write_pad_ufes20_like(root: str, n: int = 96, image_hw: Tuple[int, int] = (300, 400),
                          seed: int = 0, paeth: bool = True,
                          sentences: bool = False) -> Tuple[str, str]:
    """Write ``root/metadata.csv`` (with a ``sentence`` column when asked)
    and ``root/images/<img_id>``; returns both paths."""
    table = pad_ufes20_table(n, seed)
    if sentences:
        table["sentence"] = row_sentences(table)
    csv_path = os.path.join(root, "metadata.csv")
    write_csv(csv_path, table)
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    for name, diag in zip(table["img_id"], table["diagnostic"]):
        img = rng.integers(0, 200, (*image_hw, 3), dtype=np.uint8)
        img += np.uint8(10 * PAD20_CLASSES.index(diag))
        with open(os.path.join(images_dir, name), "wb") as f:
            f.write(png.encode_png(img, paeth=paeth))
    return csv_path, images_dir


def write_model2vec(path: str, embeddings: np.ndarray, vocab: Sequence[str],
                    normalize: bool = True) -> None:
    """Write a model2vec artifact (``model.safetensors`` with one F32
    ``embeddings`` tensor, ``vocab.txt``, ``config.json``), as a model2vec
    export lays it out, for ``models.text.static_embed.load_model2vec``."""
    os.makedirs(path, exist_ok=True)
    emb = np.ascontiguousarray(embeddings, dtype="<f4")
    header = json.dumps({"embeddings": {"dtype": "F32", "shape": list(emb.shape),
                                        "data_offsets": [0, emb.nbytes]}}).encode()
    header += b" " * (-len(header) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + emb.tobytes())
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"normalize": bool(normalize)}, f)
