"""Character tokenizer with the JAX package's vocabulary layout.

Counterpart of openasr_tpu/data/tokenizer.py: id 0 = <unk>, 1 = <sos>,
2 = <eos>, then one unit per vocab-file line (first whitespace-separated
field), and — with ``add_blk`` — a trailing <blk> as the LAST id, so the
CTC blank is always ``vocab_size - 1``.  `load_context_phrases` reads a
hotword file into the phrase table the biased beams take.
`SubwordTokenizer` decodes BPE units (CPC finetuning's vocabulary).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

UNK_SYM = "<unk>"
SOS_SYM = "<sos>"
EOS_SYM = "<eos>"
BLK_SYM = "<blk>"
UNK_ID = 0
SOS_ID = 1
EOS_ID = 2

SPECIAL_SYM_SET = {
    SOS_SYM,
    EOS_SYM,
    UNK_SYM,
    BLK_SYM,
    "[VOCALIZED-NOISE]",
    "[NOISE]",
    "[LAUGHTER]",
}


class CharTokenizer:
    """Whitespace-split character/unit tokenizer."""

    def __init__(self, vocab_path: str, add_blk: bool = False):
        units = [UNK_SYM, SOS_SYM, EOS_SYM]
        with open(vocab_path, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.strip().split()
                if fields:
                    units.append(fields[0])
        if add_blk:
            units.append(BLK_SYM)
        self.id2unit: List[str] = units
        self.unit2id = {u: i for i, u in enumerate(units)}
        self.add_blk = add_blk

    def encode(self, textline: str) -> List[int]:
        unk = self.unit2id[UNK_SYM]
        return [self.unit2id.get(tok, unk) for tok in textline.strip().split()]

    def decode(
        self,
        ids: Iterable[int],
        split_token: bool = True,
        remove_special_sym: bool = True,
    ) -> str:
        syms = [self.id2unit[int(i)] for i in ids]
        if remove_special_sym:
            syms = [s for s in syms if s not in SPECIAL_SYM_SET]
        return (" " if split_token else "").join(syms)

    def unit_num(self) -> int:
        return len(self.id2unit)


class SubwordTokenizer(CharTokenizer):
    """BPE subword units: decoding rejoins the '@@' continuations
    ('hel@@ lo' -> 'hello', also without `split_token`)."""

    def decode(
        self,
        ids: Iterable[int],
        split_token: bool = True,
        remove_special_sym: bool = True,
    ) -> str:
        text = super().decode(ids, split_token, remove_special_sym)
        return text.replace("@@ " if split_token else "@@", "")


def build_tokenizer(vocab_path: str, add_blk: bool = False, kind: str = "char"):
    """A `CharTokenizer` (`kind` "char") or a `SubwordTokenizer` ("subword"
    or "bpe")."""
    if kind == "char":
        return CharTokenizer(vocab_path, add_blk=add_blk)
    if kind in ("subword", "bpe"):
        return SubwordTokenizer(vocab_path, add_blk=add_blk)
    raise ValueError(f"Unknown tokenizer kind: {kind}")


def load_context_phrases(tokenizer: CharTokenizer, path: str) -> np.ndarray:
    """Hotword phrases for biased decoding, one a line (tokenized like
    transcripts), as an int32 [P, L] table padded with -1.

    A phrase with an out-of-vocabulary token is rejected: encoded as <unk>
    it would boost <unk> paths and never complete."""
    unk = tokenizer.unit2id[UNK_SYM]
    phrases = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            ids = tokenizer.encode(line)
            if not ids:
                continue
            if unk in ids:
                bad = [tok for tok in line.strip().split()
                       if tokenizer.unit2id.get(tok, unk) == unk]
                raise ValueError(
                    f"{path}:{lineno}: phrase {line.strip()!r} contains "
                    f"out-of-vocabulary token(s) {bad}: it would boost <unk> paths "
                    "and never match; fix the phrase or the vocabulary"
                )
            phrases.append(ids)
    if not phrases:
        raise ValueError(f"{path}: no usable context phrases")
    table = np.full((len(phrases), max(len(p) for p in phrases)), -1, np.int32)
    for i, p in enumerate(phrases):
        table[i, : len(p)] = p
    return table
