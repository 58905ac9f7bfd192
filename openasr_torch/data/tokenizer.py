"""Character tokenizer with the JAX package's vocabulary layout.

Counterpart of openasr_tpu/data/tokenizer.py: id 0 = <unk>, 1 = <sos>,
2 = <eos>, then one unit per vocab-file line (first whitespace-separated
field), and — with ``add_blk`` — a trailing <blk> as the LAST id, so the
CTC blank is always ``vocab_size - 1``.
"""

from __future__ import annotations

from typing import Iterable, List

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
