"""WER / CER scorer over `utt hyp...` and `utt ref...` files.

Counterpart of tools/wer.py, with the same flags and output, importing
nothing of the JAX package:

  python -m openasr_torch.bin.wer --cer --hyp hyp.txt --ref text.txt

With --cer, CJK strings split into characters while tokens holding Latin
letters or digits stay whole; --ignore drops comma-separated tokens.
"""

from __future__ import annotations

import argparse
import re

from openasr_torch.utils.metrics import wer


def split_chars(text: str, char_level: bool) -> list:
    """Tokens of `text`; with char_level, CJK tokens split into characters."""
    tokens = []
    for tok in text.split():
        if char_level and not re.findall("[a-zA-Z0-9]", tok):
            tokens.extend(list(tok))
        else:
            tokens.append(tok)
    return tokens


def read_trn(path: str, char_level: bool, ignore: set) -> dict:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            fields = line.strip().split(maxsplit=1)
            if not fields:
                continue
            text = fields[1] if len(fields) > 1 else ""
            out[fields[0]] = [t for t in split_chars(text, char_level) if t not in ignore]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hyp", required=True)
    parser.add_argument("--ref", required=True)
    parser.add_argument("--cer", action="store_true",
                        help="character-level (CJK-aware) scoring")
    parser.add_argument("--ignore", default="",
                        help="comma-separated tokens to ignore")
    args = parser.parse_args(argv)

    ignore = set(t for t in args.ignore.split(",") if t)
    hyps = read_trn(args.hyp, args.cer, ignore)
    refs = read_trn(args.ref, args.cer, ignore)

    common = [u for u in refs if u in hyps]
    missing = len(refs) - len(common)
    if missing:
        print(f"WARNING: {missing} reference utts missing from hyp")

    stats = wer([refs[u] for u in common], [hyps[u] for u in common])
    name = "CER" if args.cer else "WER"
    print(
        f"{name} {stats['wer']:.2f} | Sub {stats['sub']:.2f} "
        f"Del {stats['del']:.2f} Ins {stats['ins']:.2f} | "
        f"{len(common)} snt / {stats['n_ref']} wrd"
    )


if __name__ == "__main__":
    main()
