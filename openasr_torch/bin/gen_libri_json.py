"""Build LibriSpeech json manifests from a corpus directory.

Counterpart of egs/libri/gen_json.py, with the same arguments and
output, importing nothing of the JAX package: every `<utt> <text>` line
of the `*.trans.txt` files whose `<utt>.flac` lies beside it becomes a
row with the flac's sample count (`data/audio.py:load_wave`), the text's
characters (spaces as `_`) and its words spelled as phones joined by `|`:

  python -m openasr_torch.bin.gen_libri_json LibriSpeech/train-clean-100 train.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from openasr_torch.data.audio import load_wave


def wave_duration(path: str) -> int:
    """valid sample count (the manifests' feat_length unit for wave input)"""
    _, data = load_wave(path)
    return int(len(data))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("corpus_dir", help="e.g. LibriSpeech/train-clean-100")
    p.add_argument("out_json")
    args = p.parse_args(argv)

    samples = []
    for trans in glob.glob(os.path.join(args.corpus_dir, "**", "*.trans.txt"), recursive=True):
        d = os.path.dirname(trans)
        with open(trans) as f:
            lines = f.readlines()
        for line in lines:
            utt, text = line.strip().split(" ", 1)
            path = os.path.join(d, utt + ".flac")
            if not os.path.exists(path):
                continue
            chars = " ".join("_" if c == " " else c for c in text.lower())
            phones = " | ".join(" ".join(word) for word in text.lower().split())
            samples.append({
                "uttid": utt,
                "feat": path,
                "feat_length": wave_duration(path),
                "tokens": chars,
                "token_length": len(chars.split()),
                "phones": phones,
                "phone_length": len(phones.split()),
            })
    with open(args.out_json, "w") as f:
        json.dump(samples, f)
    print(f"{len(samples)} utts -> {args.out_json}")


if __name__ == "__main__":
    main()
