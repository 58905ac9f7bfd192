"""Generate a tiny synthetic corpus for the smoke recipes and the recipe gate.

Counterpart of tools/gen_mini_corpus.py, importing nothing of the JAX
package: for the same arguments and seed it writes byte-identical files,
through the port's `data.kaldi_io.write_ark_scp` and `data.audio.write_wav`.

Features carry a per-token activation pattern and the labels follow it;
`--phones_per_char 2` doubles each token's phone, so that the
phone->char CLIs' datasets keep the pairs (at least 2 phones a
character; with 1, the default, they keep none); in `--wave` mode each token is a tone segment of its own frequency in
16 kHz PCM16 wavs.

  python -m openasr_torch.bin.gen_mini_corpus --out data/mini
  python -m openasr_torch.bin.gen_mini_corpus --out data/gate --wave --num_utts 256
  python -m openasr_torch.bin.gen_mini_corpus --out data/p2c --phones_per_char 2

Outputs under --out: feats.ark/.scp, train.json, dev.json, test.json,
chars.txt, phones.txt, test_text.txt (the scoring reference),
phones_unpaired.txt, text_unpaired.txt; with --wave: wav/*.wav,
train_wav.json, dev_wav.json, test_wav.json, train_chars.txt and
test_text.txt.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from openasr_torch.data import kaldi_io
from openasr_torch.data.audio import write_wav

CHARS = ["a", "b", "c", "d"]
PHONES = ["p1", "p2", "p3", "p4"]


def _dump(out: str, name: str, rows) -> None:
    with open(os.path.join(out, name), "w") as f:
        json.dump(rows, f)


def _write_text(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def gen_wave_corpus(out: str, num_utts: int, seed: int) -> None:
    """16 kHz PCM16 wavs whose tokens are tone segments (300 + 200 k Hz)
    with 15 ms gaps between them, and the wave manifests (feat = wav path,
    feat_length = samples)."""
    rng = np.random.RandomState(seed)
    rate = 16000
    wav_dir = os.path.join(out, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    _write_text(os.path.join(out, "train_chars.txt"), "\n".join(CHARS) + "\n")
    samples, text_lines = [], []
    seg = 1200  # samples per token segment
    # the silence between tokens: without it two equal tokens in a row are
    # one long tone, which CTC cannot split
    gap = 240
    for i in range(num_utts):
        n_tok = rng.randint(2, 5)
        toks = rng.randint(0, len(CHARS), size=n_tok)
        n = (seg + gap) * n_tok + rng.randint(0, seg // 2)
        t_axis = np.arange(n) / rate
        wave = 60.0 * rng.randn(n)
        for j, tok in enumerate(toks):
            f0 = 300.0 + 200.0 * tok
            sl = slice(j * (seg + gap), j * (seg + gap) + seg)
            wave[sl] += 4000.0 * np.sin(2 * np.pi * f0 * t_axis[sl])
        key = f"utt{i:03d}"
        path = os.path.join(wav_dir, key + ".wav")
        write_wav(path, rate, wave)
        tokens = " ".join(CHARS[k] for k in toks)
        samples.append({
            "uttid": key, "feat": path, "feat_length": int(n),
            "tokens": tokens, "token_length": int(n_tok),
        })
        text_lines.append(f"{key} {tokens}")

    n_small = max(num_utts // 2, 2)
    _dump(out, "train_wav.json", samples)
    _dump(out, "dev_wav.json", samples[:n_small])
    _dump(out, "test_wav.json", samples[:n_small])
    _write_text(os.path.join(out, "test_text.txt"), "\n".join(text_lines[:n_small]) + "\n")
    print(f"mini wave corpus: {num_utts} utts -> {out}")


def gen_feature_corpus(out: str, num_utts: int, feat_dim: int, seed: int,
                       phones_per_char: int = 1) -> None:
    """Kaldi ark features with an 8-frame block of ones per token in the
    token's 4 feature columns, and the manifests, vocabularies and texts;
    each token's phone written `phones_per_char` times."""
    rng = np.random.RandomState(seed)
    _write_text(os.path.join(out, "chars.txt"), "\n".join(CHARS) + "\n")
    _write_text(os.path.join(out, "phones.txt"), "\n".join(PHONES) + "\n")

    mats, samples, text_lines = [], [], []
    for i in range(num_utts):
        n_tok = rng.randint(2, 5)
        toks = rng.randint(0, len(CHARS), size=n_tok)
        t = 24 + 8 * n_tok + rng.randint(0, 8)
        feat = rng.randn(t, feat_dim).astype(np.float32) * 0.1
        for j, tok in enumerate(toks):
            feat[j * 8: j * 8 + 8, tok * 4: tok * 4 + 4] += 1.0
        key = f"utt{i:03d}"
        mats.append((key, feat))
        tokens = " ".join(CHARS[k] for k in toks)
        phones = " ".join(PHONES[k] for k in toks for _ in range(phones_per_char))
        samples.append({
            "uttid": key,
            "feat_length": int(t),
            "tokens": tokens,
            "token_length": int(n_tok),
            "phones": phones,
            "phone_length": int(n_tok) * phones_per_char,
        })
        text_lines.append(f"{key} {tokens}")

    prefix = os.path.join(out, "feats")
    kaldi_io.write_ark_scp(prefix, mats)
    with open(prefix + ".scp") as f:
        scp = dict(line.strip().split(" ", 1) for line in f)
    for s in samples:
        s["feat"] = scp[s["uttid"]]

    n_small = max(num_utts // 2, 2)
    _dump(out, "train.json", samples)
    _dump(out, "dev.json", samples[:n_small])
    _dump(out, "test.json", samples[:n_small])
    _write_text(os.path.join(out, "test_text.txt"), "\n".join(text_lines[:n_small]) + "\n")
    _write_text(os.path.join(out, "phones_unpaired.txt"),
                "\n".join(f"{s['uttid']} {s['phones']}" for s in samples) + "\n")
    _write_text(os.path.join(out, "text_unpaired.txt"),
                "\n".join(f"{s['uttid']} {s['tokens']}" for s in samples) + "\n")
    print(f"mini corpus: {num_utts} utts -> {out}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--num_utts", type=int, default=16)
    parser.add_argument("--feat_dim", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wave", action="store_true",
                        help="write 16 kHz wavs and wave manifests")
    parser.add_argument("--phones_per_char", type=int, default=1,
                        help="each token's phone this many times: 2 gives pairs that "
                             "the phone->char datasets keep (at least 2 phones a "
                             "character); the default is tools/gen_mini_corpus.py's")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.wave:
        gen_wave_corpus(args.out, args.num_utts, args.seed)
    else:
        gen_feature_corpus(args.out, args.num_utts, args.feat_dim, args.seed,
                           args.phones_per_char)


if __name__ == "__main__":
    main()
