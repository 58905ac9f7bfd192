#!/usr/bin/env python3
"""Diagnostic for the port's recipe gate: the attention kernels against
their plain version on the gate's own path.

Run from egs/aishell1 after run_recipe_gate_torch.sh has prepared
data/gate (it reuses the corpus and the YAML):

    python diagnose_recipe_gate_torch.py [--device cuda]

It prints the largest layer-0 attention score of the gate model at its
initialization, then drives the gate's train CLI and infer CLI (bf16,
device CTC beam of 4) in process with `models.layers.flash_attention`
replaced by the attention's plain version, and scores the test set.  The
rest of the path (LayerNorm and fbank kernels, solver, decode) is the
script's.  This separates the attention kernels' backward from everything
else (ROADMAP queue 3 item 12); it is not a path of the port, which runs
every structured attention through its kernel on the card.
"""

import argparse
import contextlib
import copy
import io
import json
import os
import sys
import time

import torch
import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from openasr_torch.bin import infer, train, wer  # noqa: E402
from openasr_torch.data.tokenizer import CharTokenizer  # noqa: E402
from openasr_torch.kernels.flash_attention import flash_attention_reference  # noqa: E402
from openasr_torch.models import get_model_class, layers  # noqa: E402

CONFIG = "configs/conv-ctc-recipe-gate.yaml"
EXP = "exp/recipe_gate"


def layer0_score_max(cfg, device):
    """max |q k^T / sqrt(d)| of layer 0 on the first test utterances, at the
    train CLI's initialization (generator seeded 0)."""
    model_cfg = copy.deepcopy(cfg["model"])
    model_cfg["decoder"]["vocab_size"] = CharTokenizer(
        cfg["data"]["vocab_path"], add_blk=True).unit_num()
    model = get_model_class("conv-ctc").create_model(
        model_cfg, device=device, generator=torch.Generator().manual_seed(0))
    from openasr_torch.data.audio import load_wave

    with open("data/gate/test_wav.json") as f:
        rows = json.load(f)[:8]
    waves = [torch.from_numpy(load_wave(r["feat"])[1]) for r in rows]
    lengths = torch.tensor([len(w) for w in waves], dtype=torch.int32)
    batch = torch.zeros(len(waves), int(lengths.max()))
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    seen = []

    def spy(q, k, v, **kw):
        seen.append(float((torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                           / q.shape[-1] ** 0.5).abs().max()))
        return flash_attention_reference(q, k, v, **kw)

    layers.flash_attention = spy
    with torch.no_grad():
        model.module(batch.to(device), lengths.to(device))
    return seen[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    print(f"[diagnose] layer-0 attention scores at initialization: max "
          f"{layer0_score_max(cfg, args.device):.1f}", flush=True)
    layers.flash_attention = flash_attention_reference
    for name in os.listdir(EXP):
        if name.endswith(".pkg") or name == "metrics.jsonl":
            os.remove(os.path.join(EXP, name))
    t0 = time.time()
    train.main([CONFIG, "--device", args.device])
    t1 = time.time()
    hyp = os.path.join(EXP, "decode_gate", "hyp_plain_attention.txt")
    infer.main(["--model_type", "conv-ctc", "--model_pkg", os.path.join(EXP, "last.pkg"),
                "--vocab_path", "data/gate/train_chars.txt",
                "--json_file", "data/gate/test_wav.json", "--output", hyp,
                "--batch_frames", "1000000", "--ctc_beam", "4", "--ctc_beam_device",
                "--add_blk", "--split_token", "--dtype", "bfloat16", "--device", args.device])
    t2 = time.time()
    score = io.StringIO()
    with contextlib.redirect_stdout(score):
        wer.main(["--cer", "--hyp", hyp, "--ref", "data/gate/test_text.txt"])
    with open(os.path.join(EXP, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    epochs = [r for r in rows if r["phase"] == "epoch"]
    skips = max([r.get("nonfinite_skips", 0) for r in rows] + [0])
    print(f"[diagnose] plain attention: {score.getvalue().strip()}; {epochs[-1]['step']} steps, "
          f"{skips} rejected; train {t1 - t0:.2f}s, decode {t2 - t1:.2f}s wall; cv by epoch "
          f"{[round(r['cv_loss'], 4) for r in epochs]}", flush=True)


if __name__ == "__main__":
    main()
