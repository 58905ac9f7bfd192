"""Batch beam-search decoding CLI.

Counterpart of openasr_tpu/bin/infer.py with the same flags, model
reconstruction from the packaged configs (optional --config override),
n-best logging and `utt hyp` output lines, plus `--device {cuda,cpu}`.
It decodes with the attention beam of conv-transformer /
conv-ctc-transformer, from offline features (`--offline`, batches of
`--batch_frames` frames) or from wave manifests through the model's fbank
frontend (no `--offline`; `--batch_frames` is then a budget of samples, so
its default of 2000 gives each utterance a batch of its own).  The other
paths of the JAX CLI exit with the ROADMAP item that will port them.

  python -m openasr_torch.bin.infer --model_type conv-ctc-transformer \\
      --model_pkg last.pkg --vocab_path chars.txt --json_file test.json \\
      --output hyp.txt --add_blk
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from openasr_torch.config import Config, load_config
from openasr_torch.data.collate import FeatureCollate, WaveCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import ArkDataset, SpeechDataset
from openasr_torch.data.sampler import FrameBasedSampler, TimeBasedSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.utils.checkpoint import load_package

ATTENTION_BEAM_TYPES = ("conv_transformer", "conv_ctc_transformer")


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Decode with a trained model")
    parser.add_argument("--model_type", required=True)
    parser.add_argument("--model_pkg", required=True)
    parser.add_argument("--vocab_path", required=True)
    parser.add_argument("--json_file", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch_frames", type=int, default=2000)
    parser.add_argument("--nbest", type=int, default=5)
    parser.add_argument("--maxlen", type=int, default=80)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--label_type", type=str, default="tokens")
    parser.add_argument("--offline", action="store_true", default=False,
                        help="json manifests carry precomputed features")
    parser.add_argument("--add_blk", action="store_true", default=False)
    parser.add_argument("--split_token", action="store_true", default=False)
    parser.add_argument("--context_file", default=None,
                        help="hotword biasing (not ported yet)")
    parser.add_argument("--context_weight", type=float, default=2.0)
    parser.add_argument("--ctc_beam_device", action="store_true", default=False,
                        help="on-device CTC prefix beam (not ported yet)")
    parser.add_argument("--ctc_beam", type=int, default=0,
                        help="CTC prefix beam width (not ported yet)")
    parser.add_argument("--cutoff_top_n", type=int, default=40)
    parser.add_argument("--cutoff_logp", type=float, default=-20.0)
    parser.add_argument("--lm_pkg", type=str, default=None,
                        help="LM package for shallow fusion (not ported yet)")
    parser.add_argument("--lm_weight", type=float, default=0.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype of the model forward; beam "
                             "scoring stays float32 over the logits")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"),
                        help="run on the GPU (default) or, when asked, the CPU")
    return parser.parse_args(argv)


def check_ported(args) -> None:
    """Exit naming the ROADMAP item for every path this port lacks."""
    model_type = args.model_type.lower().replace("-", "_")
    if model_type not in ATTENTION_BEAM_TYPES:
        raise SystemExit(
            f"--model_type {args.model_type}: only conv-transformer and "
            "conv-ctc-transformer decode in the port so far; the other "
            "families are ROADMAP queue 1 items 9 (CIF), 13 (GRU-CTC, "
            "wav2vec, text) and 7 (CTC decoders for conv-ctc)"
        )
    if args.ctc_beam > 0 or args.ctc_beam_device:
        raise SystemExit(
            "--ctc_beam/--ctc_beam_device: the CTC prefix beams are ROADMAP "
            "queue 1 item 7 (ops/prefix_beam.py, ops/ctc_beam_device.py)"
        )
    if args.lm_pkg and args.lm_weight != 0.0:
        raise SystemExit(
            "--lm_pkg shallow fusion is ROADMAP queue 1 item 10 (LMs and fusion)"
        )
    if args.context_file:
        raise SystemExit(
            "--context_file hotword biasing is ROADMAP queue 1 item 7 "
            "(Aho-Corasick biasing in ops/beam_search.py)"
        )


def resolve_device(name: str) -> torch.device:
    """`cuda` unless the caller asked for the CPU; never a silent fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU"
        )
    return torch.device(name)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    if dtype == torch.float32:
        # full f32: cuDNN would otherwise run the ConvV2 convolutions in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    tokenizer = CharTokenizer(args.vocab_path, add_blk=args.add_blk)
    pkg = load_package(args.model_pkg)
    model_pkg = pkg["model"] if "model" in pkg else pkg

    configs = Config(model_pkg["configs"])
    if args.config:
        override = load_config(args.config)
        configs.override(override.get("model", override))
    configs.decoder["vocab_size"] = tokenizer.unit_num()
    # decoding is deterministic: drop SpecAug
    if configs.signal and "spec_aug" in configs.signal:
        del configs.signal["spec_aug"]

    model = get_model_class(args.model_type).create_model(
        configs, device=device, dtype=dtype
    )
    model.restore(model_pkg)

    ranges = {"feat_range": (1, 10**9), "label_range": (0, 10**9),
              "rate_in_out": (0, 10**9)}
    if args.offline:
        test_set = ArkDataset(args.json_file, **ranges)
        collate = FeatureCollate(tokenizer, False, label_type=args.label_type)
        sampler = FrameBasedSampler(test_set, args.batch_frames, 1)
    else:
        signal = configs.signal or {}
        test_set = SpeechDataset(args.json_file, **ranges)
        collate = WaveCollate(
            tokenizer, False, label_type=args.label_type,
            expected_rate=signal.get("sample_rate", 16000)
            if signal.get("feature_type") == "fbank" else None,
        )
        sampler = TimeBasedSampler(test_set, args.batch_frames, 1)
    loader = DataLoader(test_set, sampler, collate, num_workers=2)

    out_path = args.output.strip()
    if out_path == "-":
        fd = sys.stdout
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fd = open(out_path, "w", encoding="utf8")

    seen_buckets = set()
    tot_utt = 0
    try:
        for batch in loader:
            inputs, lengths = model.batch_inputs(batch)
            utts = batch["uttids"]
            bucket = tuple(np.shape(inputs))
            t_batch = time.time()
            pred_ids, len_dec, sc = model.batch_beam_decode(
                torch.from_numpy(inputs).to(device),
                torch.from_numpy(lengths).to(device),
                beam_size=args.nbest, max_decode_len=args.maxlen,
                empty_rows=model.has_empty_rows(lengths),
            )
            pred_ids = pred_ids.cpu().numpy()
            len_dec = len_dec.cpu().numpy()
            sc = sc.cpu().numpy()
            dt_batch = time.time() - t_batch
            if bucket not in seen_buckets:
                seen_buckets.add(bucket)
                logging.info("decode bucket %s: first batch %.2fs", bucket, dt_batch)
            else:
                logging.debug("decode bucket %s: %.3fs", bucket, dt_batch)

            for i, utt in enumerate(utts):
                msg = f"Results for {utt}:\n"
                for j, (pred, ln, score) in enumerate(
                    zip(pred_ids[i], len_dec[i], sc[i])
                ):
                    hyp = tokenizer.decode(
                        list(pred[: int(ln)]), split_token=args.split_token
                    )
                    msg += f"top{j + 1}: {hyp} score: {float(score):.10f}\n"
                    if j == 0:
                        fd.write(f"{utt} {hyp}\n")
                logging.info("\n%s", msg)
            tot_utt += len(utts)
    finally:
        if fd is not sys.stdout:
            fd.close()

    dt = time.time() - t_start
    logging.info(
        "Decoded %d utterances in %.2f min (%.2f s/utt)",
        tot_utt, dt / 60.0, dt / max(tot_utt, 1),
    )


if __name__ == "__main__":
    main()
