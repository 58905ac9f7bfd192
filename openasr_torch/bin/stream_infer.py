"""Streaming decoding CLI: chunk-incremental recognition with partials.

Counterpart of openasr_tpu/bin/stream_infer.py, with its flags and its
exits, plus `--device {cuda,cpu}` (the card unless the CPU is asked for).
It drives the streaming executor (openasr_torch/streaming.py) over a test
manifest as a live service would: the audio (or, with `--offline`, the
features) arrives in fixed chunks, each chunk's partial hypotheses come
from CTC greedy or, with `--partial_beam N`, from the device prefix beam
carried across chunks (which also takes `--lm_pkg` fusion and
`--context_file` hotwords), and `--rescore` runs the attention beam over
the streamed encoder states (two-pass).  It logs the median step latency
a chunk (host wall clock, the first batch left out).

The model must be trained with `encoder.streaming`; a package without it
exits with the executor's error.

  python -m openasr_torch.bin.stream_infer --model_type conv-ctc-transformer \\
      --model_pkg last.pkg --vocab_path chars.txt --json_file test.json \\
      --output hyp.txt --offline --add_blk [--partial_beam 10 \\
      --lm_pkg lm/last.pkg --lm_weight 0.3 --context_file hot.txt] [--rescore]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from openasr_torch.bin.infer import load_lm, resolve_device
from openasr_torch.config import Config, load_config
from openasr_torch.data.collate import FeatureCollate, WaveCollate, quantize
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import ArkDataset, SpeechDataset
from openasr_torch.data.sampler import CountBatchSampler
from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
from openasr_torch.models import get_model_class
from openasr_torch.models.lm import make_lm_step_spec
from openasr_torch.ops.ctc_beam_device import build_context_tables
from openasr_torch.streaming import StreamingRecognizer
from openasr_torch.utils.checkpoint import load_package


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Streaming (chunk-incremental) decoding")
    parser.add_argument("--model_type", required=True)
    parser.add_argument("--model_pkg", required=True)
    parser.add_argument("--vocab_path", required=True)
    parser.add_argument("--json_file", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="parallel streams per device step")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--label_type", type=str, default="tokens")
    parser.add_argument("--offline", action="store_true", default=False,
                        help="json manifests carry precomputed features "
                             "(streamed 4*chunk frames at a time)")
    parser.add_argument("--add_blk", action="store_true", default=False)
    parser.add_argument("--split_token", action="store_true", default=False)
    parser.add_argument("--show_partials", action="store_true", default=False,
                        help="log partial hypotheses after every chunk")
    parser.add_argument("--partial_beam", type=int, default=0,
                        help="N>0: prefix-beam partials, the device beam's state "
                             "carried across chunks (the one-shot prefix beam over "
                             "all frames so far); 0 = greedy")
    parser.add_argument("--lm_pkg", type=str, default=None,
                        help="LM package for shallow fusion in the streaming prefix "
                             "beam (needs --partial_beam N): the LM cache carries "
                             "across chunks like the rest of the beam state")
    parser.add_argument("--lm_weight", type=float, default=0.0)
    parser.add_argument("--context_file", default=None,
                        help="hotword biasing in the streaming prefix beam (needs "
                             "--partial_beam N): one phrase per line, Aho-Corasick "
                             "matched, counters carry across chunks")
    parser.add_argument("--context_weight", type=float, default=2.0)
    parser.add_argument("--rescore", action="store_true", default=False,
                        help="final attention beam pass over the streamed encoder "
                             "states (two-pass streaming; needs a decoder-bearing model)")
    parser.add_argument("--nbest", type=int, default=5, help="beam size for --rescore")
    parser.add_argument("--maxlen", type=int, default=80)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default) or, when asked, the CPU")
    return parser.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    if dtype == torch.float32:
        # full f32: cuDNN would otherwise run the ConvV2 convolutions in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    tokenizer = CharTokenizer(args.vocab_path, add_blk=args.add_blk)
    pkg = load_package(args.model_pkg)
    model_pkg = pkg["model"] if "model" in pkg else pkg
    configs = Config(model_pkg["configs"])
    if args.config:
        override = load_config(args.config)
        configs.override(override.get("model", override))
    configs.decoder["vocab_size"] = tokenizer.unit_num()
    if configs.signal and "spec_aug" in configs.signal:
        del configs.signal["spec_aug"]

    model = get_model_class(args.model_type).create_model(configs, device=device, dtype=dtype)
    model.restore(model_pkg)
    rec = StreamingRecognizer(model)
    if args.rescore and not hasattr(model, "beam_decode_encoded"):
        raise SystemExit(f"--rescore needs an attention decoder; {args.model_type} has none")
    if rec.head is None and not args.rescore:
        raise SystemExit(
            f"{args.model_type} has no CTC head for streaming partials; "
            "pass --rescore to decode with the final attention pass"
        )
    unit = rec.chunk_feats if rec.offline else rec.chunk_samples
    logging.info("streaming: chunk=%d encoder frames (%d %s/step), left_chunks=%d",
                 rec.chunk, unit, "feature frames" if rec.offline else "samples", rec.left)

    ranges = {"feat_range": (1, 10**9), "label_range": (0, 10**9), "rate_in_out": (0, 10**9)}
    if args.offline:
        test_set = ArkDataset(args.json_file, **ranges)
        collate = FeatureCollate(tokenizer, False, label_type=args.label_type)
    else:
        test_set = SpeechDataset(args.json_file, **ranges)
        collate = WaveCollate(tokenizer, False, label_type=args.label_type,
                              expected_rate=(configs.signal or {}).get("sample_rate", 16000))
    sampler = CountBatchSampler(len(test_set), args.batch_size, shuffle=False)
    loader = DataLoader(test_set, sampler, collate, num_workers=2)

    out_path = args.output.strip()
    if out_path == "-":
        fd = sys.stdout
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fd = open(out_path, "w", encoding="utf8")

    # fusion and biasing ride the streaming prefix beam only: the greedy
    # and rescore paths have no carried fusion state, so they exit rather
    # than decode unfused or unbiased
    lm_fusion = None
    if args.lm_pkg and args.lm_weight != 0.0:
        if args.partial_beam <= 0:
            raise SystemExit(
                "--lm_pkg shallow fusion in streaming decoding needs "
                "--partial_beam N > 0 (the beam carries the LM cache "
                "across chunks; greedy partials have no fusion hook)"
            )
        lm_fusion = dict(make_lm_step_spec(load_lm(args.lm_pkg, device)),
                         weight=args.lm_weight)
        logging.info("streaming shallow fusion with %s (weight %.2f)", args.lm_pkg,
                     args.lm_weight)
    context_tables = None
    if args.context_file:
        if args.partial_beam <= 0:
            raise SystemExit(
                "--context_file hotword biasing in streaming decoding "
                "needs --partial_beam N > 0 (the beam carries the "
                "phrase-match counters across chunks)"
            )
        try:
            phrases = load_context_phrases(tokenizer, args.context_file)
        except ValueError as e:
            raise SystemExit(str(e))
        context_tables = build_context_tables(phrases, tokenizer.unit_num())
        logging.info("streaming hotword biasing: %d phrases, weight %.2f",
                     phrases.shape[0], args.context_weight)

    tot_utt = 0
    chunk_times = []
    t0 = time.time()
    try:
        for batch in loader:
            inputs, lengths = model.batch_inputs(batch)
            utts = batch["uttids"]

            def on_partial(n, hyps, utts=utts):
                if args.show_partials:
                    for u, h in zip(utts, hyps):
                        logging.info("partial[%d] %s: %s", n, u,
                                     tokenizer.decode(h, args.split_token))

            t_first = time.time()
            hyps, enc, enc_lens = rec.decode_waves(
                inputs, lengths, on_partial=on_partial, partial_beam=args.partial_beam,
                lm_fusion=lm_fusion, context_tables=context_tables,
                context_weight=args.context_weight)
            # decode_waves runs ceil(padded width / unit) steps (the
            # collate's quantized width can pass the longest length)
            n_chunks = -(-inputs.shape[1] // unit)
            if tot_utt > 0:  # the first batch warms up; it is left out
                chunk_times.append((time.time() - t_first) / max(n_chunks, 1))

            if args.rescore:
                # the batch and time padded up to buckets, as the JAX CLI
                # does; pad rows decode with length 1 and are sliced off
                b_now, e_now = enc.shape[0], enc.shape[1]
                bb, eb = args.batch_size, quantize(e_now)
                enc = torch.nn.functional.pad(enc, (0, 0, 0, eb - e_now, 0, bb - b_now))
                enc_lens = torch.nn.functional.pad(enc_lens, (0, bb - b_now), value=1)
                preds, lens_dec, _ = model.beam_decode_encoded(
                    enc.to(model.module.encoder.compute_dtype), enc_lens,
                    beam_size=args.nbest, max_decode_len=args.maxlen)
                preds, lens_dec = preds.cpu().numpy(), lens_dec.cpu().numpy()
                final = [list(preds[i][0][: int(lens_dec[i][0])]) for i in range(len(utts))]
            else:
                final = hyps
            for u, h in zip(utts, final):
                fd.write(f"{u} {tokenizer.decode(list(h), args.split_token)}\n")
            tot_utt += len(utts)
    finally:
        if fd is not sys.stdout:
            fd.close()

    dt = time.time() - t0
    if chunk_times:
        ms = 1000.0 * float(np.median(chunk_times))
        chunk_s = (rec.chunk_feats / 100.0 if rec.offline
                   else rec.chunk_samples / float(rec.fbank_cfg.sample_rate))
        logging.info(
            "median step latency %.1f ms per %.0f ms chunk "
            "(streaming RTF %.4f, host wall-clock excl. first batch); "
            "%d utts in %.1fs",
            ms, 1000.0 * chunk_s, ms / 1000.0 / chunk_s, tot_utt, dt,
        )


if __name__ == "__main__":
    main()
