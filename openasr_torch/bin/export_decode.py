"""Export a trained model's decode as an ahead-of-time serving artifact.

Counterpart of tools/export_decode.py, with the same flags:

  python -m openasr_torch.bin.export_decode --model_type conv-ctc-transformer \\
      --model_pkg exp/.../last.pkg --vocab_path data/chars.txt \\
      --out decode.zip --buckets 8x512,16x1024 --nbest 5 --maxlen 60

The artifact holds a `torch.export` program for each (batch, frames)
bucket and each of `--platforms` (cuda and cpu by default); serve it with
`openasr_torch.serving.ExportedDecoder`, with no model code.  `--streaming`
exports the streaming tick instead (`ExportedStreamer`, one program per
`--stream_batches` size), `--stream_beam N` the streaming prefix beam's
tick (`ExportedStreamBeam`).  The model is built on the card unless
`--device cpu` is given; `--device cuda` without a card raises.  A
platform's programs are traced on that platform's device, so exporting
for cuda needs a card.
"""

from __future__ import annotations

import argparse
import logging

import torch

from openasr_torch.bin.infer import load_lm, resolve_device
from openasr_torch.config import Config
from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
from openasr_torch.models import get_model_class
from openasr_torch.serving import export_beam_decode, export_stream_beam, export_streaming_step
from openasr_torch.utils.checkpoint import load_package


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_type", required=True)
    p.add_argument("--model_pkg", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--buckets", default="8x512,16x1024", help="comma list of BATCHxFRAMES")
    p.add_argument("--nbest", type=int, default=5)
    p.add_argument("--maxlen", type=int, default=60)
    p.add_argument("--add_blk", action="store_true", default=False)
    p.add_argument("--platforms", default="cuda,cpu")
    p.add_argument("--int8", action="store_true", default=False,
                   help="weight-only int8 artifact; pair with ExportedDecoder.prepare_params")
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="compute dtype baked into the exported program (beam scoring "
                        "stays float32)")
    p.add_argument("--ctc_device_beam", action="store_true", default=False,
                   help="CTC models: export the device prefix beam (kind 'ctc_beam') "
                        "instead of greedy + log-probs")
    p.add_argument("--context_file", default=None,
                   help="bake hotword biasing into the program (one phrase a line, "
                        "tokenized like transcripts)")
    p.add_argument("--context_weight", type=float, default=2.0)
    p.add_argument("--streaming", action="store_true", default=False,
                   help="export the streaming tick (ExportedStreamer)")
    p.add_argument("--stream_batches", default="1,8",
                   help="comma list of stream batch sizes (--streaming)")
    p.add_argument("--max_frames", type=int, default=5000,
                   help="positional-encoding capacity for --streaming / token-buffer "
                        "capacity for --stream_beam")
    p.add_argument("--lm_pkg", default=None,
                   help="LM package baked in for shallow fusion (attention beam, "
                        "--ctc_device_beam and --stream_beam); its weights stay an input")
    p.add_argument("--lm_weight", type=float, default=0.0)
    p.add_argument("--cutoff_top_n", type=int, default=40,
                   help="device-beam frame-candidate top-n, baked and recorded")
    p.add_argument("--cutoff_logp", type=float, default=-20.0,
                   help="device-beam frame-candidate log-prob floor, baked and recorded")
    p.add_argument("--stream_beam", type=int, default=0,
                   help="N>0: export the streaming prefix-beam tick (ExportedStreamBeam, "
                        "width N) at the model's chunk and vocabulary")
    p.add_argument("--stream_beam_batch", type=int, default=8,
                   help="stream batch size for --stream_beam")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = get_args(argv)
    if args.model_type.lower().replace("-", "_") in ("gru_ctc", "wav2vec_ctc"):
        raise SystemExit(
            f"--model_type {args.model_type}: the raw-wave families are not exported; the "
            "JAX package's export_beam_decode cannot export them either (it reads "
            "encoder.input_dim, which they do not set, and traces [B, T, input_dim] "
            "features, not waves)")
    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.compute_dtype]
    platforms = tuple(args.platforms.split(","))

    tokenizer = CharTokenizer(args.vocab_path, add_blk=args.add_blk)
    pkg = load_package(args.model_pkg)
    model_pkg = pkg["model"] if "model" in pkg else pkg
    configs = Config(model_pkg["configs"])
    configs.decoder["vocab_size"] = tokenizer.unit_num()
    if configs.signal and "spec_aug" in configs.signal:
        del configs.signal["spec_aug"]
    model = get_model_class(args.model_type).create_model(configs, device=device, dtype=dtype)
    model.restore(model_pkg)

    lm = None
    if args.lm_pkg and args.lm_weight != 0.0:
        lm = load_lm(args.lm_pkg, device)

    ctx_phrases = None
    if args.context_file:
        is_ctc = not hasattr(model, "batch_beam_decode")
        if is_ctc and not (args.ctc_device_beam or args.stream_beam > 0):
            raise SystemExit(
                "--context_file biasing for CTC models requires --ctc_device_beam or "
                "--stream_beam N (the kind 'ctc' greedy export has no biasing hook)")
        try:
            ctx_phrases = load_context_phrases(tokenizer, args.context_file)
        except ValueError as e:
            raise SystemExit(str(e))

    if args.stream_beam > 0:
        from openasr_torch.streaming import StreamingRecognizer

        # the model's own chunk, so the tick takes what a streaming-step
        # artifact emits each tick
        rec = StreamingRecognizer(model)
        export_stream_beam(
            args.out, batch=args.stream_beam_batch, beam=args.stream_beam, chunk=rec.chunk,
            max_frames=args.max_frames, vocab_size=tokenizer.unit_num(),
            blank=tokenizer.unit_num() - 1, platforms=platforms,
            cutoff_top_n=args.cutoff_top_n, cutoff_logp=args.cutoff_logp,
            lm=lm, lm_weight=args.lm_weight, context_phrases=ctx_phrases,
            context_weight=args.context_weight)
        print(f"exported streaming prefix-beam tick (batch={args.stream_beam_batch}, "
              f"beam={args.stream_beam}, chunk={rec.chunk}) -> {args.out}")
        return

    if args.streaming:
        sizes = [int(x) for x in args.stream_batches.split(",")]
        export_streaming_step(model, batch_sizes=sizes, path=args.out, platforms=platforms,
                              max_frames=args.max_frames)
        print(f"exported streaming step for batches {sizes} -> {args.out}")
        return

    buckets = [tuple(int(x) for x in spec.split("x")) for spec in args.buckets.split(",")]
    export_beam_decode(
        model, buckets=buckets, path=args.out, beam_size=args.nbest,
        max_decode_len=args.maxlen, platforms=platforms,
        weights="int8" if args.int8 else "float32", compute=args.compute_dtype,
        ctc_device_beam=args.ctc_device_beam, context_phrases=ctx_phrases,
        context_weight=args.context_weight, cutoff_top_n=args.cutoff_top_n,
        cutoff_logp=args.cutoff_logp, lm=lm, lm_weight=args.lm_weight)
    print(f"exported {len(buckets)} buckets -> {args.out}")


if __name__ == "__main__":
    main()
