"""Batch decoding CLI.

Counterpart of openasr_tpu/bin/infer.py with the same flags, model
reconstruction from the packaged configs (optional --config override),
n-best logging and `utt hyp` output lines, plus `--device {cuda,cpu}`.
From offline features (`--offline`, batches of `--batch_frames` frames) or
from wave manifests through the model's fbank frontend (no `--offline`;
`--batch_frames` is then a budget of samples, so its default of 2000 gives
each utterance a batch of its own), it decodes

  * conv-transformer / conv-ctc-transformer with the attention beam;
  * CIF / ctc_cif with the CIF beam (`--maxlen` steps, each a full
    forward of the CIF decoder, no EOS finishing; each hypothesis cut to
    its utterance's CIF length);
  * the CTC families, conv-ctc and (on wave manifests, through their
    WavConv) gru_ctc and wav2vec_ctc, greedily (`--ctc_beam 0`), with the
    native host prefix beam (`--ctc_beam N`), or with the prefix beam on
    the device (`--ctc_beam N --ctc_beam_device`);

and biases the attention or CIF beam or the device CTC beam toward the
phrases of `--context_file`.  `--lm_pkg` with `--lm_weight` != 0 fuses an
LM package (`lstm_lm` or `transformer_lm`, by the type it records; in f32
whatever `--dtype`) into the attention and CIF beams and the device CTC
beam (shallow fusion; a CTC model without `--ctc_beam N --ctc_beam_device`
exits, as the host decoders have no fusion hook).  The log-probs of the
CTC beams are the f32 log-softmax of the logits, also under `--dtype
bfloat16`.  The other model types exit; the text families name
`bin/infer_phone2char.py`.

  python -m openasr_torch.bin.infer --model_type conv-ctc \\
      --model_pkg last.pkg --vocab_path chars.txt --json_file test.json \\
      --output hyp.txt --offline --add_blk --ctc_beam 10 --ctc_beam_device \\
      [--lm_pkg lm/last.pkg --lm_weight 0.3]
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
from openasr_torch.data.tokenizer import CharTokenizer, load_context_phrases
from openasr_torch.models import get_model_class
from openasr_torch.models.lm import make_lm_step_spec
from openasr_torch.ops.ctc_beam_device import build_context_tables, ctc_prefix_beam_device
from openasr_torch.ops.prefix_beam import make_decoder
from openasr_torch.utils.checkpoint import load_package

ATTENTION_BEAM_TYPES = ("conv_transformer", "conv_ctc_transformer", "cif", "ctc_cif")
CTC_TYPES = ("conv_ctc", "gru_ctc", "wav2vec_ctc")
PORTED_TYPES = ATTENTION_BEAM_TYPES + CTC_TYPES


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
                        help="hotword biasing (Aho-Corasick): a text file with one "
                             "phrase per line, tokenized like transcripts; tokens "
                             "that advance a phrase's match earn --context_weight, "
                             "a broken match rolls back to its failure-link state. "
                             "Runs in the attention and CIF beams and in the device "
                             "CTC beam")
    parser.add_argument("--context_weight", type=float, default=2.0)
    parser.add_argument("--ctc_beam_device", action="store_true", default=False,
                        help="run the CTC prefix beam on the device instead of the "
                             "native host decoder")
    parser.add_argument("--ctc_beam", type=int, default=0,
                        help="CTC prefix beam width (conv-ctc; 0 = greedy)")
    parser.add_argument("--cutoff_top_n", type=int, default=40,
                        help="CTC beam frame cutoff: keep the top-n symbols of a "
                             "frame (blank always kept)")
    parser.add_argument("--cutoff_logp", type=float, default=-20.0,
                        help="CTC beam frame cutoff: the log-prob floor")
    parser.add_argument("--lm_pkg", type=str, default=None,
                        help="LM package for shallow fusion: scores become log p_am + "
                             "lm_weight * log p_lm (attention and CIF beams, and the "
                             "device CTC beam)")
    parser.add_argument("--lm_weight", type=float, default=0.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype of the model forward; beam "
                             "scoring stays float32 over the logits")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"),
                        help="run on the GPU (default) or, when asked, the CPU")
    return parser.parse_args(argv)


def is_ctc_type(model_type: str) -> bool:
    return model_type.lower().replace("-", "_") in CTC_TYPES


def check_ported(args) -> None:
    """Exit, before anything loads, on flags that would silently decode with
    another decoder than asked (the JAX CLI's own exits), and name the
    ROADMAP item for every path this port lacks."""
    is_ctc = is_ctc_type(args.model_type)
    if args.ctc_beam_device and not (is_ctc and args.ctc_beam > 0):
        raise SystemExit(
            "--ctc_beam_device needs a CTC model type AND --ctc_beam N > 0 (it "
            "selects the on-device prefix beam; without --ctc_beam the run would "
            "silently fall back to greedy)"
        )
    if args.context_file and is_ctc and not args.ctc_beam_device:
        raise SystemExit(
            "--context_file hotword biasing for CTC models runs in the on-device "
            "prefix beam: add --ctc_beam N --ctc_beam_device"
        )
    if args.model_type.lower().replace("-", "_") not in PORTED_TYPES:
        raise SystemExit(
            f"--model_type {args.model_type}: this CLI decodes conv-transformer, "
            "conv-ctc-transformer, conv-ctc, gru_ctc, wav2vec_ctc, CIF and ctc_cif "
            "(CIF_FC and CIF_MIX have no beam); the text families (Embed_Decoder, "
            "Embed_Decoder_CTC) decode through openasr_torch.bin.infer_phone2char"
        )
    if args.lm_pkg and args.lm_weight != 0.0 and is_ctc and not (
            args.ctc_beam > 0 and args.ctc_beam_device):
        raise SystemExit(
            "--lm_pkg shallow fusion with a CTC model needs the on-device prefix beam: "
            "add --ctc_beam N --ctc_beam_device (the host CTC decoders have no fusion hook)"
        )


def load_lm(path: str, device: torch.device):
    """The LM of a package (either package's), by the type it records."""
    lm_pkg = load_package(path)
    lm_pkg = lm_pkg["model"] if "model" in lm_pkg else lm_pkg
    lm_type = lm_pkg.get("model_type") or "lstm_lm"
    lm = get_model_class(lm_type).create_model(Config(lm_pkg["configs"]), device=device)
    lm.restore(lm_pkg)
    logging.info("Shallow fusion with %s (%s)", path, lm_type)
    return lm


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

    is_ctc = is_ctc_type(args.model_type)
    blank = tokenizer.unit_num() - 1
    # the hotword automaton, built once for every batch (the attention beam
    # and the device CTC beam run the same one)
    ctx_tables = None
    if args.context_file:
        try:
            phrases = load_context_phrases(tokenizer, args.context_file)
        except ValueError as e:
            raise SystemExit(str(e))
        ctx_tables = build_context_tables(phrases, tokenizer.unit_num())
        logging.info("hotword biasing: %d phrases, weight %.2f",
                     phrases.shape[0], args.context_weight)
    lm = lm_spec = None
    if args.lm_pkg and args.lm_weight != 0.0:
        lm = load_lm(args.lm_pkg, device)
        lm_spec = make_lm_step_spec(lm)
    host_decoder = None
    if is_ctc and args.ctc_beam > 0 and not args.ctc_beam_device:
        host_decoder = make_decoder(beam_width=args.ctc_beam, blank_id=blank,
                                    cutoff_top_n=args.cutoff_top_n,
                                    cutoff_logp=args.cutoff_logp)

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

    def decode(inputs, lengths, empty_rows):
        """-> per utterance, its n-best token rows, lengths and scores."""
        if not is_ctc:
            preds, lens, scores = (t.cpu().numpy() for t in model.batch_beam_decode(
                inputs, lengths, beam_size=args.nbest, max_decode_len=args.maxlen,
                empty_rows=empty_rows, context_tables=ctx_tables,
                context_weight=args.context_weight, lm=lm, lm_weight=args.lm_weight))
            return preds, lens, scores
        if args.ctc_beam == 0:
            ids, idlens = (t.cpu().numpy() for t in model.greedy_decode(
                inputs, lengths, empty_rows))
            return ids[:, None], idlens[:, None], np.zeros((len(ids), 1), np.float32)
        logits, len_logits = model.get_logits(inputs, lengths, empty_rows)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        if host_decoder is not None:
            nbest = host_decoder.decode_batch(log_probs.cpu().numpy(),
                                              len_logits.cpu().numpy())
            return ([[h.tokens for h in n] for n in nbest],
                    [[len(h.tokens) for h in n] for n in nbest],
                    [[h.score for h in n] for n in nbest])
        lm_kw = {}
        if lm_spec is not None:
            # at most one LM token a frame, after the <sos>
            lm_kw = {"lm_step_fn": lm_spec["step_fn"], "lm_weight": args.lm_weight,
                     "init_lm_cache": lm_spec["init_cache_fn"](
                         log_probs.shape[0] * args.ctc_beam, log_probs.shape[1] + 1)}
        toks, tlens, sc = (t.cpu().numpy() for t in ctc_prefix_beam_device(
            log_probs, len_logits, blank=blank, beam=args.ctc_beam,
            cutoff_top_n=args.cutoff_top_n, cutoff_logp=args.cutoff_logp,
            context_tables=ctx_tables, context_weight=args.context_weight, **lm_kw))
        # drop never-populated sentinel rows (fewer live prefixes than the
        # beam width), which the host decoders never emit
        live = sc > -1e29
        return ([toks[i][live[i]] for i in range(len(toks))],
                [tlens[i][live[i]] for i in range(len(toks))],
                [sc[i][live[i]] for i in range(len(toks))])

    seen_buckets = set()
    tot_utt = 0
    try:
        for batch in loader:
            inputs, lengths = model.batch_inputs(batch)
            utts = batch["uttids"]
            bucket = tuple(np.shape(inputs))
            t_batch = time.time()
            preds, lens, scores = decode(
                torch.from_numpy(inputs).to(device), torch.from_numpy(lengths).to(device),
                model.has_empty_rows(lengths))
            dt_batch = time.time() - t_batch
            if bucket not in seen_buckets:
                seen_buckets.add(bucket)
                logging.info("decode bucket %s: first batch %.2fs", bucket, dt_batch)
            else:
                logging.debug("decode bucket %s: %.3fs", bucket, dt_batch)

            for i, utt in enumerate(utts):
                msg = f"Results for {utt}:\n"
                for j, (pred, ln, score) in enumerate(zip(preds[i], lens[i], scores[i])):
                    hyp = tokenizer.decode(
                        list(np.asarray(pred)[: int(ln)]), split_token=args.split_token
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
