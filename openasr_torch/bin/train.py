"""Supervised ASR training CLI.

Counterpart of openasr_tpu/bin/train.py on one device, with the same YAML
schema (data / model / training), model-type dispatch, `--continue-training`
(restore exp_dir/last.pkg) and `training.pretrained_model` warm start (the
output layers stay fresh, init_lr * 0.1).  It trains conv-ctc-transformer,
conv-transformer, conv-ctc, CIF and ctc_cif on offline features
(`signal.feature_type: offline`, batches of `training.batch_frames`
frames) or on raw waves through the fbank frontend (`feature_type:
fbank`, batches of `training.batch_time` samples), the raw-wave
wav2vec_ctc and gru_ctc (`feature_type: wave`, batches of
`training.batch_time` samples, no sample-rate check), and the phone-level
CIF_FC and CIF_MIX on offline features with phone targets (`vocab_phone`,
else `vocab_path`, tokenizes them; CIF_MIX adds paired char targets and
zips `data.acousticset`'s acoustic batches beside them), on the card by
default, `--device cpu` on the CPU; without a card `--device cuda`
raises.
`training.compute_dtype: bfloat16` runs the forward in bf16 over f32
weights.  `--distributed` trains data-parallel over the ranks that
torchrun starts (`parallel.init_distributed`: NCCL with one card a rank,
gloo with `--device cpu`), as the JAX CLI's `--distributed` spans hosts:
every rank builds the batch plan of the global budget (the config's times
the data size, divisible by it) and loads its rows, and the result is the
one-process run's on the global batches.  `--model-parallel M` (with
`--distributed`) lays the ranks out as a grid of world / M data rows of M
model ranks (rank = d * M + m, as `make_mesh`): tensor parallelism over
each model group, with sequence parallelism unless
`training.sequence_parallel: false`, every rank of a model group loading
its data row's rows (parallel/tensor_parallel.py).  `--pipeline S` (with
`--distributed` and `encoder.pipeline: true`, the stacked layer layout)
adds the pipe axis, outermost: S stages of world / S ranks (rank = p D M +
d M + m), each holding L / S of the encoder's layers, GPipe over
`training.pipeline_microbatch` microbatches (parallel/pipeline.py), every
rank of a pipe group loading its data row's rows.  The JAX CLI runs its
model and pipe axes over one process's devices; here a rank is a card, so
M > 1 or S > 1 needs torchrun.  The text families exit naming
`bin/train_phone2char.py` and `bin/semi_train_phone2char.py`.

  python -m openasr_torch.bin.train egs/aishell1/configs/conv-ctc-transformer.yaml
  python -m torch.distributed.run --nproc-per-node 2 -m openasr_torch.bin.train \
      <config> --distributed [--model-parallel 2 | --pipeline 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.config import load_config, parse_range, validate_config
from openasr_torch.data.collate import (
    FeatPhoneCharCollate,
    FeatPhoneCollate,
    FeatureCollate,
    WaveCollate,
)
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import ArkDataset, SpeechDataset
from openasr_torch.data.sampler import FrameBasedSampler, TimeBasedSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.parallel import Grid, init_distributed
from openasr_torch.parallel.mesh import destroy
from openasr_torch.solvers import DTYPES, get_solver_class
from openasr_torch.utils.checkpoint import load_package

REQUIRED = (
    "data.trainset", "data.devset", "data.vocab_path", "model.type",
    "training.exp_dir", "training.num_epoch", "training.init_lr",
    "training.optimtype", "training.lr_scheduler.type",
)


def setup_logging():
    level = os.environ.get("LAS_LOG_LEVEL", "INFO")
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(message)s",
    )


PHONE_TYPES = ("cif_fc", "cif_mix")
# trained by bin/train_phone2char.py and bin/semi_train_phone2char.py
TEXT_TYPES = ("embed_decoder", "embed_decoder_ctc", "gan_phone2char")


def _norm_type(modelconfig) -> str:
    return str(modelconfig["type"]).lower().replace("-", "_")


def build_loaders(dataconfig, trainingconfig, modelconfig, tokenizer, tokenizer_phone=None,
                  ndata=1, rank=0, world=1):
    """Train loader (batches shuffled per epoch) and dev loader (longest
    utterances first): offline features packed by cumulative frames, or
    waves packed by cumulative samples and checked against the signal's
    sample rate.  CIF_FC batches features and phones, CIF_MIX features,
    phones and chars.  The budget is the config's times `ndata` (the data
    axis), the batches divisible by it; rank `rank` of `world` loads its
    rows of each."""
    feat_range = parse_range(dataconfig.get("feat_range")) or (1, 99999)
    label_range = parse_range(dataconfig.get("label_range")) or (1, 100)
    label_type = trainingconfig.get("label_type", "tokens")
    workers = int(dataconfig.get("fetchworker_num", 2))
    add_eos = modelconfig.get("add_eos", False)
    signal = modelconfig.get("signal") or {}
    mtype = _norm_type(modelconfig)
    if mtype in PHONE_TYPES:
        dataset, sampler = ArkDataset, FrameBasedSampler
        budget = int(trainingconfig["batch_frames"])
        collate = (FeatPhoneCharCollate(tokenizer_phone or tokenizer, tokenizer, add_eos)
                   if mtype == "cif_mix" else FeatPhoneCollate(tokenizer_phone or tokenizer))
    elif signal["feature_type"] == "offline":
        dataset, sampler = ArkDataset, FrameBasedSampler
        budget = int(trainingconfig["batch_frames"])
        collate = FeatureCollate(tokenizer, add_eos, label_type)
    else:
        dataset, sampler = SpeechDataset, TimeBasedSampler
        budget = int(trainingconfig["batch_time"])
        # the fbank geometry comes from signal.sample_rate; the raw-wave
        # encoders take any rate, as in the JAX package
        collate = WaveCollate(tokenizer, add_eos, label_type,
                              expected_rate=signal.get("sample_rate", 16000)
                              if signal["feature_type"] == "fbank" else None)
    train_set = dataset(dataconfig["trainset"], feat_range=feat_range,
                        label_range=label_range)
    valid_set = dataset(dataconfig["devset"], reverse=True)
    tr = DataLoader(train_set, sampler(train_set, budget * ndata, ndata, shuffle=True),
                    collate, num_workers=workers, rank=rank, world=world)
    cv = DataLoader(valid_set, sampler(valid_set, budget * ndata, ndata, shuffle=False),
                    collate, num_workers=workers, rank=rank, world=world)
    return tr, cv


def check_ported(args, config) -> None:
    """Exit for a model or pipe axis without torchrun's ranks, a pipe axis
    without the stacked layout, and the families other CLIs train."""
    for flag, size in (("--model-parallel", args.model_parallel), ("--pipeline", args.pipeline)):
        if size > 1 and not args.distributed:
            raise SystemExit(
                f"{flag} {size} needs --distributed: the port runs a rank a card, so "
                "launch with python -m torch.distributed.run --nproc-per-node N -m "
                f"openasr_torch.bin.train <config> --distributed {flag} {size} (N a "
                "multiple of it)"
            )
    if args.pipeline > 1 and not (config["model"].get("encoder") or {}).get("pipeline", False):
        raise SystemExit(
            "--pipeline requires the stacked layer layout: set "
            "encoder.pipeline: true in the model config (and convert "
            "existing checkpoints with tools/stack_encoder_pkg.py)"
        )
    if _norm_type(config["model"]) in TEXT_TYPES:
        raise SystemExit(
            f"model type {config['model']['type']!r}: the text families train through "
            "openasr_torch.bin.train_phone2char (Embed_Decoder, Embed_Decoder_CTC) and "
            "openasr_torch.bin.semi_train_phone2char (gan_phone2char); this CLI trains "
            "the speech families"
        )
    sig = config["model"].get("signal") or {}
    if _norm_type(config["model"]) in PHONE_TYPES:
        offline = True  # features and phones; no wave frontend
    elif "feature_type" not in sig:
        raise ValueError(
            "config: model.signal.feature_type is required ('offline' for "
            "precomputed features, 'fbank' for the online wave frontend, "
            "'wave' for the raw-wave encoders)"
        )
    else:
        offline = sig["feature_type"] == "offline"
    budget_key = "batch_frames" if offline else "batch_time"
    if budget_key not in config["training"]:
        raise ValueError(
            f"config: training.{budget_key} is required for the "
            f"{'offline-feature' if offline else 'online-wave'} pipeline "
            f"({'cumulative frames' if offline else 'cumulative samples'} per batch)"
        )


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(description="Train an ASR model (PyTorch)")
    parser.add_argument("config", help="path to YAML config")
    parser.add_argument("--continue-training", action="store_true", default=False)
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="tensor-parallel degree: ranks a model group (with "
                             "--distributed)")
    parser.add_argument("--pipeline", type=int, default=1,
                        help="pipeline-parallel stage count (the pipe axis, with "
                             "--distributed); requires encoder.pipeline: true "
                             "(stacked layer layout) in the model config")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="data-parallel over torchrun's ranks (NCCL on cards, "
                             "gloo with --device cpu)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="train on the GPU (default) or, when asked, the CPU")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate_config(config, required=REQUIRED)
    check_ported(args, config)
    if args.distributed:
        group = init_distributed(args.device, model=args.model_parallel, pipe=args.pipeline)
        device = group.device
        logging.info("Grid: rank %d of %d on %s (%s), data %d of %d, model %d of %d, "
                     "pipe %d of %d", group.rank, group.world, device, group.backend,
                     group.data.rank, group.data.world, group.model.rank, group.model.world,
                     group.pipe.rank, group.pipe.world)
    else:
        device = resolve_device(args.device)
        group = Grid.single(device)
    try:
        train(args, config, device, group)
    finally:
        destroy(group)


def train(args, config, device, grid) -> None:
    dataconfig = config["data"]
    trainingconfig = config["training"]
    modelconfig = config["model"]

    dtype_name = str(trainingconfig.get("compute_dtype", "float32"))
    dtype = DTYPES[dtype_name]
    if dtype == torch.float32:
        # full f32: cuDNN would otherwise run the ConvV2 convolutions in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    tokenizer = CharTokenizer(dataconfig["vocab_path"],
                              add_blk=modelconfig.get("add_blk", False))
    modelconfig["decoder"]["vocab_size"] = tokenizer.unit_num()
    tokenizer_phone = None
    if dataconfig.get("vocab_phone"):
        tokenizer_phone = CharTokenizer(dataconfig["vocab_phone"], add_blk=True)
        if "phone_size" in modelconfig or _norm_type(modelconfig) == "cif_mix":
            modelconfig["phone_size"] = tokenizer_phone.unit_num()
    group = grid.data
    tr_loader, cv_loader = build_loaders(dataconfig, trainingconfig, modelconfig,
                                         tokenizer, tokenizer_phone, ndata=group.world,
                                         rank=group.rank, world=group.world)
    solver_kwargs = {}
    if _norm_type(modelconfig) == "cif_mix" and dataconfig.get("acousticset"):
        # CIF_MIX's acoustic-only batches (features and phones), zipped
        # with the paired loader a step
        ac_set = ArkDataset(dataconfig["acousticset"],
                            feat_range=parse_range(dataconfig.get("feat_range")) or (1, 99999),
                            label_range=(0, 10**9), rate_in_out=(0, 10**9))
        solver_kwargs["acoustic_loader"] = DataLoader(
            ac_set, FrameBasedSampler(ac_set, int(trainingconfig["batch_frames"]) * group.world,
                                      group.world, shuffle=True),
            FeatPhoneCollate(tokenizer_phone or tokenizer),
            num_workers=int(dataconfig.get("fetchworker_num", 2)),
            rank=group.rank, world=group.world)

    model = get_model_class(modelconfig["type"]).create_model(
        modelconfig, device=device, generator=torch.Generator().manual_seed(0)
    )
    logging.info("Model %s: %.2fM params on %s (compute %s)", modelconfig["type"],
                 sum(p.numel() for p in model.module.parameters()) / 1e6, device,
                 dtype_name)

    pkg = None
    if args.continue_training:
        path = os.path.join(trainingconfig["exp_dir"], "last.pkg")
        logging.info("Restoring from %s", path)
        pkg = load_package(path)
        model.restore(pkg["model"])
    elif trainingconfig.get("pretrained_model"):
        logging.info("Warm start from %s", trainingconfig["pretrained_model"])
        pre = load_package(trainingconfig["pretrained_model"])
        model.restore(pre["model"], without_fc=True)
        trainingconfig["init_lr"] = float(trainingconfig["init_lr"]) * 0.1

    solver = get_solver_class(modelconfig["type"])(
        model, trainingconfig, tr_loader, cv_loader, device=device,
        compute_dtype=dtype, group=grid, **solver_kwargs,
    )
    if pkg is not None:
        solver.restore(pkg)
    logging.info("Start training...")
    solver.train()


if __name__ == "__main__":
    main()
