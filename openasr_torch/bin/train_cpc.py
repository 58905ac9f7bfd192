"""CPC pretraining / GRU-CTC finetuning CLI.

Counterpart of openasr_tpu/bin/train_cpc.py on one device: `--type
pretrain` trains `encoder_cpc` on wave-only batches (`.json` manifests or
`path<TAB>samples` `.flist` lists); `--type finetune` trains `gru_ctc` on
labelled wave manifests with a BPE (`SubwordTokenizer`) vocabulary,
warm-starting and freezing its WavConv from `training.load_splayer` (a CPC
package of either package).  Batches hold `training.batch_time` samples;
`--continue-training` restores exp_dir/last.pkg.  It runs on the card
unless `--device cpu` is given.

  python -m openasr_torch.bin.train_cpc egs/libri/configs/cpc_pretrain.yaml --type pretrain
  python -m openasr_torch.bin.train_cpc egs/libri/configs/gru_ctc_finetune.yaml --type finetune
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.bin.train import setup_logging
from openasr_torch.config import load_config, parse_range, validate_config
from openasr_torch.data.collate import WaveCollate, WaveOnlyCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import SpeechDataset
from openasr_torch.data.sampler import TimeBasedSampler
from openasr_torch.data.tokenizer import SubwordTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import DTYPES, get_solver_class
from openasr_torch.utils.checkpoint import load_package

REQUIRED = ("data.trainset", "data.devset", "training.exp_dir", "training.batch_time",
            "training.lr_scheduler.type")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(description="CPC pretrain / finetune (PyTorch)")
    parser.add_argument("config")
    parser.add_argument("--type", choices=["pretrain", "finetune"], default="pretrain")
    parser.add_argument("--continue-training", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="train on the GPU (default) or, when asked, the CPU")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate_config(config, required=REQUIRED)
    device = resolve_device(args.device)
    dataconfig = config["data"]
    trainingconfig = config["training"]
    modelconfig = config["model"]
    feat_range = parse_range(dataconfig.get("feat_range")) or (1, 10**9)
    dtype = DTYPES[str(trainingconfig.get("compute_dtype", "float32"))]
    if dtype == torch.float32:
        # full f32: cuDNN would otherwise run the convolutions and the GRU in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.type == "pretrain":
        train_set = SpeechDataset(dataconfig["trainset"], feat_range=feat_range)
        valid_set = SpeechDataset(dataconfig["devset"], reverse=True, feat_range=feat_range)
        collate = WaveOnlyCollate()
        model_type = "encoder_cpc"
        if "sp" in modelconfig and "signal" not in modelconfig:
            modelconfig["signal"] = modelconfig["sp"]
    else:
        tokenizer = SubwordTokenizer(dataconfig["vocab_path"],
                                     add_blk=modelconfig.get("add_blk", True))
        modelconfig["decoder"]["vocab_size"] = tokenizer.unit_num()
        label_range = parse_range(dataconfig.get("label_range")) or (1, 100)
        train_set = SpeechDataset(dataconfig["trainset"], feat_range=feat_range,
                                  label_range=label_range)
        valid_set = SpeechDataset(dataconfig["devset"], reverse=True, feat_range=feat_range,
                                  label_range=label_range)
        collate = WaveCollate(tokenizer, modelconfig.get("add_eos", False),
                              trainingconfig.get("label_type", "tokens"))
        model_type = "gru_ctc"

    workers = int(dataconfig.get("fetchworker_num", 2))
    budget = int(trainingconfig["batch_time"])
    tr_loader = DataLoader(train_set, TimeBasedSampler(train_set, budget, 1, shuffle=True),
                           collate, num_workers=workers)
    cv_loader = DataLoader(valid_set, TimeBasedSampler(valid_set, budget, 1),
                           collate, num_workers=workers)

    modelconfig["type"] = model_type
    model = get_model_class(model_type).create_model(
        modelconfig, device=device, generator=torch.Generator().manual_seed(0))
    if args.type == "finetune" and trainingconfig.get("load_splayer"):
        logging.info("Load pretrained splayer from %s", trainingconfig["load_splayer"])
        pkg = load_package(trainingconfig["load_splayer"])
        model.load_splayer(pkg["model"] if "model" in pkg else pkg)

    pkg = None
    if args.continue_training:
        path = os.path.join(trainingconfig["exp_dir"], "last.pkg")
        logging.info("Restoring from %s", path)
        pkg = load_package(path)
        model.restore(pkg["model"])

    solver = get_solver_class(model_type)(model, trainingconfig, tr_loader, cv_loader,
                                          device=device, compute_dtype=dtype)
    if pkg is not None:
        solver.restore(pkg)
    solver.train()


if __name__ == "__main__":
    main()
