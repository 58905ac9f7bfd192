"""Language-model training CLI (LSTM LM or Transformer LM).

Counterpart of openasr_tpu/bin/train_lm.py on one device, with the same
YAML schema: `data.trainset` / `data.devset` text files of one line a
sentence (tokens separated by spaces, as the acoustic manifests' `tokens`),
`data.vocab_path` (the character tokenizer; `model.vocab_size` becomes
its unit count), `data.maxlen` (lines cut to that many tokens),
`model.type` `lstm_lm` | `transformer_lm`, and `training.batch_size`
lines a batch (the train batches reshuffled every epoch, the last short
one dropped), the CE solver, `--continue-training` (restores
exp_dir/last.pkg, also one the JAX CLI wrote).  On the card by default,
`--device cpu` on the CPU; `training.compute_dtype: bfloat16` runs the
forward in bf16 over f32 weights, as the speech CLI does.

  python -m openasr_torch.bin.train_lm lm.yaml [--continue-training] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.bin.train import setup_logging
from openasr_torch.config import load_config, validate_config
from openasr_torch.data.collate import TextCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import TextLineByLineDataset
from openasr_torch.data.sampler import CountBatchSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import DTYPES, CESolver
from openasr_torch.utils.checkpoint import load_package

REQUIRED = ("data.trainset", "data.devset", "data.vocab_path", "training.exp_dir",
            "training.lr_scheduler.type")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(description="Train an LM (PyTorch)")
    parser.add_argument("config", help="path to YAML config")
    parser.add_argument("--continue-training", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="train on the GPU (default) or, when asked, the CPU")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate_config(config, required=REQUIRED)
    device = resolve_device(args.device)
    dataconfig = config["data"]
    trainingconfig = config["training"]
    modelconfig = config["model"]
    dtype_name = str(trainingconfig.get("compute_dtype", "float32"))
    dtype = DTYPES[dtype_name]
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    tokenizer = CharTokenizer(dataconfig["vocab_path"])
    modelconfig["vocab_size"] = tokenizer.unit_num()
    bs = int(trainingconfig.get("batch_size", 32))
    workers = int(dataconfig.get("fetchworker_num", 2))
    collate = TextCollate(tokenizer, maxlen=dataconfig.get("maxlen"))
    train_set = TextLineByLineDataset(dataconfig["trainset"])
    valid_set = TextLineByLineDataset(dataconfig["devset"])
    tr_loader = DataLoader(train_set, CountBatchSampler(len(train_set), bs, shuffle=True,
                                                        drop_last=True),
                           collate, num_workers=workers)
    cv_loader = DataLoader(valid_set, CountBatchSampler(len(valid_set), bs), collate,
                           num_workers=workers)

    model_type = modelconfig.get("type", "lstm_lm")
    model = get_model_class(model_type).create_model(
        modelconfig, device=device, generator=torch.Generator().manual_seed(0))
    logging.info("Model %s: %.2fM params on %s (compute %s)", model_type,
                 sum(p.numel() for p in model.module.parameters()) / 1e6, device, dtype_name)

    pkg = None
    if args.continue_training:
        path = os.path.join(trainingconfig["exp_dir"], "last.pkg")
        logging.info("Restoring from %s", path)
        pkg = load_package(path)
        model.restore(pkg["model"])

    solver = CESolver(model, trainingconfig, tr_loader, cv_loader, device=device,
                      compute_dtype=dtype)
    if pkg is not None:
        solver.restore(pkg)
    solver.train()


if __name__ == "__main__":
    main()
