"""phone->char training CLI (Embed_Decoder or Embed_Decoder_CTC).

Counterpart of openasr_tpu/bin/train_phone2char.py on one device, with
the same YAML schema: `data.trainset` / `data.devset` phone->char json
manifests (`uttid / phones / phone_length / tokens / token_length`),
`data.vocab_phone` (the input tokenizer; `model.encoder.vocab_size`
becomes its unit count) and `data.vocab_char` (the targets, with the
blank when `model.add_blk`; `model.decoder.vocab_size`), `model.type`
Embed_Decoder (CE solver) or Embed_Decoder_CTC (CTC solver, dev WER),
batches of `training.batch_phones` cumulative phones (the train batches
reshuffled every epoch), `--continue-training` (restores
exp_dir/last.pkg, also one the JAX CLI wrote).  It trains in f32, as the
JAX CLI does, on the card by default, `--device cpu` on the CPU.

  python -m openasr_torch.bin.train_phone2char egs/IPA2char/configs/callhome_ma_IPA.yaml
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.bin.train import setup_logging
from openasr_torch.config import load_config, parse_range, validate_config
from openasr_torch.data.collate import PhoneCharCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import PhoneCharDataset
from openasr_torch.data.sampler import BudgetBatchSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import get_solver_class
from openasr_torch.utils.checkpoint import load_package

REQUIRED = ("data.trainset", "data.devset", "data.vocab_phone", "data.vocab_char",
            "training.exp_dir", "training.lr_scheduler.type")


def phone2char_args(description: str, argv):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config", help="path to YAML config")
    parser.add_argument("--continue-training", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="train on the GPU (default) or, when asked, the CPU")
    return parser.parse_args(argv)


def full_f32() -> None:
    """Full f32 products: cuBLAS and cuDNN would otherwise take TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def restore_last(model, exp_dir: str) -> dict:
    """exp_dir/last.pkg (either package's) restored into `model`."""
    path = os.path.join(exp_dir, "last.pkg")
    logging.info("Restoring from %s", path)
    pkg = load_package(path)
    model.restore(pkg["model"])
    return pkg


def main(argv=None):
    setup_logging()
    args = phone2char_args("Train a phone->char model (PyTorch)", argv)
    config = load_config(args.config)
    validate_config(config, required=REQUIRED)
    device = resolve_device(args.device)
    full_f32()
    dataconfig = config["data"]
    trainingconfig = config["training"]
    modelconfig = config["model"]

    feat_range = parse_range(dataconfig.get("feat_range")) or (1, 99999)
    label_range = parse_range(dataconfig.get("label_range")) or (1, 100)
    tokenizer_phone = CharTokenizer(dataconfig["vocab_phone"])
    tokenizer_char = CharTokenizer(dataconfig["vocab_char"],
                                   add_blk=modelconfig.get("add_blk", False))
    modelconfig["encoder"]["vocab_size"] = tokenizer_phone.unit_num()
    modelconfig["decoder"]["vocab_size"] = tokenizer_char.unit_num()

    budget = int(trainingconfig["batch_phones"])
    workers = int(dataconfig.get("fetchworker_num", 2))
    train_set = PhoneCharDataset(dataconfig["trainset"], feat_range=feat_range,
                                 label_range=label_range, multi=int(dataconfig.get("multi", 1)))
    valid_set = PhoneCharDataset(dataconfig["devset"], reverse=True)
    collate = PhoneCharCollate(tokenizer_phone, tokenizer_char, modelconfig.get("add_eos", True))
    tr_loader = DataLoader(train_set, BudgetBatchSampler(train_set, budget, key="phone_length",
                                                         shuffle=True),
                           collate, num_workers=workers)
    cv_loader = DataLoader(valid_set, BudgetBatchSampler(valid_set, budget, key="phone_length"),
                           collate, num_workers=workers)

    model_type = modelconfig["type"]
    model = get_model_class(model_type).create_model(
        modelconfig, device=device, generator=torch.Generator().manual_seed(0))
    logging.info("Model %s: %.2fM params on %s", model_type,
                 sum(p.numel() for p in model.module.parameters()) / 1e6, device)
    pkg = restore_last(model, trainingconfig["exp_dir"]) if args.continue_training else None
    solver = get_solver_class(model_type)(model, trainingconfig, tr_loader, cv_loader,
                                          device=device)
    if pkg is not None:
        solver.restore(pkg)
    solver.train()


if __name__ == "__main__":
    main()
