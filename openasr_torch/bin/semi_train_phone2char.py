"""Semi-supervised WGAN-GP phone->char training CLI (gan_phone2char).

Counterpart of openasr_tpu/bin/semi_train_phone2char.py on one device:
three loaders, the paired json (`data.trainset`, through
`SemiPhoneCharDataset`, batches of `training.batch_phones` phones) and the
unpaired phone and text lines (`data.unpaired_phone`,
`data.unpaired_text`: `uttid tok tok ...`, `training.unpaired_batch_size`
lines a batch, shuffled, the last short batch dropped); G's vocabularies
from `data.vocab_phone` and `data.vocab_char` (with the blank unless
`model.add_blk` is false), D's `encoder.d_input` the character
vocabulary; `training.G_path` warm-starts G from an Embed_Decoder_CTC
package of either package; `--continue-training` restores
exp_dir/last.pkg.  f32, on the card by default, `--device cpu` on the CPU.

  python -m openasr_torch.bin.semi_train_phone2char egs/IPA2char/configs/semi_callhome_ma_IPA.yaml
"""

from __future__ import annotations

import logging

import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.bin.train import setup_logging
from openasr_torch.bin.train_phone2char import full_f32, phone2char_args, restore_last
from openasr_torch.config import load_config, parse_range, validate_config
from openasr_torch.data.collate import PhoneCharCollate, TokenCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import SemiPhoneCharDataset, TokenDataset
from openasr_torch.data.sampler import BudgetBatchSampler, CountBatchSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import get_solver_class
from openasr_torch.utils.checkpoint import load_package

REQUIRED = ("data.trainset", "data.vocab_phone", "data.vocab_char", "training.exp_dir",
            "training.lr_scheduler.type")


def main(argv=None):
    setup_logging()
    args = phone2char_args("Semi-supervised WGAN-GP phone->char training (PyTorch)", argv)
    config = load_config(args.config)
    validate_config(config, required=REQUIRED)
    device = resolve_device(args.device)
    full_f32()
    dataconfig = config["data"]
    trainingconfig = config["training"]
    modelconfig = config["model"]

    tokenizer_phone = CharTokenizer(dataconfig["vocab_phone"])
    tokenizer_char = CharTokenizer(dataconfig["vocab_char"],
                                   add_blk=modelconfig.get("add_blk", True))
    modelconfig["G"]["encoder"]["vocab_size"] = tokenizer_phone.unit_num()
    modelconfig["G"]["decoder"]["vocab_size"] = tokenizer_char.unit_num()
    modelconfig["D"]["encoder"]["d_input"] = tokenizer_char.unit_num()
    modelconfig["type"] = "gan_phone2char"

    feat_range = parse_range(dataconfig.get("feat_range")) or (1, 99999)
    label_range = parse_range(dataconfig.get("label_range")) or (1, 100)
    unpaired = (dataconfig["unpaired_phone"], dataconfig["unpaired_text"])
    dataset = SemiPhoneCharDataset(*unpaired, dataconfig["trainset"], feat_range=feat_range,
                                   label_range=label_range)
    valid_set = SemiPhoneCharDataset(*unpaired, dataconfig["devset"])
    workers = int(dataconfig.get("fetchworker_num", 2))
    budget = int(trainingconfig["batch_phones"])
    unpaired_bs = int(trainingconfig.get("unpaired_batch_size", 16))
    paired_collate = PhoneCharCollate(tokenizer_phone, tokenizer_char,
                                      modelconfig.get("add_eos", False))
    tr_loader = DataLoader(dataset, BudgetBatchSampler(dataset, budget, key="phone_length",
                                                       shuffle=True),
                           paired_collate, num_workers=workers)
    cv_loader = DataLoader(valid_set, BudgetBatchSampler(valid_set, budget, key="phone_length"),
                           paired_collate, num_workers=workers)
    loaders = {}
    for name, path, tokenizer in (("phone_loader", unpaired[0], tokenizer_phone),
                                  ("text_loader", unpaired[1], tokenizer_char)):
        lines = TokenDataset(path)
        loaders[name] = DataLoader(lines, CountBatchSampler(len(lines), unpaired_bs,
                                                            shuffle=True, drop_last=True),
                                   TokenCollate(tokenizer), num_workers=workers)

    model = get_model_class("gan_phone2char").create_model(
        modelconfig, device=device, generator=torch.Generator().manual_seed(0))
    if trainingconfig.get("G_path"):
        logging.info("Warm-starting G from %s", trainingconfig["G_path"])
        pkg = load_package(trainingconfig["G_path"])
        model.restore_G(pkg["model"] if "model" in pkg else pkg)
    pkg = restore_last(model, trainingconfig["exp_dir"]) if args.continue_training else None
    solver = get_solver_class("gan_phone2char")(model, trainingconfig, tr_loader, cv_loader,
                                                device=device, **loaders)
    if pkg is not None:
        solver.restore(pkg)
    solver.train()


if __name__ == "__main__":
    main()
