"""phone->char decoding CLI with the WER inline.

Counterpart of openasr_tpu/bin/infer_phone2char.py, with the same flags
plus `--device {cuda,cpu}` (the card unless asked): the model is rebuilt
from the package's configs (either package's), batches hold
`--batch_phones` cumulative phones, Embed_Decoder decodes with the
attention beam (`--nbest` is the beam size, `--maxlen` its steps; the
1-best is kept) and Embed_Decoder_CTC greedily.  It writes
`--output_dir`/hyp.txt and ref.txt (`utt text` lines) and prints
`WER: x.xx` (percent) last.  f32, as the JAX CLI.

  python -m openasr_torch.bin.infer_phone2char --model_type Embed_Decoder_CTC \\
      --model_pkg exp/last.pkg --vocab_phone callhome.IPA --vocab_char vocab.char \\
      --json_file test.json --output_dir decode --add_blk
"""

from __future__ import annotations

import argparse
import logging
import os

from openasr_torch.bin.infer import resolve_device
from openasr_torch.bin.train import setup_logging
from openasr_torch.bin.train_phone2char import full_f32
from openasr_torch.config import Config
from openasr_torch.data.collate import PhoneCharCollate
from openasr_torch.data.loader import DataLoader
from openasr_torch.data.manifest import PhoneCharDataset
from openasr_torch.data.sampler import BudgetBatchSampler
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import batch_to_device
from openasr_torch.utils.checkpoint import load_package
from openasr_torch.utils.metrics import wer


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Decode phone->char (PyTorch)")
    parser.add_argument("--model_type", required=True)
    parser.add_argument("--model_pkg", required=True)
    parser.add_argument("--vocab_phone", required=True)
    parser.add_argument("--vocab_char", required=True)
    parser.add_argument("--json_file", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--batch_phones", type=int, default=500)
    parser.add_argument("--nbest", type=int, default=5)
    parser.add_argument("--maxlen", type=int, default=80)
    parser.add_argument("--add_blk", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default) or, when asked, the CPU")
    return parser.parse_args(argv)


def main(argv=None):
    setup_logging()
    args = get_args(argv)
    device = resolve_device(args.device)
    full_f32()
    tokenizer_phone = CharTokenizer(args.vocab_phone)
    tokenizer_char = CharTokenizer(args.vocab_char, add_blk=args.add_blk)

    pkg = load_package(args.model_pkg)
    model_pkg = pkg["model"] if "model" in pkg else pkg
    model = get_model_class(args.model_type).create_model(Config(model_pkg["configs"]),
                                                          device=device)
    model.restore(model_pkg)

    test_set = PhoneCharDataset(args.json_file, feat_range=(1, 10**9),
                                label_range=(0, 10**9), rate_in_out=(0, 10**9))
    loader = DataLoader(test_set, BudgetBatchSampler(test_set, args.batch_phones,
                                                     key="phone_length"),
                        PhoneCharCollate(tokenizer_phone, tokenizer_char, add_eos=True),
                        num_workers=2)

    os.makedirs(args.output_dir, exist_ok=True)
    is_ctc = args.model_type.lower().replace("-", "_") == "embed_decoder_ctc"
    all_hyps, all_refs = [], []
    with open(os.path.join(args.output_dir, "hyp.txt"), "w", encoding="utf-8") as fh, \
            open(os.path.join(args.output_dir, "ref.txt"), "w", encoding="utf-8") as fr:
        for batch in loader:
            arrays = batch_to_device(batch, device)
            empty_rows = model.has_empty_rows(batch["phone_lengths"])
            if is_ctc:
                ids, lens = model.greedy_decode(arrays["phones"], arrays["phone_lengths"],
                                                empty_rows)
            else:
                preds, plens, _ = model.batch_beam_decode(
                    arrays["phones"], arrays["phone_lengths"], beam_size=args.nbest,
                    max_decode_len=args.maxlen, empty_rows=empty_rows)
                ids, lens = preds[:, 0], plens[:, 0]
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            tlen = (1 - batch["paddings"]).sum(-1).astype(int)
            for i, utt in enumerate(batch["uttids"]):
                hyp = tokenizer_char.decode(int(x) for x in ids[i, : lens[i]])
                ref = tokenizer_char.decode(int(x) for x in batch["labels"][i, : tlen[i]])
                fh.write(f"{utt} {hyp}\n")
                fr.write(f"{utt} {ref}\n")
                all_hyps.append(hyp.split())
                all_refs.append(ref.split())

    stats = wer(all_refs, all_hyps)
    logging.info("WER %.2f%% (sub %.2f del %.2f ins %.2f) over %d ref tokens",
                 stats["wer"], stats["sub"], stats["del"], stats["ins"], stats["n_ref"])
    print(f"WER: {stats['wer']:.2f}")


if __name__ == "__main__":
    main()
