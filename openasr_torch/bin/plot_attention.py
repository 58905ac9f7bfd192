"""Dump attention-map heatmaps for one batch of a manifest.

Counterpart of tools/plot_attention.py, with its arguments plus
`--device`, importing nothing of the JAX package:

  python -m openasr_torch.bin.plot_attention --model_type conv-ctc-transformer \
      --model_pkg exp/.../last.pkg --vocab_path data/chars.txt \
      --json_file data/test.json --output_dir /tmp/atten [--utts 4] \
      [--offline] [--add_blk] [--average_heads] [--device cpu]

It loads a package that either package wrote, drops SpecAugment, collates
the manifest's first `--utts` utterances and runs `Framework.attention_maps`
(a deterministic forward; each site's probabilities in f32 from its
inputs), then writes one PNG heatmap a captured attention site (utterance
0, head 0 or the head mean), or, where matplotlib does not import, the
whole [B, H, Tq, Tk] (or [B, Tq, Tk]) map as `<site>.npz` (key `attn`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from openasr_torch.bin.infer import resolve_device
from openasr_torch.config import Config
from openasr_torch.data.collate import FeatureCollate, WaveCollate
from openasr_torch.data.manifest import ArkDataset, SpeechDataset
from openasr_torch.data.tokenizer import CharTokenizer
from openasr_torch.models import get_model_class
from openasr_torch.solvers import batch_to_device
from openasr_torch.utils.checkpoint import load_package


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_type", required=True)
    ap.add_argument("--model_pkg", required=True)
    ap.add_argument("--vocab_path", required=True)
    ap.add_argument("--json_file", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--utts", type=int, default=4)
    ap.add_argument("--offline", action="store_true")
    ap.add_argument("--add_blk", action="store_true")
    ap.add_argument("--average_heads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pkg = load_package(args.model_pkg)
    model_pkg = pkg["model"] if "model" in pkg else pkg
    tok = CharTokenizer(args.vocab_path, add_blk=args.add_blk)
    configs = Config(model_pkg["configs"])
    configs.decoder["vocab_size"] = tok.unit_num()
    if configs.signal and "spec_aug" in configs.signal:
        del configs.signal["spec_aug"]  # deterministic forward
    model = get_model_class(args.model_type).create_model(configs, device=device)
    model.restore(model_pkg)
    signal_cfg = model.configs.signal
    offline = args.offline or not signal_cfg or (
        signal_cfg.get("feature_type", "offline") == "offline"
    )
    if offline:
        ds = ArkDataset(args.json_file)
        col = FeatureCollate(tok, add_eos=True)
    else:
        ds = SpeechDataset(args.json_file)
        col = WaveCollate(tok, add_eos=True)
    batch = col([ds[i] for i in range(min(args.utts, len(ds)))])

    maps = model.attention_maps(batch_to_device(batch, device),
                                average_heads=args.average_heads)
    os.makedirs(args.output_dir, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None

    for name, arr in maps.items():
        arr = arr.float().cpu().numpy()
        safe = name.replace("/", "_")
        if plt is None:
            np.savez(os.path.join(args.output_dir, f"{safe}.npz"), attn=arr)
            continue
        # [B, H, Tq, Tk] or [B, Tq, Tk]: plot utterance 0, head 0/mean
        a = arr[0] if arr.ndim == 3 else arr[0, 0]
        fig, ax = plt.subplots(figsize=(6, 4), dpi=120)
        im = ax.imshow(a, aspect="auto", origin="lower", interpolation="nearest")
        ax.set_xlabel("key position")
        ax.set_ylabel("query position")
        ax.set_title(name)
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(args.output_dir, f"{safe}.png"))
        plt.close(fig)
    print(f"wrote {len(maps)} attention maps -> {args.output_dir}")


if __name__ == "__main__":
    main()
