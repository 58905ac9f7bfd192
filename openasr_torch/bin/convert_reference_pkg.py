"""Convert a reference (eastonYi/OpenASR) PyTorch checkpoint into a package
of the shared file format, so users of the reference can bring trained
models to the port.

Counterpart of tools/convert_reference_pkg.py, with its arguments and
output, importing nothing of the JAX package:

  python -m openasr_torch.bin.convert_reference_pkg ref_last.pt out.pkg \
      --model_type conv-ctc-transformer

Supported model types: conv-transformer, conv-ctc-transformer, conv-ctc.
The reference packages each component as `{name}_config` /
`{name}_state`; the weights are written in the JAX package's layout
(Linear [out, in] -> kernel [in, out]; Conv2d [O, I, H, W] -> [H, W, I,
O]; MultiheadAttention's packed in_proj -> q / k / v kernels [d, heads,
head_dim], out_proj -> [heads, head_dim, d]; LayerNorm weight / bias ->
scale / bias; the embedding tied to the output affine as `emb.embedding`,
its bias `out_bias`), which `Framework.restore` (openasr_torch/convert.py)
takes into the port's modules, and `--model_pkg` of either package's
CLIs reads.  A reference solver checkpoint (the model package under
"model") is unwrapped.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from openasr_torch.utils.checkpoint import save_package


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _linear(sd, prefix, bias=True):
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _norm(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _mha(sd, prefix, d_model, nhead):
    head_dim = d_model // nhead
    w = _np(sd[f"{prefix}.in_proj_weight"])   # [3d, d]
    b = _np(sd[f"{prefix}.in_proj_bias"])     # [3d]
    out = {}
    for i, name in enumerate(("q", "k", "v")):
        wi = w[i * d_model:(i + 1) * d_model]  # [d, d], y = wi @ x
        out[name] = {
            "kernel": wi.T.reshape(d_model, nhead, head_dim),
            "bias": b[i * d_model:(i + 1) * d_model].reshape(nhead, head_dim),
        }
    wo = _np(sd[f"{prefix}.out_proj.weight"])  # [d, d]
    out["out"] = {
        "kernel": wo.T.reshape(nhead, head_dim, d_model),
        "bias": _np(sd[f"{prefix}.out_proj.bias"]),
    }
    return out


def _conv2d(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{prefix}.bias"])}


def _ffn(sd, prefix):
    return {"linear1": _linear(sd, f"{prefix}.linear1"),
            "linear2": _linear(sd, f"{prefix}.linear2")}


def convert_encoder(sd: dict, cfg: dict) -> dict:
    d, h = int(cfg["d_model"]), int(cfg["nhead"])
    params = {}
    sub = cfg.get("sub") or {}
    if sub.get("type") in ("ConvV1", "ConvV2"):
        # ConvV1 keys: sub.conv.0 / sub.conv.2 (Sequential indices);
        # ConvV2 keys: sub.conv.subsample/conv{i}
        if sub["type"] == "ConvV1":
            conv_params = {f"conv{i}": _conv2d(sd, f"sub.conv.{idx}")
                           for i, idx in enumerate((0, 2))}
        else:
            conv_params = {f"conv{i}": _conv2d(sd, f"sub.conv.subsample/conv{i}")
                           for i in range(int(sub.get("layer_num", 2)))}
        conv_params["affine"] = _linear(sd, "sub.affine")
        params["sub"] = conv_params
    elif sub.get("type") == "Stack":
        raise NotImplementedError(
            "reference Conv1dSubsample crashed on init "
            "(src/blocks/conv_layers.py:85-86); no trained checkpoints of "
            "this type can exist"
        )
    elif "affine.weight" in sd:
        params["affine"] = _linear(sd, "affine")
    for i in range(int(cfg["num_layers"])):
        p = f"transformer_encoder.layers.{i}"
        params[f"layer{i}"] = {
            "self_attn": _mha(sd, f"{p}.self_attn", d, h),
            "ffn": _ffn(sd, p),
            "norm1": _norm(sd, f"{p}.norm1"),
            "norm2": _norm(sd, f"{p}.norm2"),
        }
    params["final_norm"] = _norm(sd, "transformer_encoder.norm")
    return params


def convert_decoder(sd: dict, cfg: dict) -> dict:
    d, h = int(cfg["d_model"]), int(cfg["nhead"])
    params = {
        "emb": {"embedding": _np(sd["emb.weight"])},
        "out_bias": _np(sd["output_affine.bias"]),
    }
    for i in range(int(cfg["num_layers"])):
        p = f"transformer_block.layers.{i}"
        params[f"layer{i}"] = {
            "self_attn": _mha(sd, f"{p}.self_attn", d, h),
            "cross_attn": _mha(sd, f"{p}.multihead_attn", d, h),
            "ffn": _ffn(sd, p),
            "norm1": _norm(sd, f"{p}.norm1"),
            "norm2": _norm(sd, f"{p}.norm2"),
            "norm3": _norm(sd, f"{p}.norm3"),
        }
    return params


def convert(ref_pkg: dict, model_type: str) -> dict:
    """reference package dict -> package dict (the JAX layout)."""
    sp_cfg = dict(ref_pkg.get("splayer_config") or {})
    en_cfg = dict(ref_pkg["encoder_config"])
    components = {"encoder": convert_encoder(ref_pkg["encoder_state"], en_cfg)}
    configs = {"type": model_type, "signal": sp_cfg, "encoder": en_cfg}
    if model_type in ("conv-transformer", "conv-ctc-transformer"):
        de_cfg = dict(ref_pkg["decoder_config"])
        components["decoder"] = convert_decoder(ref_pkg["decoder_state"], de_cfg)
        configs["decoder"] = de_cfg
        configs["add_eos"] = True
        configs["add_blk"] = model_type == "conv-ctc-transformer"
    if model_type == "conv-ctc-transformer":
        # the reference's CTC head: a bias-free Linear's state dict
        components["ctc_fc"] = {"kernel": _np(ref_pkg["ctc_fc_state"]["weight"]).T}
    if model_type == "conv-ctc":
        components["fc"] = {"kernel": _np(ref_pkg["fc_state"]["weight"]).T}
        configs["decoder"] = {"vocab_size": components["fc"]["kernel"].shape[1]}
        configs["add_blk"] = True
    return {"model_type": model_type, "configs": configs, "components": components}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ref_pt", help="reference .pt package")
    parser.add_argument("out_pkg", help="output .pkg")
    parser.add_argument("--model_type", required=True,
                        choices=("conv-transformer", "conv-ctc-transformer", "conv-ctc"))
    args = parser.parse_args(argv)

    ref = torch.load(args.ref_pt, map_location="cpu", weights_only=False)
    # solver checkpoints nest the model package under "model"
    if "model" in ref and "encoder_state" in ref["model"]:
        ref = ref["model"]
    pkg = convert(ref, args.model_type)
    save_package(pkg, args.out_pkg)
    n = sum(int(np.prod(x.shape)) for comp in pkg["components"].values()
            for x in _tree_leaves(comp))
    print(f"converted {args.ref_pt} -> {args.out_pkg} ({n / 1e6:.2f}M params)")


if __name__ == "__main__":
    main()
