"""Weight bridge between JAX-layout package components and torch state_dicts.

A checkpoint package (openasr_torch/utils/checkpoint.py) holds the flax
parameter tree as nested dicts of NumPy arrays.  The port's modules carry
the same names (`encoder/layer0/self_attn/q` <-> `encoder.layer0.self_attn.q`)
in PyTorch's layouts:

  flax leaf                               torch parameter
  Dense kernel [in, out]                  Linear weight [out, in]
  DenseGeneral q/k/v kernel [D, H, hd]    Linear weight [H*hd, D]
  DenseGeneral q/k/v bias [H, hd]         Linear bias [H*hd]
  DenseGeneral out kernel [H, hd, D]      Linear weight [D, H*hd]
  Conv kernel HWIO over NHWC [B, T, F, 1] Conv2d weight OIHW over [B, 1, T, F]
  _FoldedAffine kernel [C*F, M]           Linear weight [M, C*F], input
                                          flattened from [B, T, C, F]
  LayerNorm scale                         LayerNorm weight
  Embed embedding [V, D] (tied output)    Embedding weight [V, D]
  decoder out_bias, ctc_fc / fc kernel    out_bias, ctc_fc / fc weight

Both directions are exact (pure transposes and reshapes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

COMPONENTS = {
    "conv-transformer": ("encoder", "decoder"),
    "conv-ctc-transformer": ("encoder", "decoder", "ctc_fc"),
    "conv-ctc": ("encoder", "fc"),
}
_ATTENTION = ("self_attn", "cross_attn")


def _components_of(model_type: str):
    if model_type not in COMPONENTS:
        raise ValueError(
            f"no weight bridge for model type {model_type!r}; bridged: "
            f"{sorted(COMPONENTS)}"
        )
    return COMPONENTS[model_type]


def _is_norm(module_name: str) -> bool:
    return module_name.startswith("norm") or module_name.endswith("_norm")


def _leaf_to_torch(path, arr: np.ndarray):
    """(flax path, array) -> (torch leaf name, array in torch layout)."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if name == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3 and parent == "out":  # [H, hd, D] -> [D, H*hd]
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 3:  # [D, H, hd] -> [H*hd, D]
            return "weight", arr.reshape(arr.shape[0], -1).T
        return "weight", arr.T
    if name == "bias":
        return "bias", arr.reshape(-1)
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def jax_components_to_state_dict(model_type: str, components: dict,
                                 partial: bool = False) -> Dict[str, torch.Tensor]:
    """JAX-layout package components -> the port's state_dict (CPU f32).
    `partial` accepts a subset of the model type's components."""
    expected = _components_of(model_type)
    if set(components) - set(expected) or (not partial and set(components) != set(expected)):
        raise ValueError(
            f"{model_type} package components {sorted(components)} != "
            f"expected {sorted(expected)}"
        )
    state: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        leaf, arr = _leaf_to_torch(path, np.asarray(tree, dtype=np.float32))
        state[".".join(path[:-1] + (leaf,))] = torch.tensor(arr)

    for name in expected:
        if name in components:
            walk(components[name], (name,))
    return state


def state_dict_to_jax_components(model_type: str, state_dict, configs) -> dict:
    """The port's state_dict -> JAX-layout components (f32 NumPy).  The
    attention head count comes from the `encoder`/`decoder` config section
    that owns the layer."""
    expected = _components_of(model_type)
    components: dict = {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        if path[0] not in expected:
            raise ValueError(f"state_dict key {key!r} outside {expected}")
        arr = tensor.detach().float().cpu().numpy()
        leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
        attention = len(path) > 2 and path[-3] in _ATTENTION
        if attention:
            heads = int(configs[path[0]]["nhead"])
        if leaf == "weight":
            if _is_norm(parent):
                leaf = "scale"
            elif parent == "emb":
                leaf = "embedding"
            else:
                leaf = "kernel"
                if arr.ndim == 4:  # OIHW -> HWIO
                    arr = arr.transpose(2, 3, 1, 0)
                elif attention and parent == "out":  # [D, H*hd] -> [H, hd, D]
                    arr = arr.T.reshape(heads, -1, arr.shape[0])
                elif attention:  # [H*hd, D] -> [D, H, hd]
                    arr = arr.T.reshape(arr.shape[1], heads, -1)
                else:
                    arr = arr.T
        elif leaf == "bias" and attention and parent != "out":
            arr = arr.reshape(heads, -1)
        node = components
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return components
