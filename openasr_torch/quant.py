"""Weight-only int8 quantization for serving.

Counterpart of openasr_tpu/quant.py, without JAX.  An eligible leaf of a
checkpoint package's parameter tree W [..., C] (the flax layout, as
`load_package` reads it) becomes

    {"int8:q": int8 [..., C], "int8:scale": f32 [C]}

with a symmetric scale per last axis, computed in NumPy with the JAX
package's own arithmetic (amax / 127, np.rint of W / scale, clip to
+-127), so the two packages quantize a checkpoint to the same bits.
Eligibility is judged on the flax leaf: a float array of at least 2 axes
and `MIN_SIZE` elements.  Other leaves pass through.

The port's modules keep their weights in torch layouts
(openasr_torch/convert.py), where the flax leaf's last axis lands
elsewhere: a q/k/v kernel [D, H, hd] becomes [H*hd, D] with row h*hd + j
on scale j, a Dense kernel [in, out] becomes [out, in] with the scale on
its rows, an HWIO convolution OIHW with the scale on O, while an
embedding [V, D] keeps its scale on D.  `bridge_quantized` moves q
through the bridge's own leaf mapping and gives each scale the torch
layout's broadcast shape, so that `dequantize_params` in torch computes
the same products q * scale, element by element, as the JAX package's
dequantized weights bridged: equal bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Q_KEY = "int8:q"
SCALE_KEY = "int8:scale"

# tensors smaller than this (biases, LayerNorm parameters) stay float:
# no bandwidth to win, and 1-D tensors lack a channel axis
MIN_SIZE = 4096


def _eligible(x) -> bool:
    return (
        hasattr(x, "ndim")
        and x.ndim >= 2
        and np.issubdtype(np.asarray(x).dtype, np.floating)
        and x.size >= MIN_SIZE
    )


def _tree_map(fn, tree, is_leaf=lambda node: False):
    if not is_leaf(tree) and isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree, is_leaf=lambda node: False):
    if not is_leaf(tree) and isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v, is_leaf)]
    return [tree]


def quantize_params(params) -> Any:
    """Host-side: replace every eligible float leaf of a nested dict of
    arrays (the flax layout) with its int8 representation, in NumPy."""

    def one(x):
        if not _eligible(x):
            return x
        wf = np.asarray(x).astype(np.float32)
        amax = np.max(np.abs(wf), axis=tuple(range(wf.ndim - 1)))
        scale = (amax / 127.0).astype(np.float32)
        safe = np.where(scale > 0, scale, 1.0)
        q = np.clip(np.rint(wf / safe), -127, 127).astype(np.int8)
        return {Q_KEY: q, SCALE_KEY: scale}

    return _tree_map(one, params)


def is_quantized_leaf(node) -> bool:
    return isinstance(node, dict) and Q_KEY in node


def dequantize_params(qparams) -> Any:
    """The dense f32 weights of a quantized tree: q * scale, broadcast.
    Torch tensors stay torch (inside an exported program: one multiply per
    weight), NumPy stays NumPy."""

    def one(node):
        if not is_quantized_leaf(node):
            return node
        q, scale = node[Q_KEY], node[SCALE_KEY]
        if isinstance(q, torch.Tensor):
            return q.to(torch.float32) * scale
        return np.asarray(q).astype(np.float32) * np.asarray(scale)

    return _tree_map(one, qparams, is_leaf=is_quantized_leaf)


def quantization_error(params, qparams) -> float:
    """Max |W - dequant(Q)| / scale over all quantized leaves: at most 0.5
    by construction (rounding)."""
    worst = 0.0
    for p, q in zip(_leaves(params), _leaves(qparams, is_quantized_leaf)):
        if not is_quantized_leaf(q):
            continue
        w = np.asarray(p, np.float32)
        deq = np.asarray(q[Q_KEY], np.float32) * np.asarray(q[SCALE_KEY])
        scale = np.maximum(np.asarray(q[SCALE_KEY]), 1e-30)
        worst = max(worst, float(np.max(np.abs(w - deq) / scale)))
    return worst


def _scale_in_torch_layout(path, q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """`scale` [C] of flax leaf `path` (q [..., C]) in the torch layout of
    q's bridged leaf, with size 1 on every axis it does not vary along:
    the bridge maps an index array of q's shape (each element its channel)
    as it maps q, and the axes where the channel changes keep their size."""
    from openasr_torch.convert import _leaf_to_torch

    channel = np.broadcast_to(np.arange(q.shape[-1]), q.shape)
    _, channel_t = _leaf_to_torch(path, channel)
    for axis in range(channel_t.ndim):
        first = np.take(channel_t, [0], axis=axis)
        if (channel_t == first).all():
            channel_t = first
    return scale[channel_t]


def bridge_quantized(model_type: str, qcomponents: dict, configs=None) -> dict:
    """`quantize_params` of a package's components -> the port's state dict:
    {torch parameter name: f32 tensor, or {Q_KEY: int8 tensor, SCALE_KEY:
    f32 tensor broadcastable to it}} (CPU), through convert.py's leaf
    mapping.  `configs` is needed for an LM (its depth)."""
    from openasr_torch.convert import _components_of, _leaf_to_torch

    expected = _components_of(model_type, configs)
    if set(qcomponents) != set(expected):
        raise ValueError(f"{model_type} package components {sorted(qcomponents)} != "
                         f"expected {sorted(expected)}")
    state: dict = {}

    def walk(node, path):
        if is_quantized_leaf(node):
            q, scale = np.asarray(node[Q_KEY]), np.asarray(node[SCALE_KEY], np.float32)
            leaf, q_t = _leaf_to_torch(path, q)
            state[".".join(path[:-1] + (leaf,))] = {
                Q_KEY: torch.tensor(np.ascontiguousarray(q_t)),
                SCALE_KEY: torch.tensor(np.ascontiguousarray(
                    _scale_in_torch_layout(path, q, scale))),
            }
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaf, arr = _leaf_to_torch(path, np.asarray(node, dtype=np.float32))
            state[".".join(path[:-1] + (leaf,))] = torch.tensor(np.ascontiguousarray(arr))

    for name in expected:
        walk(qcomponents[name], (name,))
    return state
