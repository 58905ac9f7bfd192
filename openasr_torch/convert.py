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
  Conv kernel WIO over [B, T, F] (Stack)  Conv1d weight OIW over [B, F, T]
  _FoldedAffine kernel [C*F, M]           Linear weight [M, C*F], input
                                          flattened from [B, T, C, F]
  LayerNorm scale                         LayerNorm weight
  Embed embedding [V, D] (tied output)    Embedding weight [V, D]
  decoder out_bias, ctc_fc / fc kernel    out_bias, ctc_fc / fc weight

The LMs' components depend on their depth (`emb`, `cells_{i}` or
`layer{i}`, and `out_bias`, a bare top-level leaf), so their list comes
from the config (`models/lm.py:lm_components`); the LSTM cells' gate
kernels `ii`...`ho` are Dense kernels, and the Transformer LM's
attention heads are its own config's `nhead`.

The raw-wave families add WavConv (`conv{i}` 1-D WIO kernels, `bn{i}`
BatchNorm scale and bias, and in `batch_stats` its running `mean` and
`var`, the port's buffers of those names) and the GRU: a flax GRUCell's
`ir`, `iz`, `in` (kernel and bias), `hr`, `hz` (kernel) and `hn` (kernel
and bias) are the port's `weight_ih` = [ir; iz; in] and `weight_hh` =
[hr; hz; hn] (Linear layouts stacked by gate), `bias_ih` = [ir; iz; in]
and `b_hn`.  CPC's components depend on its `n_steps` (`mappings_{k}`).

The CIF families add the assigner (`conv{i}` 1-D WIO or 2-D HWIO,
`linear`, and the 2-D variant's `affine`), the CIF decoder (`emb`,
`input_affine`, `output_affine`, `layer{i}`), `phone_fc` and CIF_MIX's
`char_decoder`, whose attention heads are the `decoder` section's.

The text families: Embed_Decoder's `emb` (the phone Embed) and `decoder`;
Embed_Decoder_CTC's `emb`, `encoder_block` (its heads are the `decoder`
section's, which configures the stack) and `ctc_fc`; gan_phone2char's
`G` (those three, nested) and `D` (`encoder`: `conv{i}` HWIO and the
folded `affine`, as ConvV2's; `score_fc`), G's heads from
`G.decoder`.

A stacked encoder (`encoder.pipeline`, models/encoder.py:
PipelinedEncoderStack) keeps its layers in the package as
`<component>/stack/stacked_layers`, one layer tree whose leaves carry a
leading [L] (openasr_tpu/parallel/pipeline.py's layout); the port's
module holds them as `stack.layer{i}`, so the bridge unstacks them into
per-layer trees on the way in and stacks a `stack` node's `layer{i}`
children on the way out (`parallel/pipeline.py:stack_layer_params`).

Both directions are exact (pure transposes and reshapes).

The optimizer states bridge the same way (`jax_optim_state_to_port`,
`port_optim_state_to_jax`): their moments are elementwise in the weights,
so each moment tree maps through the weights' own path mapping and
layout transposes, and the counters carry over.  optax's `masked` (the
`frozen_components` of GRU-CTC after `load_splayer`) holds no moments for
the frozen leaves (`MaskedNode`), nor does the port's optimizer; the
wav2vec `freeze_until` gate's step counter is the port's `gate_count`.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from openasr_torch.ops.fused_adam import FusedClipAdamState, host_copy
from openasr_torch.parallel.pipeline import stack_layer_params, unstack_layer_params
from openasr_torch.ops.optimizers import (
    ApplyIfFiniteState,
    EmptyState,
    MaskedNode,
    MaskedState,
    ScaleByAdamState,
    ScaleByScheduleState,
    TraceState,
)

COMPONENTS = {
    "conv-transformer": ("encoder", "decoder"),
    "conv-ctc-transformer": ("encoder", "decoder", "ctc_fc"),
    "conv-ctc": ("encoder", "fc"),
    "CIF": ("encoder", "assigner", "decoder"),
    "ctc_cif": ("encoder", "assigner", "decoder", "ctc_fc"),
    "CIF_FC": ("encoder", "assigner", "ctc_fc", "phone_fc"),
    "CIF_MIX": ("encoder", "assigner", "char_decoder", "ctc_fc", "phone_fc"),
    "gru_ctc": ("splayer", "encoder", "fc"),
    "wav2vec_ctc": ("encoder", "fc"),
    "Embed_Decoder": ("emb", "decoder"),
    "Embed_Decoder_CTC": ("emb", "encoder_block", "ctc_fc"),
    "gan_phone2char": ("G", "D"),
}
# the config path of a component's attention heads, where it is not the
# component's own name
HEADS_SECTION = {"char_decoder": ("decoder",), "encoder_block": ("decoder",),
                 "G": ("G", "decoder")}
_ATTENTION = ("self_attn", "cross_attn")


def _components_of(model_type: str, configs=None):
    # the speech models' components need no import of the models (a
    # serving process bridges its checkpoints without them)
    if model_type in COMPONENTS:
        return COMPONENTS[model_type]
    if model_type == "encoder_cpc":
        if configs is None:
            raise ValueError("the components of an encoder_cpc come from its config")
        n_steps = int((configs.get("cpc") or configs.get("decoder") or {}).get("n_steps", 12))
        return ("splayer", "rnn") + tuple(f"mappings_{k}" for k in range(n_steps))
    from openasr_torch.models.lm import LM_TYPES, lm_components

    if model_type not in LM_TYPES:
        raise ValueError(
            f"no weight bridge for model type {model_type!r}; bridged: "
            f"{sorted(COMPONENTS)}"
        )
    if configs is None:
        raise ValueError(f"the components of a {model_type} come from its config")
    return lm_components(model_type, configs)


_BATCH_NORM = re.compile(r"bn\d+")
STACKED = "stacked_layers"
_GRU = re.compile(r"gru\d+")
_GRU_GATES = {"weight_ih": ("ir", "iz", "in"), "weight_hh": ("hr", "hz", "hn"),
              "bias_ih": ("ir", "iz", "in")}


def _is_norm(module_name: str) -> bool:
    return (module_name.startswith("norm") or module_name.endswith("_norm")
            or _BATCH_NORM.fullmatch(module_name) is not None)


def is_batch_stat(key: str) -> bool:
    """Whether a state_dict key is a BatchNorm running statistic (the
    package's `batch_stats`, not its `components`)."""
    path = key.split(".")
    return (len(path) > 1 and path[-1] in ("mean", "var")
            and _BATCH_NORM.fullmatch(path[-2]) is not None)


def _gru_to_torch(cell: dict) -> Dict[str, np.ndarray]:
    """A flax GRUCell's parameters -> the port's GRULayer's."""
    def stack(leaf, key, transpose):
        parts = [np.asarray(cell[g][key], np.float32) for g in _GRU_GATES[leaf]]
        return np.concatenate([p.T for p in parts] if transpose else parts)

    return {"weight_ih": stack("weight_ih", "kernel", True),
            "weight_hh": stack("weight_hh", "kernel", True),
            "bias_ih": stack("bias_ih", "bias", False),
            "b_hn": np.asarray(cell["hn"]["bias"], np.float32)}


def _gru_leaf_to_jax(node: dict, leaf: str, arr: np.ndarray) -> None:
    """One GRULayer tensor into the flax GRUCell tree `node`."""
    if leaf == "b_hn":
        node.setdefault("hn", {})["bias"] = arr
        return
    for gate, part in zip(_GRU_GATES[leaf], np.split(arr, 3, axis=0)):
        key = "bias" if leaf == "bias_ih" else "kernel"
        node.setdefault(gate, {})[key] = np.ascontiguousarray(part if key == "bias" else part.T)


def _in_attention(path) -> bool:
    return len(path) > 2 and path[-3] in _ATTENTION


def _leaf_to_torch(path, arr: np.ndarray):
    """(flax path, array) -> (torch leaf name, array in torch layout)."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if name == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3 and not _in_attention(path):  # WIO -> OIW
            return "weight", arr.transpose(2, 1, 0)
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
                                 partial: bool = False,
                                 configs=None) -> Dict[str, torch.Tensor]:
    """JAX-layout package components -> the port's state_dict (CPU f32).
    `partial` accepts a subset of the model type's components; `configs`
    is needed for an LM (its depth)."""
    expected = _components_of(model_type, configs)
    if set(components) - set(expected) or (not partial and set(components) != set(expected)):
        raise ValueError(
            f"{model_type} package components {sorted(components)} != "
            f"expected {sorted(expected)}"
        )
    state: Dict[str, torch.Tensor] = {}
    for name in expected:
        if name in components:
            _walk_to_torch(components[name], (name,), state)
    return state


def _walk_to_torch(tree, path, state: dict) -> None:
    """The flax subtree at `path` into `state` (torch names and layouts)."""
    if isinstance(tree, MaskedNode):  # optax.masked: no state for a frozen leaf
        return
    if isinstance(tree, dict) and path and path[-1] == STACKED:
        n = len(np.asarray(next(_leaves(tree))))
        for name, layer in unstack_layer_params(tree, n).items():
            _walk_to_torch(layer, path[:-1] + (name,), state)
        return
    if isinstance(tree, dict) and path and _GRU.fullmatch(path[-1]) and "ir" in tree:
        for leaf, arr in _gru_to_torch(tree).items():
            state[".".join(path + (leaf,))] = torch.tensor(arr)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk_to_torch(v, path + (k,), state)
        return
    leaf, arr = _leaf_to_torch(path, np.asarray(tree, dtype=np.float32))
    state[".".join(path[:-1] + (leaf,))] = torch.tensor(arr)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _restack(tree):
    """Every `stack` node's `layer{i}` children -> its `stacked_layers`."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _restack(v) for k, v in tree.items()}
    if isinstance(out.get("stack"), dict) and STACKED not in out["stack"]:
        stacked, _ = stack_layer_params(out["stack"])
        out["stack"] = {STACKED: stacked}
    return out


def subtree_to_state_dict(tree: dict) -> Dict[str, torch.Tensor]:
    """One flax subtree (a component, or a module inside one) -> the
    state_dict of the matching torch submodule, keys relative to it."""
    state: Dict[str, torch.Tensor] = {}
    _walk_to_torch(tree, (), state)
    return state


def _section_heads(configs, component: str) -> int:
    """The attention heads of `component`, from its config section."""
    section = configs
    for key in HEADS_SECTION.get(component, (component,)):
        section = section[key]
    return int(section["nhead"])


def state_dict_to_jax_components(model_type: str, state_dict, configs) -> dict:
    """The port's state_dict -> JAX-layout components (f32 NumPy).  The
    attention head count comes from the `encoder`/`decoder` config section
    that owns the layer (`HEADS_SECTION`), or for the Transformer LM from
    its own config."""
    from openasr_torch.models.lm import LM_TYPES, lm_hparams

    expected = _components_of(model_type, configs)
    lm_heads = lm_hparams(model_type, configs).get("nhead") if model_type in LM_TYPES else None
    components: dict = {}
    for key, tensor in state_dict.items():
        path = key.split(".")
        if path[0] not in expected:
            raise ValueError(f"state_dict key {key!r} outside {expected}")
        arr = host_copy(tensor)
        leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
        if _GRU.fullmatch(parent) and leaf in ("weight_ih", "weight_hh", "bias_ih", "b_hn"):
            node = components
            for p in path[:-1]:
                node = node.setdefault(p, {})
            _gru_leaf_to_jax(node, leaf, arr)
            continue
        attention = _in_attention(path)
        if attention:
            heads = lm_heads or _section_heads(configs, path[0])
        if leaf == "weight":
            if _is_norm(parent):
                leaf = "scale"
            elif parent == "emb":
                leaf = "embedding"
            else:
                leaf = "kernel"
                if arr.ndim == 4:  # OIHW -> HWIO
                    arr = arr.transpose(2, 3, 1, 0)
                elif arr.ndim == 3:  # OIW -> WIO
                    arr = arr.transpose(2, 1, 0)
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
    return _restack(components)


# ------------------------------------------------------- optimizer states

def _moments_to_port(model_type: str, tree, configs=None) -> Dict[str, np.ndarray]:
    return {k: v.numpy()
            for k, v in jax_components_to_state_dict(model_type, tree, configs=configs).items()}


def _moments_to_jax(model_type: str, moments: dict, configs) -> dict:
    tensors = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in moments.items()}
    return state_dict_to_jax_components(model_type, tensors, configs)


def jax_optim_state_to_port(model_type: str, state, configs=None) -> dict:
    """The JAX package's optimizer state (as `load_package` reads it) ->
    the port's optimizer `state_dict`: FusedClipAdamState -> `count`,
    `notfinite`, `mu`, `nu`; optax's apply_if_finite(chain([freeze_until,]
    [clip,] sgd | adam)) -> `count`, `trace` or `mu` and `nu`, the gate's
    `gate_count`, and apply_if_finite's `notfinite` (its total_notfinite),
    `notfinite_count`, `last_finite`; either inside optax's `masked`
    (frozen components: their leaves are MaskedNodes and are left out).
    The moments come keyed by torch parameter name, in torch layouts,
    f32; `configs` is needed for an LM (its depth) and CPC (its steps)."""
    if isinstance(state, MaskedState):
        state = state.inner_state
    if isinstance(state, FusedClipAdamState):
        return {
            "count": int(state.count),
            "notfinite": 0 if state.notfinite is None else int(state.notfinite),
            "mu": _moments_to_port(model_type, state.mu, configs),
            "nu": _moments_to_port(model_type, state.nu, configs),
        }
    out: dict = {}
    if isinstance(state, ApplyIfFiniteState):
        out.update(notfinite=int(state.total_notfinite),
                   notfinite_count=int(state.notfinite_count),
                   last_finite=bool(state.last_finite))
        state = state.inner_state
    if isinstance(state, MaskedState):
        state = state.inner_state
    # optax.chain([freeze_until,] [clip_by_global_norm,] sgd | adam):
    # ({"count"}, EmptyState(), opt), (EmptyState(), opt) or (opt,)
    parts = [s for s in state if not isinstance(s, EmptyState)]
    if parts and isinstance(parts[0], dict) and set(parts[0]) == {"count"}:
        out["gate_count"] = int(parts[0]["count"])
        parts = parts[1:]
    if len(parts) != 1 or len(parts[0]) != 2 or not isinstance(parts[0][1], ScaleByScheduleState):
        raise ValueError(f"unknown optimizer state layout: {state!r:.200}")
    inner, schedule = parts[0]
    out["count"] = int(schedule.count)
    if isinstance(inner, TraceState):
        out["trace"] = _moments_to_port(model_type, inner.trace, configs)
    elif isinstance(inner, ScaleByAdamState):
        if int(inner.count) != out["count"]:
            raise ValueError(f"Adam's count {int(inner.count)} != the schedule's {out['count']}")
        out["mu"] = _moments_to_port(model_type, inner.mu, configs)
        out["nu"] = _moments_to_port(model_type, inner.nu, configs)
    else:
        raise ValueError(f"unknown optimizer state {type(inner).__name__}")
    return out


def _masked_nodes(tree):
    if isinstance(tree, dict):
        return {k: _masked_nodes(v) for k, v in tree.items()}
    return MaskedNode()


def port_optim_state_to_jax(model_type: str, state: dict, configs, clip: bool,
                            frozen=None):
    """The inverse of `jax_optim_state_to_port`: the port's optimizer
    `state_dict` -> the JAX solver's state, in the port's NamedTuples of
    the same fields (the JAX solver restores a state by its leaves).
    `clip`: the chain holds clip_by_global_norm (grad_max_norm > 0).
    `frozen`: the JAX-layout trees of the frozen components ({name: tree},
    as a package's `components` holds them), whose moments become
    MaskedNodes inside optax's `masked`."""
    masked = {} if frozen is None else _masked_nodes(frozen)

    def moments(key):
        return {**_moments_to_jax(model_type, state[key], configs), **masked}

    def wrap(inner):
        return inner if frozen is None else MaskedState(inner)

    count = np.asarray(state["count"], np.int32)
    if "notfinite" in state and "last_finite" not in state:
        return wrap(FusedClipAdamState(count, moments("mu"), moments("nu"),
                                       np.asarray(state["notfinite"], np.int32)))
    if "trace" in state:
        inner = TraceState(moments("trace"))
    else:
        inner = ScaleByAdamState(count, moments("mu"), moments("nu"))
    chain = ((inner, ScaleByScheduleState(count)),)
    if clip:
        chain = (EmptyState(),) + chain
    if "gate_count" in state:
        chain = ({"count": np.asarray(state["gate_count"], np.int32)},) + chain
    chain = wrap(chain)
    if "last_finite" not in state:
        return chain
    return ApplyIfFiniteState(
        np.asarray(state["notfinite_count"], np.int32), np.asarray(state["last_finite"]),
        np.asarray(state["notfinite"], np.int32), chain,
    )
