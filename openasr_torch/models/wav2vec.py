"""Wav2vec-style raw-wave encoder with CTC finetuning (`wav2vec_ctc`).

Counterpart of openasr_tpu/models/wav2vec.py: WavConv (x160) -> `proj`
-> x * sqrt(d) + sinusoidal positions -> dropout -> N post-LN encoder
layers (GELU; self-attention over the valid frames through the flash
kernels, LayerNorm through its kernel) -> `final_norm` -> `fc` (no bias,
f32) -> CTC.

`encoder.freeze_finetune_updates: n` > 0 sets `freeze_gate =
(("encoder",), n)`: the solver zeroes the gradients of the WHOLE
`encoder` component (frontend, proj, the layers and final_norm) for the
first n optimizer steps, so only `fc` learns then, as the JAX solver's
`freeze_until` gate does.  `load_frontend` warm-starts the WavConv from
a CPC package's `splayer`.  `load_fairseq_wav2vec` and
`map_fairseq_context_network` import a fairseq wav2vec 2.0 context
network (post-LN layers, exact GELU) onto the encoder's parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import register_model
from openasr_torch.models.frontend import WavConv
from openasr_torch.models.layers import (
    LayerNorm,
    TrainRNG,
    TransformerEncoderLayer,
    any_empty,
    dropout,
    positional_encoding,
    run_layers,
)
from openasr_torch.models.speech import ConvCTC, _f32_head, load_component


class Wav2VecEncoder(nn.Module):
    """Raw waves [B, N] -> ([B, N // 160 (padded), d_model], lengths)."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int,
                 conv_dim: int = 512, dropout_rate: float = 0.1, activation: str = "gelu"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.frontend = WavConv(conv_dim)
        self.proj = nn.Linear(conv_dim, d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, activation, dropout_rate))
        self.layers = [getattr(self, f"layer{i}") for i in range(num_layers)]
        self.final_norm = LayerNorm(d_model)

    def forward(self, waves, wave_lengths, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        feats, lengths = self.frontend(waves, wave_lengths, train=rng is not None)
        x = dropout(positional_encoding(self.proj(feats)), self.dropout_rate, rng)
        empty_rows = any_empty(lengths, empty_rows)
        x = run_layers(self.layers, x, kv_lengths=lengths, rng=rng, empty_rows=empty_rows,
                       final_norm=self.final_norm)
        return x, lengths


class Wav2VecCTCModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        enc = configs.encoder
        self.encoder = Wav2VecEncoder(
            d_model=int(enc["d_model"]), nhead=int(enc["nhead"]),
            num_layers=int(enc["num_layers"]), dim_feedforward=int(enc["dim_feedforward"]),
            conv_dim=int(enc.get("conv_dim", 512)),
            dropout_rate=float(enc.get("dropout_rate", 0.1)),
            activation=enc.get("activation", "gelu"),
        )
        self.fc = nn.Linear(int(enc["d_model"]), int(configs.decoder["vocab_size"]), bias=False)

    @staticmethod
    def encoder_lengths(input_lengths):
        return WavConv.output_lengths(input_lengths)

    def forward(self, waves, wave_lengths, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """-> (logits [B, T', V] f32, lengths [B])."""
        enc, lengths = self.encoder(waves, wave_lengths, rng, empty_rows)
        return _f32_head(self.fc, enc), lengths


@register_model("wav2vec_ctc")
class Wav2VecCTC(ConvCTC):
    module_cls = Wav2VecCTCModule
    moe_capable = False

    def __init__(self, module: nn.Module, configs: Config):
        super().__init__(module, configs)
        n_freeze = int(self.configs.encoder.get("freeze_finetune_updates", 0))
        self.freeze_gate = (("encoder",), n_freeze) if n_freeze > 0 else None

    def load_frontend(self, pkg: dict) -> None:
        """Warm-start the WavConv frontend (weights and running
        statistics) from a CPC package's `splayer`."""
        load_component(self.module, "encoder.frontend", pkg, "splayer")

    def fc_component_names(self) -> tuple:
        return ("fc",)


def load_fairseq_wav2vec(path: str) -> Dict[str, np.ndarray]:
    """A fairseq wav2vec checkpoint (torch .pt) -> its state dict as NumPy
    arrays.  A fairseq checkpoint pickles its training arguments beside
    the weights, so it is read with `weights_only=False`: read only files
    you trust."""
    pkg = torch.load(path, map_location="cpu", weights_only=False)
    state = pkg.get("model", pkg)
    return {k: v.numpy() for k, v in state.items() if hasattr(v, "numpy")}


def map_fairseq_context_network(state: dict, encoder_state: dict, nhead: int) -> dict:
    """fairseq wav2vec 2.0 context-network weights -> a new state dict of
    a `Wav2VecEncoder` (keys relative to it, as `module.encoder.state_dict()`
    gives them); entries not covered keep `encoder_state`'s values.

      post_extract_proj                       -> proj
      encoder.layers.N.self_attn.{q,k,v,out}_proj -> layerN.self_attn.{q,k,v,out}
      encoder.layers.N.self_attn_layer_norm   -> layerN.norm1
      encoder.layers.N.fc1 / fc2              -> layerN.ffn.linear1 / linear2
      encoder.layers.N.final_layer_norm       -> layerN.norm2
      encoder.layer_norm                      -> final_norm

    Both sides keep torch's Linear layout, so each weight copies as it is.
    Not mapped, as in the JAX package: fairseq's 7-layer conv feature
    extractor (stride 320) and its convolutional positions.  A state dict
    with no `encoder.layers.N.self_attn` entries raises."""
    new = dict(encoder_state)

    def put(ours: str, theirs: str) -> None:
        for leaf in ("weight", "bias"):
            value = torch.as_tensor(np.asarray(state[f"{theirs}.{leaf}"]), dtype=torch.float32)
            if value.shape != new[f"{ours}.{leaf}"].shape:
                raise ValueError(f"{theirs}.{leaf} {tuple(value.shape)} does not fit {ours}.{leaf} "
                                 f"{tuple(new[f'{ours}.{leaf}'].shape)}")
            new[f"{ours}.{leaf}"] = value

    if "post_extract_proj.weight" in state:
        put("proj", "post_extract_proj")
    if "encoder.layer_norm.weight" in state:
        put("final_norm", "encoder.layer_norm")
    n = 0
    while f"encoder.layers.{n}.self_attn.q_proj.weight" in state:
        pre = f"encoder.layers.{n}"
        d = state[f"{pre}.self_attn.q_proj.weight"].shape[0]
        if d % nhead:
            raise ValueError(f"d_model {d} is not a multiple of nhead {nhead}")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            put(f"layer{n}.self_attn.{ours}", f"{pre}.self_attn.{theirs}")
        put(f"layer{n}.norm1", f"{pre}.self_attn_layer_norm")
        put(f"layer{n}.ffn.linear1", f"{pre}.fc1")
        put(f"layer{n}.ffn.linear2", f"{pre}.fc2")
        put(f"layer{n}.norm2", f"{pre}.final_layer_norm")
        n += 1
    if n == 0:
        raise ValueError(
            "no encoder.layers.N.self_attn.* entries found: not a fairseq wav2vec2 "
            "context-network state dict"
        )
    return new
