"""Transformer encoder with conv subsampling, and the GRU encoder.

Counterpart of `TransformerEncoder` in openasr_tpu/models/encoder.py, the
per-layer path: subsample -> x * sqrt(d) + PE -> dropout -> N post-LN
layers (flash self-attention over the valid frames) -> final LayerNorm.
The subsampler is ConvV1, ConvV2 or Stack (`encoder.sub.type`); without
one the input passes as it is when input_dim == d_model, else through a
Dense `affine`.
Given a `TrainRNG` the forward is the train-mode one (dropout on).
`encoder.streaming: {chunk, left_chunks}` trains (and decodes in one
pass) under the chunk mask of ops/masks.py:chunk_bias, with the phase
of the model's frontend (models/speech.py:streaming_phase_of), through
the chunk mode of the attention kernels, so that the cached streaming
executor (openasr_torch/streaming.py) computes the same encoder states.
`encoder.moe: {num_experts, top_k, capacity_factor, every, router}` makes
layer i a mixture of experts (models/moe.py) where i % every == every - 1;
`num_experts: 0` runs dense.  MoE refuses streaming and the pipeline with
the JAX encoder's errors; the pipeline (stacked layers) is a later slice
of the port.  Under tensor parallelism (`tp`, set by `shard_module`) the
layers and the final LayerNorm run on this rank's T-shard where the
sequence-parallel rule allows (`run_layers`), and the output is whole.

`GRUEncoder` is the JAX package's: a unidirectional multi-layer GRU over
the full padded sequence (no packing), dropout between layers.  Each layer
is a flax 0.12 `GRUCell`, which has biases on its `ir`, `iz`, `in` and
`hn` projections only; `torch.nn.GRU` would train two more (`b_hr`,
`b_hz`).  So a `GRULayer` keeps its own `weight_ih` and `weight_hh` (gates
r, z, n), `bias_ih` and `b_hn`, and calls the cuDNN GRU (`torch._VF.gru`)
with `bias_hh = [0, 0, b_hn]`: the same gates, h' = (1 - z) n + z h.
The JAX package scans the cell outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openasr_torch.models.layers import (
    LayerNorm,
    activation_dtype,
    autocast_off,
    TrainRNG,
    TransformerEncoderLayer,
    any_empty,
    dropout,
    positional_encoding,
    run_layers,
)
from openasr_torch.models.subsample import (
    Conv1dSubsample,
    Conv2dSubsample,
    Conv2dSubsampleV2,
)
from openasr_torch.ops.masks import ChunkMask

SUB_TYPES = ("ConvV1", "ConvV2", "Stack", None)


class TransformerEncoder(nn.Module):
    def __init__(
        self,
        input_dim: int,
        d_model: int,
        nhead: int,
        dim_feedforward: int,
        num_layers: int,
        activation: str = "relu",
        sub_type: str = "ConvV2",
        sub_layer_num: int = 2,
        dropout_rate: float = 0.1,
        context_width: int = 3,
        subsample: int = 1,
        streaming_chunk: int = 0,
        streaming_left: int = -1,
        streaming_phase: int = 1,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity: float = 1.25,
        moe_every: int = 2,
        moe_router: str = "topk",
    ):
        super().__init__()
        self.dropout_rate = dropout_rate
        # the chunk-attention mask in encoder frames (chunk 0: none)
        self.chunk_mask = (ChunkMask(streaming_chunk, streaming_left, streaming_phase)
                           if streaming_chunk > 0 else None)
        self.sub = self.affine = None
        if sub_type == "ConvV1":
            self.sub = Conv2dSubsample(input_dim, d_model)
        elif sub_type == "ConvV2":
            self.sub = Conv2dSubsampleV2(input_dim, d_model, sub_layer_num)
        elif sub_type == "Stack":
            self.sub = Conv1dSubsample(input_dim, d_model, context_width, subsample)
        elif sub_type is not None:
            raise ValueError(f"encoder.sub.type {sub_type!r} is not one of {SUB_TYPES}")
        elif input_dim != d_model:
            self.affine = nn.Linear(input_dim, d_model)
        # a float that follows the module's dtype (LayerNorm weights stay
        # f32), whatever the input layer
        self.register_buffer("dtype_probe", torch.zeros(()), persistent=False)
        for i in range(num_layers):
            moe_here = moe_experts > 0 and i % moe_every == moe_every - 1
            self.add_module(
                f"layer{i}",
                TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation,
                                        dropout_rate, moe_experts if moe_here else 0,
                                        moe_top_k, moe_capacity, moe_router),
            )
        self.layers = [getattr(self, f"layer{i}") for i in range(num_layers)]
        self.final_norm = LayerNorm(d_model)

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
                rng: Optional[TrainRNG] = None, empty_rows: Optional[bool] = None):
        """feats [B, T, F] -> (encoded [B, T', d_model], lengths [B]).
        `empty_rows`: whether some utterance subsamples to no frame, as the
        caller knows it from the host's lengths (None: read it back)."""
        x, lengths = feats.to(self.compute_dtype), feat_lengths
        if self.sub is not None:
            x, lengths = self.sub(x, lengths)
        elif self.affine is not None:
            x = self.affine(x)
        x = dropout(positional_encoding(x), self.dropout_rate, rng)
        empty_rows = any_empty(lengths, empty_rows)
        x = run_layers(self.layers, x, kv_lengths=lengths, rng=rng, empty_rows=empty_rows,
                       chunk_mask=self.chunk_mask, final_norm=self.final_norm)
        return x, lengths

    def output_lengths(self, lengths):
        """Encoder frames of `lengths` input frames (torch or NumPy)."""
        return lengths if self.sub is None else self.sub.output_lengths(lengths)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the model runs in (LayerNorm parameters stay f32)."""
        return self.dtype_probe.dtype

    @staticmethod
    def from_config(cfg, streaming_phase: int = 1) -> "TransformerEncoder":
        """`streaming_phase`: the chunk mask's phase, 2 for an fbank
        frontend and 1 for offline features (`streaming_phase_of` in
        models/speech.py)."""
        streaming = cfg.get("streaming") or {}
        moe = cfg.get("moe") or {}
        if moe:
            # config.validate_moe rejects these at load time with richer
            # messages; this guard covers programmatic construction
            every = int(moe.get("every", 2))
            if every < 1 or int(moe.get("top_k", 2)) < 1:
                raise ValueError(f"invalid encoder.moe config: {moe}")
            if int(moe.get("num_experts", 0)) > 0 and every > int(cfg["num_layers"]):
                raise ValueError(
                    f"encoder.moe.every={every} > num_layers="
                    f"{cfg['num_layers']}: zero MoE layers would be built"
                )
        moe_experts = int(moe.get("num_experts", 0))
        # the JAX encoder's own errors where MoE meets the pipeline or
        # streaming, before the refusal of what the port lacks
        if moe_experts > 0 and cfg.get("pipeline"):
            raise NotImplementedError(
                "encoder.moe does not compose with encoder.pipeline: the "
                "GPipe stack scans over structurally identical layers"
            )
        if streaming.get("chunk", 0) and moe_experts > 0:
            raise NotImplementedError(
                "encoder.moe does not compose with encoder.streaming: "
                "per-chunk expert capacity would diverge from the batch "
                "forward, breaking the executor's exactness guarantee"
            )
        if streaming.get("chunk", 0) and cfg.get("pipeline"):
            raise NotImplementedError(
                "encoder.streaming does not compose with "
                "encoder.pipeline: the GPipe stack threads only "
                "kv_lengths through its stages"
            )
        if cfg.get("pipeline"):
            raise NotImplementedError(
                "encoder.pipeline is not ported yet: ROADMAP queue 1 item 15c "
                "(the pipe axis, GPipe)"
            )
        sub = cfg.get("sub") or {}
        return TransformerEncoder(
            input_dim=int(cfg["input_dim"]),
            d_model=int(cfg["d_model"]),
            nhead=int(cfg["nhead"]),
            dim_feedforward=int(cfg["dim_feedforward"]),
            num_layers=int(cfg["num_layers"]),
            activation=cfg.get("activation", "relu"),
            sub_type=sub.get("type"),
            sub_layer_num=int(sub.get("layer_num", 2)),
            dropout_rate=float(cfg.get("dropout_rate", 0.1)),
            context_width=int(cfg.get("context_width", 3)),
            subsample=int(cfg.get("subsample", 1)),
            streaming_chunk=int(streaming.get("chunk", 0)),
            streaming_left=int(streaming.get("left_chunks", -1)),
            streaming_phase=streaming_phase,
            moe_experts=moe_experts,
            moe_top_k=int(moe.get("top_k", 2)),
            moe_capacity=float(moe.get("capacity_factor", 1.25)),
            moe_every=int(moe.get("every", 2)),
            moe_router=str(moe.get("router", "topk")),
        )


class GRULayer(nn.Module):
    """One flax GRUCell scanned over [B, T, d_input] -> [B, T, d_model],
    from a zero state.  It runs in the activation dtype (bf16 under
    autocast), as the JAX cell takes the model's dtype."""

    # init_parameters: flax's kaiming_normal input kernels and an
    # orthogonal recurrent kernel per gate
    param_inits = {"weight_ih": "kaiming_normal", "weight_hh": "orthogonal_gates"}

    def __init__(self, d_input: int, d_model: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * d_model, d_input))
        self.weight_hh = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.bias_ih = nn.Parameter(torch.zeros(3 * d_model))
        self.b_hn = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = activation_dtype(x)
        h = self.b_hn.shape[0]
        with autocast_off(x.device.type):
            bias_hh = torch.cat([self.b_hn.new_zeros(2 * h), self.b_hn])
            weights = [w.to(dt) for w in (self.weight_ih, self.weight_hh, self.bias_ih, bias_hh)]
            h0 = x.new_zeros((1, x.shape[0], h), dtype=dt)
            out, _ = torch._VF.gru(x.to(dt), h0, weights, True, 1, 0.0,
                                   torch.is_grad_enabled(), False, True)
        return out


class GRUEncoder(nn.Module):
    def __init__(self, d_input: int, d_model: int, n_layers: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        for i in range(n_layers):
            self.add_module(f"gru{i}", GRULayer(d_input if i == 0 else d_model, d_model))
        self.layers = [getattr(self, f"gru{i}") for i in range(n_layers)]

    def forward(self, feats: torch.Tensor, feat_lengths: torch.Tensor,
                rng: Optional[TrainRNG] = None):
        """feats [B, T, d_input] -> ([B, T, d_model], feat_lengths); with
        `rng` the dropout between layers is on."""
        x = feats
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = dropout(x, self.dropout_rate, rng)
        return x, feat_lengths

    @staticmethod
    def from_config(cfg) -> "GRUEncoder":
        return GRUEncoder(
            d_input=int(cfg["d_input"]),
            d_model=int(cfg["d_model"]),
            n_layers=int(cfg["n_layers"]),
            dropout_rate=float(cfg.get("dropout", 0.0)),
        )
