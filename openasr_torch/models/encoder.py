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
the JAX encoder's errors.  Under tensor parallelism (`tp`, set by
`shard_module`) the layers and the final LayerNorm run on this rank's
T-shard where the sequence-parallel rule allows (`run_layers`), and the
output is whole.  `encoder.remat` recomputes each layer's activations in
the backward (`layers.rematerialized`, the JAX package's `nn.remat`).

`encoder.pipeline: true` holds the layers in `PipelinedEncoderStack`
(`stack`), the JAX package's stacked layout: a package keeps them as
`encoder/stack/stacked_layers`, one layer tree with a leading [L] on every
leaf (convert.py), and the module as `stack.layer{i}`.  Under a pipeline
context (parallel/pipeline.py, a solver on a grid with a pipe axis) the
stack holds only its stage's layers (`set_stage`) and runs them through
`gpipe_apply`; without one (decode, the CPU, one card) it runs the same
layers one by one, as the per-layer encoder does, so a package trained
pipelined decodes anywhere.

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
from openasr_torch.parallel.pipeline import (
    gpipe_apply,
    microbatch_count,
    pipeline_context,
    stage_layers,
)
from openasr_torch.models.subsample import (
    Conv1dSubsample,
    Conv2dSubsample,
    Conv2dSubsampleV2,
)
from openasr_torch.ops.masks import ChunkMask

SUB_TYPES = ("ConvV1", "ConvV2", "Stack", None)


class PipelinedEncoderStack(nn.Module):
    """The stacked-layout layer stack (`encoder.pipeline`): `layer{i}` for
    the global indices i it holds, all L of them, or after `set_stage`
    its stage's [p L / S, (p + 1) L / S).  Under a pipeline context the
    forward is `gpipe_apply` over the context's pipe group with the JAX
    stack's microbatch count (`microbatch_count`: the largest m <= the
    requested one that divides the batch); without one the layers run in
    order (`run_layers`), which a stage's part of the stack cannot do."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, num_layers: int,
                 activation: str = "relu", dropout_rate: float = 0.1, remat: bool = False):
        super().__init__()
        self.num_layers, self.dropout_rate, self.remat = num_layers, dropout_rate, remat
        self.layer_args = (d_model, nhead, dim_feedforward, activation, dropout_rate)
        self.held = range(num_layers)
        for i in self.held:
            self.add_module(f"layer{i}", self.new_layer())

    def new_layer(self) -> TransformerEncoderLayer:
        return TransformerEncoderLayer(*self.layer_args)

    @property
    def layers(self) -> list:
        return [getattr(self, f"layer{i}") for i in self.held]

    def set_stage(self, rank: int, size: int) -> None:
        """Keep only stage `rank` of `size`'s layers."""
        keep = stage_layers(self.num_layers, rank, size)
        for i in self.held:
            if i not in keep:
                delattr(self, f"layer{i}")
        self.held = keep

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, rng: Optional[TrainRNG],
                empty_rows: bool, final_norm: LayerNorm) -> torch.Tensor:
        ctx = pipeline_context()
        if ctx is None:
            if len(self.held) != self.num_layers:
                raise RuntimeError(
                    f"this stack holds layers [{self.held.start}, {self.held.stop}) of "
                    f"{self.num_layers}: run it under its pipeline context")
            return run_layers(self.layers, x, kv_lengths=lengths, rng=rng,
                              empty_rows=empty_rows, final_norm=final_norm, remat=self.remat)
        group, requested = ctx
        if len(self.held) * group.world != self.num_layers:
            raise RuntimeError(f"a pipe group of {group.world} stages, but this stack holds "
                               f"{len(self.held)} of {self.num_layers} layers")
        m = microbatch_count(x.shape[0], requested)

        def layer_apply(layer, h, aux, layer_rng):
            return layer(h, kv_lengths=aux["lengths"], rng=layer_rng, empty_rows=empty_rows)

        x = gpipe_apply(layer_apply, self.layers, x, {"lengths": lengths}, group, m,
                        remat=self.remat, rng=rng if self.dropout_rate > 0 else None,
                        first=self.held.start)
        return final_norm(x)


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
        remat: bool = False,
        pipeline: bool = False,
    ):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.remat = remat
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
        self.stack = None
        if pipeline:
            self.stack = PipelinedEncoderStack(d_model, nhead, dim_feedforward, num_layers,
                                               activation, dropout_rate, remat)
        for i in range(0 if pipeline else num_layers):
            moe_here = moe_experts > 0 and i % moe_every == moe_every - 1
            self.add_module(
                f"layer{i}",
                TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation,
                                        dropout_rate, moe_experts if moe_here else 0,
                                        moe_top_k, moe_capacity, moe_router),
            )
        self._layers = [getattr(self, f"layer{i}") for i in range(0 if pipeline else num_layers)]
        self.final_norm = LayerNorm(d_model)

    @property
    def layers(self) -> list:
        """The layers this module holds, in order (a stage's, under a pipe)."""
        return self._layers if self.stack is None else self.stack.layers

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
        if self.stack is not None:
            return self.stack(x, lengths, rng, empty_rows, self.final_norm), lengths
        x = run_layers(self.layers, x, kv_lengths=lengths, rng=rng, empty_rows=empty_rows,
                       chunk_mask=self.chunk_mask, final_norm=self.final_norm,
                       remat=self.remat)
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
        # streaming
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
            remat=bool(cfg.get("remat", False)),
            pipeline=bool(cfg.get("pipeline", False)),
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
