"""Decoders: the weight-tied Transformer decoder with a KV-cached step, the
CIF decoder and the FC decoder.

Counterparts of `TransformerDecoder`, `CIFDecoder` and `FCDecoder` in
openasr_tpu/models/decoder.py.  TransformerDecoder: embedding x sqrt(d) ->
PE (which scales by sqrt(d) again) -> dropout -> N post-LN decoder layers
-> the tied output affine (embedding^T + out_bias).  CIFDecoder: the same
embedding and PE, input_affine(concat(CIF frames, embedding)), N post-LN
encoder layers with causal self-attention over the valid positions, and
output_affine(concat(CIF frames, h)); its decode `step` is a full forward
of the padded prefix, read at one position.  Given a `TrainRNG` a
forward is the train-mode one.

Under tensor parallelism (`tp`, set by `shard_module`) the embeddings are
vocab-parallel (`layers.Embedding`), the layers run as the encoder's do
(T-shards where `time_shards` allows), the Transformer decoder enters its
memory once for every cross-attention (`copy_to_model`) and its tied
logits come from this rank's vocabulary rows, gathered whole
(`gather_vocab`) before the f32 `out_bias`.  The CIF decoder's
`input_affine` and `output_affine` stay replicated, as in `_tp_entries`.
The decode steps run on one process (`tp` None).  `decoder.remat`
recomputes each Transformer decoder layer's activations in the backward
(`layers.rematerialized`, the JAX package's `nn.remat`).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from openasr_torch.models.layers import (
    Embedding,
    TrainRNG,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
    activation_dtype,
    any_empty,
    dropout,
    positional_encoding,
    run_layers,
)
from openasr_torch.ops.masks import NEG_INF
from openasr_torch.parallel.tensor_parallel import copy_to_model, gather_vocab


class TransformerDecoder(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        d_model: int,
        nhead: int,
        num_layers: int,
        dim_feedforward: int,
        activation: str = "relu",
        dropout_rate: float = 0.1,
        remat: bool = False,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.d_model = d_model
        self.emb = Embedding(vocab_size, d_model)
        self.out_bias = nn.Parameter(torch.zeros(vocab_size))
        for i in range(num_layers):
            self.add_module(
                f"layer{i}",
                TransformerDecoderLayer(d_model, nhead, dim_feedforward, activation,
                                        dropout_rate),
            )
        self.layers = [getattr(self, f"layer{i}") for i in range(num_layers)]

    def _embed(self, ids: torch.Tensor, offset: int = 0) -> torch.Tensor:
        x = self.emb(ids.long())
        x = x.to(activation_dtype(x)) * math.sqrt(self.d_model)
        return positional_encoding(x, offset=offset)

    tp = None

    def _output(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits: the tied product in the compute dtype, then the f32
        `out_bias`."""
        if self.tp is None:
            return (h @ self.emb.weight.t()).float() + self.out_bias
        g = self.tp.group
        part = (copy_to_model(h, g) @ self.emb.weight.t()).float()
        return gather_vocab(part, g, self.vocab_size, self.emb.vocab_start()) + self.out_bias

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor,
                ids: torch.Tensor, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None) -> torch.Tensor:
        """Teacher-forced logits [B, U, V] (causal self-attention; targets
        are right-padded, so the causal mask alone keeps valid queries off
        padded keys).  `empty_rows`: whether some memory length is <= 0
        (None: read it back)."""
        x = dropout(self._embed(ids), self.dropout_rate, rng)
        empty_rows = any_empty(memory_lengths, empty_rows)
        if self.tp is not None:
            memory = copy_to_model(memory, self.tp.group)
        x = run_layers(self.layers, x, memory, memory_lengths, tgt_causal=True, rng=rng,
                       empty_rows=empty_rows, remat=self.remat)
        return self._output(x)

    # ------------------------------------------------------- decode path

    def init_cache(self, memory: torch.Tensor, max_len: int) -> List[dict]:
        b = memory.shape[0]
        return [layer.init_cache(b, max_len, memory) for layer in self.layers]

    def step(self, tokens: torch.Tensor, index: int, cache: List[dict],
             memory_bias: Optional[torch.Tensor], max_len: int) -> torch.Tensor:
        """tokens [B] -> logits [B, V]; `index` is the 0-based position of
        `tokens` in the output sequence.  Updates `cache` in place."""
        x = self._embed(tokens[:, None], offset=index)
        pos = torch.arange(max_len, device=tokens.device)
        self_bias = torch.where(
            pos <= index,
            torch.zeros((), device=tokens.device),
            torch.full((), NEG_INF, device=tokens.device),
        )[None, None, None, :]
        for layer, c in zip(self.layers, cache):
            x = layer.step(x, c, index, self_bias, memory_bias)
        return self._output(x)[:, 0]


def transformer_decoder_from_config(cfg) -> TransformerDecoder:
    return TransformerDecoder(
        vocab_size=int(cfg["vocab_size"]),
        d_model=int(cfg["d_model"]),
        nhead=int(cfg["nhead"]),
        num_layers=int(cfg["num_layers"]),
        dim_feedforward=int(cfg["dim_feedforward"]),
        activation=cfg.get("activation", "relu"),
        dropout_rate=float(cfg.get("dropout_rate", 0.1)),
        remat=bool(cfg.get("remat", False)),
    )


class CIFDecoder(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        d_model: int,
        nhead: int,
        num_layers: int,
        encoder_dim: int,
        dim_feedforward: int,
        activation: str = "relu",
        dropout_rate: float = 0.1,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.dropout_rate = dropout_rate
        self.d_model = d_model
        self.emb = Embedding(vocab_size, d_model)
        self.emb.kernel_init = "xavier_normal"
        self.input_affine = nn.Linear(encoder_dim + d_model, d_model)
        self.output_affine = nn.Linear(encoder_dim + d_model, vocab_size)
        self.output_affine.kernel_init = "xavier_normal"
        for i in range(num_layers):
            self.add_module(
                f"layer{i}",
                TransformerEncoderLayer(d_model, nhead, dim_feedforward, activation,
                                        dropout_rate),
            )
        self.layers = [getattr(self, f"layer{i}") for i in range(num_layers)]

    def _hidden(self, encoded: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[TrainRNG], empty_rows: Optional[bool]) -> torch.Tensor:
        """The concatenated [CIF frames, last layer] [B, T, encoder_dim +
        d_model] in the compute dtype (flax's Dense casts the f32 CIF frames
        to its dtype the same way)."""
        x = self.emb(ids.long())
        dt = activation_dtype(x)
        x = positional_encoding(x.to(dt) * math.sqrt(self.d_model))
        x = dropout(x, self.dropout_rate, rng)
        encoded = encoded.to(dt)
        h = self.input_affine(torch.cat([encoded, x], dim=-1))
        empty_rows = any_empty(lengths, empty_rows)
        h = run_layers(self.layers, h, kv_lengths=lengths, causal=True, rng=rng,
                       empty_rows=empty_rows)
        return torch.cat([encoded, h.to(dt)], dim=-1)

    def forward(self, encoded: torch.Tensor, ids: torch.Tensor, id_lengths: torch.Tensor,
                rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None) -> torch.Tensor:
        """encoded [B, T, D] (the CIF frames, aligned with ids [B, T]) ->
        logits [B, T, V].  `empty_rows`: whether some id length is <= 0
        (None: read it back)."""
        return self.output_affine(self._hidden(encoded, ids, id_lengths, rng, empty_rows))

    def step(self, encoded: torch.Tensor, encoded_lengths: torch.Tensor,
             ids_prefix: torch.Tensor, t: int,
             empty_rows: Optional[bool] = None) -> torch.Tensor:
        """Decode step t: ids_prefix [B, T] holds the tokens so far, padded;
        -> the logits [B, V] at position t - 1 of the full forward (the
        output affine, a per-position map, runs at that position only)."""
        h = self._hidden(encoded, ids_prefix, encoded_lengths, None, empty_rows)
        return self.output_affine(h[:, t - 1])


class FCDecoder(nn.Module):
    """One linear projection to the vocabulary."""

    def __init__(self, vocab_size: int, d_input: int):
        super().__init__()
        self.output_affine = nn.Linear(d_input, vocab_size)
        self.output_affine.kernel_init = "xavier_normal"

    def forward(self, encoded: torch.Tensor) -> torch.Tensor:
        return self.output_affine(encoded)


def cif_decoder_from_config(cfg) -> CIFDecoder:
    return CIFDecoder(
        vocab_size=int(cfg["vocab_size"]),
        d_model=int(cfg["d_model"]),
        nhead=int(cfg["nhead"]),
        num_layers=int(cfg["num_layers"]),
        encoder_dim=int(cfg.get("encoder_dim", cfg["d_model"])),
        dim_feedforward=int(cfg["dim_feedforward"]),
        activation=cfg.get("activation", "relu"),
        dropout_rate=float(cfg.get("dropout_rate", 0.1)),
    )
