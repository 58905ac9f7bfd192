"""CIF attention assigners: a convolution stack -> one sigmoid weight a frame.

Counterpart of openasr_tpu/models/assigner.py.  `AttentionAssigner` pads
its input once on the right by n_layers * w_context frames, runs the
VALID Conv1d stack with ReLUs and keeps the first T frames (padding each
layer instead would feed the next layer zeros where the reference feeds
it the previous layer's outputs over the pad).  `AttentionAssigner2D`
(`assigner.type: 2d`) runs a 32-channel 3x3 Conv2d over the (time,
feature) plane, padded by 2 on the right of both, then n_layers - 1 1x1
convs, each ReLU'd, and an affine [32 * D -> d_model], with stride 1 in
time so that the weights align with the encoder frames.  Both end in
dropout, a linear to one unit and a sigmoid in f32, masked by the
lengths.  Linear layers keep flax's default initializer (lecun_normal).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.models.layers import TrainRNG, dropout
from openasr_torch.ops.masks import sequence_mask


def _lecun_linear(d_in: int, d_out: int) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    layer.kernel_init = "lecun_normal"
    return layer


def _weights(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """sigmoid in f32, 0 past each row's length."""
    alphas = torch.sigmoid(logits.float())
    return alphas * sequence_mask(lengths, logits.shape[1]).float()


class AttentionAssigner(nn.Module):
    def __init__(self, input_dim: int, d_model: int, n_layers: int, w_context: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_layers, self.w_context = n_layers, w_context
        self.dropout_rate = dropout_rate
        for i in range(n_layers):
            self.add_module(f"conv{i}", nn.Conv1d(input_dim if i == 0 else d_model,
                                                  d_model, w_context))
        self.convs = [getattr(self, f"conv{i}") for i in range(n_layers)]
        self.linear = _lecun_linear(d_model, 1)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[TrainRNG] = None) -> torch.Tensor:
        """x [B, T, D] -> alphas [B, T] f32."""
        t = x.shape[1]
        h = F.pad(x.transpose(1, 2), (0, self.n_layers * self.w_context))
        for conv in self.convs:
            h = F.relu(conv(h))
        h = dropout(h[..., :t].transpose(1, 2), self.dropout_rate, rng)
        return _weights(self.linear(h)[..., 0], lengths)


class AttentionAssigner2D(nn.Module):
    CHANNELS = 32

    def __init__(self, input_dim: int, d_model: int, n_layers: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        c = self.CHANNELS
        self.dropout_rate = dropout_rate
        self.conv0 = nn.Conv2d(1, c, 3)
        for i in range(1, n_layers):
            self.add_module(f"conv{i}", nn.Conv2d(c, c, 1))
        self.convs = [getattr(self, f"conv{i}") for i in range(n_layers)]
        # flax flattens [B, T, D, C] channels last: input index d * C + c
        self.affine = _lecun_linear(c * input_dim, d_model)
        self.linear = _lecun_linear(d_model, 1)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[TrainRNG] = None) -> torch.Tensor:
        """x [B, T, D] -> alphas [B, T] f32."""
        b, t, d = x.shape
        h = F.pad(x[:, None], (0, 2, 0, 2))                  # [B, 1, T + 2, D + 2]
        for conv in self.convs:
            h = F.relu(conv(h))
        h = h[:, :, :t, :d].permute(0, 2, 3, 1).reshape(b, t, d * self.CHANNELS)
        h = dropout(self.affine(h), self.dropout_rate, rng)
        return _weights(self.linear(h)[..., 0], lengths)


def assigner_from_config(cfg, input_dim: int) -> nn.Module:
    """`model.assigner`: the 1-D stack, or the 2-D one for `type: 2d`
    (or `conv2d`); `input_dim` is the encoder's width."""
    if str(cfg.get("type", "1d")).lower() in ("2d", "conv2d"):
        return AttentionAssigner2D(input_dim, int(cfg["d_model"]), int(cfg["n_layers"]),
                                   float(cfg.get("dropout", 0.0)))
    return AttentionAssigner(input_dim, int(cfg["d_model"]), int(cfg["n_layers"]),
                             int(cfg["w_context"]), float(cfg.get("dropout", 0.0)))
