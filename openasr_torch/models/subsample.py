"""Convolutional subsampling front-ends.

Counterpart of openasr_tpu/models/subsample.py: ConvV1 (two 3x3 VALID convs,
stride 2 in time and frequency) and ConvV2 (`layer_num` 3x3 VALID convs,
stride 2 in time only), each followed by the output affine over
(channel, frequency), and Stack (one strided VALID 1-D conv over time, then
LayerNorm).  The 2-D convolutions run NCHW over [B, 1, T, F] with OIHW
weights, the 1-D one NCW with OIW weights; the JAX package runs NHWC / NWC
with HWIO / WIO kernels (openasr_torch/convert.py translates).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.models.layers import LayerNorm


def conv_out_len(length, kernel: int, stride: int):
    """VALID conv output length (torch or NumPy integers)."""
    return (length - kernel) // stride + 1


class _FoldedAffine(nn.Linear):
    """The subsamplers' output affine over the flattened (channel, freq)
    axes with rows ordered c*F + f — the JAX `_FoldedAffine` kernel
    [C*F, M] transposed.  Takes the conv output [B, C, T, F]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, f = x.shape
        return super().forward(x.permute(0, 2, 1, 3).reshape(b, t, c * f))


class _ConvSubsample(nn.Module):
    """`layers` ReLU(conv 3x3 VALID, 32 channels) with the given stride
    (time, freq), then the folded affine to d_model."""

    def __init__(self, d_input: int, d_model: int, layers: int, stride):
        super().__init__()
        self.d_input = d_input
        self.stride = stride
        freq = d_input
        for i in range(layers):
            self.add_module(f"conv{i}", nn.Conv2d(1 if i == 0 else 32, 32, 3, stride))
            freq = (freq - 3) // stride[1] + 1
        self.convs = [getattr(self, f"conv{i}") for i in range(layers)]
        self.affine = _FoldedAffine(32 * freq, d_model)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats[:, None]  # [B, 1, T, F]
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.affine(x)


class Conv2dSubsample(_ConvSubsample):
    """ESPNet ConvV1: two 3x3 VALID convs with stride 2 in time and freq."""

    def __init__(self, d_input: int, d_model: int):
        super().__init__(d_input, d_model, 2, (2, 2))

    @staticmethod
    def output_lengths(lengths):
        """Frames left after subsampling (torch or NumPy integers)."""
        for _ in range(2):
            lengths = (lengths - 3) // 2 + 1
        return lengths

    def forward(self, feats, feat_lengths):
        return super().forward(feats), self.output_lengths(feat_lengths)


class Conv2dSubsampleV2(_ConvSubsample):
    """ConvV2: `layer_num` 3x3 VALID convs, stride 2 in time / 1 in freq."""

    def __init__(self, d_input: int, d_model: int, layer_num: int = 2):
        super().__init__(d_input, d_model, layer_num, (2, 1))
        self.layer_num = layer_num

    def forward(self, feats, feat_lengths):
        if feats.shape[-1] != self.d_input:
            raise ValueError(
                f"encoder input_dim={self.d_input} does not match the feature "
                f"dim actually produced upstream ({feats.shape[-1]}) — check "
                "model.encoder.input_dim against the offline feature width"
            )
        return super().forward(feats), self.output_lengths(feat_lengths)

    def output_lengths(self, lengths):
        """Frames left after subsampling (torch or NumPy integers), by the
        JAX package's length rule."""
        for _ in range(self.layer_num):
            lengths = (lengths - 1) // 2
        return lengths


class Conv1dSubsample(nn.Module):
    """Stack: one 1-D conv of `context_width` frames with stride
    `subsample`, VALID, from the features to d_model, then LayerNorm (the
    LayerNorm kernels on the card)."""

    def __init__(self, d_input: int, d_model: int, context_width: int, subsample: int):
        super().__init__()
        self.context_width = context_width
        self.subsample = subsample
        self.conv = nn.Conv1d(d_input, d_model, context_width, subsample)
        self.norm = LayerNorm(d_model)

    def output_lengths(self, lengths):
        return conv_out_len(lengths, self.context_width, self.subsample)

    def forward(self, feats, feat_lengths):
        x = self.conv(feats.transpose(1, 2)).transpose(1, 2)
        return self.norm(x), self.output_lengths(feat_lengths)
