"""Signal front-ends: SPLayer and the WavConv raw-wave encoder.

Counterpart of openasr_tpu/models/frontend.py.  `SPLayer`: `offline`
passes precomputed features through; `fbank` computes log-mel features
from raw waves (ops/fbank.py, through the fused fbank kernel on a card),
with Kaldi dither in a training forward when the config asks for it
(noise from `rng.device`).  In a training forward (given a `TrainRNG`)
SpecAugment then masks the features with widths drawn from `rng.host`.
The frontend has no parameters and always runs in f32 with autocast off,
as the JAX SPLayer has no dtype: fbank feeds a log.

`WavConv` (CPC, GRU-CTC, wav2vec): five strided Conv1d + BatchNorm + ReLU
layers, x160 in all, on raw waves.  Its `BatchNorm` is flax's
(`nn.BatchNorm(momentum=0.9)`), not torch's: statistics in f32 over every
padded sample, the variance E[x^2] - E[x]^2 (biased, clipped at 0) both to
normalise and to update the running statistics (torch's BatchNorm1d keeps
the unbiased variance), which live in the buffers `mean` and `var`, the
JAX package's `batch_stats`; under data parallelism (`group`, set by the
solver) the statistics are the global batch's, over the reconciled padded
length.  The convolutions stay cuDNN (PyTorch)
calls, as the JAX package computes them outside any Pallas kernel.  Each
layer zero-pads its input explicitly and convolves with padding 0 (the
same sums): on the CPU, oneDNN's f32 conv1d input gradient with a padding
argument is wrong at some strided shapes of 256 channels and more (the
first output frames of some channel blocks; e.g. [2, 256, 157] at kernel
4, stride 2, padding 1, tests/test_torch_wavconv_precision.py), which put
the CPU's f32 frontend gradient percents off float64 (ROADMAP queue 3
item 26).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

import torch.nn.functional as F

from openasr_torch.models.layers import TrainRNG, autocast_off
from openasr_torch.ops.fbank import FbankConfig, fbank, num_frames_of
from openasr_torch.ops.specaug import spec_aug, spec_aug_config_from_cfg
from openasr_torch.parallel.mesh import DataGroup, all_reduce_with_grad


class SPLayer(nn.Module):
    def __init__(self, feature_type: str = "offline",
                 fbank_config: Optional[FbankConfig] = None, spec_aug_cfg=None,
                 apply_dither: bool = False):
        super().__init__()
        if feature_type not in ("offline", "fbank"):
            raise ValueError(f"Unknown feature type {feature_type}")
        self.feature_type = feature_type
        self.fbank_config = fbank_config or FbankConfig()
        self.spec_aug = spec_aug_config_from_cfg(spec_aug_cfg) if spec_aug_cfg else None
        self.apply_dither = apply_dither

    def output_lengths(self, lengths):
        """Feature frames of `lengths` inputs (samples for fbank, frames
        offline), for host NumPy lengths or a tensor alike."""
        if self.feature_type == "fbank":
            return num_frames_of(lengths, self.fbank_config)
        return lengths

    def forward(self, inputs, lengths, rng: Optional[TrainRNG] = None):
        with autocast_off(inputs.device.type):
            if self.feature_type == "fbank":
                dither = rng.device if rng is not None and self.apply_dither else None
                inputs, lengths = fbank(inputs, lengths, self.fbank_config, dither)
            if rng is not None and self.spec_aug is not None:
                inputs = spec_aug(inputs.float(), lengths, self.spec_aug, generator=rng.host,
                                  rows=(rng.rank, rng.world))
        return inputs, lengths


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channels of [B, C, T]: momentum 0.9 (the
    retention of the running statistics), epsilon 1e-5.  `train` normalises
    with the batch's statistics and updates the running ones; otherwise
    it normalises with the running ones.  Statistics, weight and bias stay
    f32 in any compute dtype; the output takes the input's dtype."""

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = DataGroup.single()  # statistics over this group's global batch

    def _moments(self, xf: torch.Tensor):
        """E[x] and E[x^2] per channel over the global batch and time: the
        channel sums and the count all-reduced over the data group, with the
        gradient flowing back through the sum, as through flax's mean over
        a `data`-sharded batch."""
        c = xf.shape[1]
        sums = all_reduce_with_grad(self.group, torch.cat([
            xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2)),
            xf.new_full((1,), float(xf.shape[0] * xf.shape[2]))]))
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def reset_running_stats(self) -> None:
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        with autocast_off(x.device.type):
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if train:
                mean, ex2 = self._moments(xf)
                var = torch.clamp(ex2 - mean * mean, min=0.0)
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                    self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
            else:
                mean, var = self.mean, self.var
            mul = torch.rsqrt(var + self.epsilon) * self.weight
            y = (xf - mean[:, None]) * mul[:, None] + self.bias[:, None]
        return y.to(x.dtype)


class WavConv(nn.Module):
    """Raw waves [B, N] -> ([B, T', d_model], wave_lengths // 160), T' the
    padded length's (no masking: padded samples enter the statistics, as
    in the JAX package)."""

    LAYERS = ((10, 5, 3), (8, 4, 2), (4, 2, 1), (4, 2, 1), (4, 2, 1))

    def __init__(self, d_model: int):
        super().__init__()
        c_in = 1
        for i, (k, s, p) in enumerate(self.LAYERS):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, d_model, k, s, 0, bias=False))
            self.add_module(f"bn{i}", BatchNorm(d_model))
            c_in = d_model

    @staticmethod
    def output_lengths(lengths):
        """Frames of `lengths` samples (torch or NumPy)."""
        return lengths // 160

    def forward(self, waves: torch.Tensor, wave_lengths: torch.Tensor, train: bool = False):
        # the first weight's dtype: f32 under autocast (which casts), the
        # model's dtype for inference
        x = waves[:, None, :].to(self.conv0.weight.dtype)
        for i, (_, _, p) in enumerate(self.LAYERS):
            x = getattr(self, f"conv{i}")(F.pad(x, (p, p)))
            x = F.relu(getattr(self, f"bn{i}")(x, train))
        return x.transpose(1, 2), self.output_lengths(wave_lengths)
