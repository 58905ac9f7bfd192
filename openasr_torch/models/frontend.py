"""Signal front-end.

Counterpart of `SPLayer` in openasr_tpu/models/frontend.py: `offline`
passes precomputed features through; `fbank` computes log-mel features
from raw waves (ops/fbank.py, through the fused fbank kernel on a card),
with Kaldi dither in a training forward when the config asks for it
(noise from `rng.device`).  In a training forward (given a `TrainRNG`)
SpecAugment then masks the features with widths drawn from `rng.host`.
The frontend has no parameters and always runs in f32 with autocast off,
as the JAX SPLayer has no dtype: fbank feeds a log.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openasr_torch.models.layers import TrainRNG, autocast_off
from openasr_torch.ops.fbank import FbankConfig, fbank, num_frames_of
from openasr_torch.ops.specaug import spec_aug, spec_aug_config_from_cfg


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
                inputs = spec_aug(inputs.float(), lengths, self.spec_aug, generator=rng.host)
        return inputs, lengths
