"""Signal front-end.

Counterpart of `SPLayer` in openasr_tpu/models/frontend.py, offline path:
precomputed features pass through, and in a training forward (given a
`TrainRNG`) SpecAugment masks them with widths drawn from `rng.host`.
The frontend always runs in f32.  The online wave frontend (fbank, its
fused kernel, dither) is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from openasr_torch.models.layers import TrainRNG
from openasr_torch.ops.specaug import spec_aug, spec_aug_config_from_cfg


class SPLayer(nn.Module):
    def __init__(self, feature_type: str = "offline", spec_aug_cfg=None):
        super().__init__()
        if feature_type == "fbank":
            raise NotImplementedError(
                "signal.feature_type: fbank (online wave frontend) is not "
                "ported yet: ROADMAP queue 1 item 8, with the fused fbank "
                "kernel (queue 2 kernel 7)"
            )
        if feature_type != "offline":
            raise ValueError(f"Unknown feature type {feature_type}")
        self.feature_type = feature_type
        self.spec_aug = spec_aug_config_from_cfg(spec_aug_cfg) if spec_aug_cfg else None

    def forward(self, inputs, lengths, rng: Optional[TrainRNG] = None):
        if rng is not None and self.spec_aug is not None:
            inputs = spec_aug(inputs.float(), lengths, self.spec_aug, generator=rng.host)
        return inputs, lengths
