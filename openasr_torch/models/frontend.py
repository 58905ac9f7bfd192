"""Signal front-end.

Counterpart of `SPLayer` in openasr_tpu/models/frontend.py, offline path
only: precomputed features pass through unchanged, and decoding never
applies SpecAugment.  The online wave frontend (fbank, its fused kernel,
SpecAugment, dither) is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from torch import nn


class SPLayer(nn.Module):
    def __init__(self, feature_type: str = "offline"):
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

    def forward(self, inputs, lengths):
        return inputs, lengths
