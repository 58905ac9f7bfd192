"""SpecAugment with per-example mask widths, in plain PyTorch.

Counterpart of openasr_tpu/ops/specaug.py, with its two quirks of the
reference: masked regions are filled with feature MEANS (frequency masks
with the per-(batch, frame) mean over bins, time masks with the
per-(batch, bin) mean over valid frames), and the fill means come from the
unmasked features.  Widths and starts follow the same formulas, including
the wrap of a negative frequency start and the empty time mask when the
drawn width exceeds the utterance.

The uniform draws [masks, 2, B] come from a torch.Generator (for the
global batch under data parallelism); tests may pass them in, so both
packages see the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from openasr_torch.parallel.mesh import rand_rows


class SpecAugConfig(NamedTuple):
    freq_mask_num: int = 2
    freq_mask_width: int = 27
    time_mask_num: int = 2
    time_mask_width: int = 40


def spec_aug_config_from_cfg(cfg) -> SpecAugConfig:
    return SpecAugConfig(
        freq_mask_num=int(cfg["freq_mask_num"]),
        freq_mask_width=int(cfg["freq_mask_width"]),
        time_mask_num=int(cfg["time_mask_num"]),
        time_mask_width=int(cfg["time_mask_width"]),
    )


def _interval_mask(size: int, starts: torch.Tensor, widths: torch.Tensor):
    """[B] starts/widths -> [B, size] bool, True inside [start, start+width)."""
    pos = torch.arange(size, device=starts.device)[None, :]
    return (pos >= starts[:, None]) & (pos < (starts + widths)[:, None])


def spec_aug(
    feats: torch.Tensor,
    feat_lengths: torch.Tensor,
    cfg: SpecAugConfig,
    generator: Optional[torch.Generator] = None,
    u_freq: Optional[torch.Tensor] = None,
    u_time: Optional[torch.Tensor] = None,
    rows: Tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Apply SpecAugment.  feats: [B, T, V] zero-padded; lengths: [B].
    `u_freq` [freq_mask_num, 2, B] and `u_time` [time_mask_num, 2, B] are
    the uniform draws; missing ones are drawn from `generator` (CPU), for
    the global batch of a data-parallel `rows` = (rank, world), of which
    this rank keeps its B rows."""
    b, t, v = feats.shape
    dev = feats.device
    lengths = feat_lengths.to(dev)
    lengths_f = lengths.float().clamp(min=1.0)

    def draws(u, n):
        if u is None:
            u = rand_rows(generator, (n, 2, b), 2, *rows)
        return u.to(dev, torch.float32)

    freq_means = feats.mean(dim=-1)                          # [B, T]
    time_means = feats.sum(dim=1) / lengths_f[:, None]       # [B, V]

    if cfg.freq_mask_num > 0:
        u = draws(u_freq, cfg.freq_mask_num)
        masked = torch.zeros((b, v), dtype=torch.bool, device=dev)
        for i in range(cfg.freq_mask_num):
            widths = (cfg.freq_mask_width * u[i, 0]).to(torch.int32)
            starts = ((v - widths).float() * u[i, 1]).to(torch.int32)
            starts = torch.where(starts < 0, (v + starts).clamp(min=0), starts)
            masked |= _interval_mask(v, starts, widths)
        feats = torch.where(masked[:, None, :], freq_means[:, :, None], feats)

    if cfg.time_mask_num > 0:
        u = draws(u_time, cfg.time_mask_num)
        masked = torch.zeros((b, t), dtype=torch.bool, device=dev)
        for i in range(cfg.time_mask_num):
            widths = (cfg.time_mask_width * u[i, 0]).to(torch.int32)
            widths = torch.where(widths > lengths.to(torch.int32), 0, widths)
            starts = ((lengths.float() - widths) * u[i, 1]).to(torch.int32)
            masked |= _interval_mask(t, starts, widths)
        feats = torch.where(masked[:, :, None], time_means[:, None, :], feats)
    return feats
