"""Additive attention-bias helpers.

Counterpart of openasr_tpu/ops/masks.py.  Biases are float32 tensors,
0 at valid positions and NEG_INF at masked ones.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e9


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] lengths -> [B, maxlen] bool, True at valid frames."""
    pos = torch.arange(maxlen, device=lengths.device)
    return pos[None, :] < lengths.to(torch.int64)[:, None]


def padding_bias(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, 1, maxlen] additive key-padding bias."""
    valid = sequence_mask(lengths, maxlen)
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=lengths.device)
    return torch.where(valid, zero, neg)[:, None, None, :]


def causal_bias(length: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] additive causal bias (position t attends to <= t)."""
    pos = torch.arange(length, device=device)
    ok = pos[None, :] <= pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(ok, zero, neg)[None, None]


def combine_bias(*biases):
    """Sum additive biases, clamping so stacked NEG_INFs stay finite."""
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return torch.clamp(out, min=NEG_INF) if out is not None else None
