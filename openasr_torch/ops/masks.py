"""Additive attention-bias helpers.

Counterpart of openasr_tpu/ops/masks.py.  Biases are float32 tensors,
0 at valid positions and NEG_INF at masked ones.
"""

from __future__ import annotations

from typing import NamedTuple

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


class ChunkMask(NamedTuple):
    """The chunk-attention mask of a streaming encoder (`chunk_bias`):
    chunks of `chunk` frames, `left` chunks of left context (all earlier
    chunks when < 0), frames shifted by `phase`."""

    chunk: int
    left: int = -1
    phase: int = 0


def chunk_bias(length: int, chunk: int, left_chunks: int = -1, phase: int = 0,
               device=None) -> torch.Tensor:
    """[1, 1, T, T] additive chunk-attention bias (openasr_tpu/ops/masks.py:
    chunk_bias): frame t lies in chunk (t + phase) // chunk and attends to
    the frames of chunks [c - left_chunks, c] (every earlier chunk when
    left_chunks < 0), within its own chunk without restriction.  `phase`
    aligns the training chunks with the streaming executor's start-up
    slots (openasr_torch/streaming.py)."""
    pos = torch.arange(length, device=device)
    qc = ((pos + phase) // chunk)[:, None]
    kc = ((pos + phase) // chunk)[None, :]
    ok = kc <= qc
    if left_chunks >= 0:
        ok = ok & (kc >= qc - left_chunks)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(ok, zero, neg)[None, None]
