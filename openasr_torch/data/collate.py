"""Collates: sample dicts -> padded NumPy batches with quantized shapes.

Counterpart of `FeatureCollate`, `WaveCollate` and `load_wave_batch` in
openasr_tpu/data/collate.py.  Padded
dimensions are rounded up onto the same geometric ladder as the JAX
package, so both packages see identical batch shapes.  Batches are dicts
of NumPy arrays plus a "uttids" list:
  ids [B,U] int32        decoder inputs, starting with <sos>
  labels [B,U] int32     shifted targets
  paddings [B,U] f32     1.0 at PADDED label positions
plus `feats [B,T,D]` f32 / `feat_lengths [B]` (frames) for features, or
`waves [B,N]` f32 in the int16 PCM scale / `wave_lengths [B]` (samples)
for waves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from openasr_torch.data import kaldi_io
from openasr_torch.data.audio import load_wave
from openasr_torch.data.tokenizer import EOS_ID, SOS_ID


def geometric_ladder(lo: int = 8, hi: int = 1 << 20, ratio: float = 1.25) -> List[int]:
    """Increasing sizes lo, ~lo*r, ... rounded to multiples of 8."""
    out = [lo]
    x = float(lo)
    while out[-1] < hi:
        x *= ratio
        v = int(math.ceil(x / 8.0) * 8)
        if v > out[-1]:
            out.append(v)
    return out


_LADDER = geometric_ladder()


def quantize(n: int, enable: bool = True) -> int:
    """Round n up to the ladder (padding waste <= 25%)."""
    if not enable:
        return n
    for v in _LADDER:
        if v >= n:
            return v
    return n


def gen_causal_targets(
    idslist: List[List[int]],
    add_eos: bool,
    sos_id: int = SOS_ID,
    eos_id: int = EOS_ID,
    max_len: Optional[int] = None,
):
    """-> (ids, labels, paddings)."""
    with_sym = [
        [sos_id] + ids + ([eos_id] if add_eos else []) for ids in idslist
    ]
    lens = [len(s) for s in with_sym]
    ml = max(lens)
    if max_len is not None:
        ml = max(ml, max_len + 1)
    raw = np.full((len(with_sym), ml), eos_id, dtype=np.int32)
    pad = np.ones((len(with_sym), ml), dtype=np.float32)
    for i, s in enumerate(with_sym):
        raw[i, : len(s)] = s
        pad[i, : len(s)] = 0.0
    return raw[:, :-1], raw[:, 1:], pad[:, 1:]


def load_wave_batch(paths: List[str], quantize_shapes=True, expected_rate=None):
    """Waves padded to the ladder, and their sample counts.  `expected_rate`
    (the model's signal.sample_rate), when given, is checked against every
    file: the fbank geometry derives from it, so an 8 kHz file in a 16 kHz
    config would give features at the wrong time and frequency scale."""
    waves, lengths = [], []
    for p in paths:
        rate, w = load_wave(p)
        if expected_rate is not None and int(rate) != int(expected_rate):
            raise ValueError(
                f"{p}: sample rate {rate} != configured {expected_rate}; "
                "resample offline or fix signal.sample_rate"
            )
        waves.append(w.astype(np.float32))
        lengths.append(len(w))
    n = quantize(max(lengths), quantize_shapes)
    out = np.zeros((len(waves), n), np.float32)
    for i, w in enumerate(waves):
        out[i, : len(w)] = w
    return out, np.asarray(lengths, np.int32)


def load_feat_batch(paths: List[str], quantize_shapes=True):
    feats, lengths = [], []
    for p in paths:
        m = kaldi_io.read_mat(p, writable=False)
        feats.append(m)
        lengths.append(m.shape[0])
    t = quantize(max(lengths), quantize_shapes)
    out = np.empty((len(feats), t, feats[0].shape[1]), np.float32)
    for i, m in enumerate(feats):
        out[i, : m.shape[0]] = m
        out[i, m.shape[0]:] = 0.0
    return out, np.asarray(lengths, np.int32)


class FeatureCollate:
    """Offline features + causal targets."""

    def __init__(self, tokenizer, add_eos=False, label_type="tokens",
                 quantize_shapes=True):
        self.tokenizer = tokenizer
        self.add_eos = add_eos
        self.label_type = label_type
        self.quantize_shapes = quantize_shapes

    def __call__(self, batch: List[dict]) -> Dict:
        feats, feat_lengths = load_feat_batch(
            [d["feat"] for d in batch], self.quantize_shapes
        )
        rawids = [self.tokenizer.encode(d[self.label_type]) for d in batch]
        umax = quantize(
            max(len(r) for r in rawids) + 2, self.quantize_shapes
        )
        ids, labels, paddings = gen_causal_targets(
            rawids, self.add_eos, max_len=umax
        )
        return {
            "uttids": [d["uttid"] for d in batch],
            "feats": feats,
            "feat_lengths": feat_lengths,
            "ids": ids,
            "labels": labels,
            "paddings": paddings,
        }


class WaveCollate:
    """Online waves + causal targets."""

    def __init__(self, tokenizer, add_eos=False, label_type="tokens",
                 quantize_shapes=True, expected_rate=None):
        self.tokenizer = tokenizer
        self.add_eos = add_eos
        self.label_type = label_type
        self.quantize_shapes = quantize_shapes
        self.expected_rate = expected_rate

    def __call__(self, batch: List[dict]) -> Dict:
        waves, wave_lengths = load_wave_batch(
            [d["feat"] for d in batch], self.quantize_shapes,
            expected_rate=self.expected_rate,
        )
        rawids = [self.tokenizer.encode(d[self.label_type]) for d in batch]
        umax = quantize(max(len(r) for r in rawids) + 2, self.quantize_shapes)
        ids, labels, paddings = gen_causal_targets(
            rawids, self.add_eos, max_len=umax
        )
        return {
            "uttids": [d["uttid"] for d in batch],
            "waves": waves,
            "wave_lengths": wave_lengths,
            "ids": ids,
            "labels": labels,
            "paddings": paddings,
        }
