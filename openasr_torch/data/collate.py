"""Collates: sample dicts -> padded NumPy batches with quantized shapes.

Counterpart of `FeatureCollate`, `WaveCollate`, `WaveOnlyCollate`,
`load_wave_batch` and the
phone collates of the CIF families (`PhoneCharCollate`, `FeatPhoneCollate`,
`FeatPhoneCharCollate`), the GAN's unpaired `TokenCollate` and the LMs'
`TextCollate` in openasr_tpu/data/collate.py.  Padded
dimensions are rounded up onto the same geometric ladder as the JAX
package, so both packages see identical batch shapes.  Batches are dicts
of NumPy arrays plus a "uttids" list:
  ids [B,U] int32        decoder inputs, starting with <sos>
  labels [B,U] int32     shifted targets
  paddings [B,U] f32     1.0 at PADDED label positions
plus `feats [B,T,D]` f32 / `feat_lengths [B]` (frames) for features, or
`waves [B,N]` f32 in the int16 PCM scale / `wave_lengths [B]` (samples)
for waves, and `phones [B,P]` int32 (padded with <eos>) / `phone_lengths
[B]` (counted when encoded, not recounted from the padding) for phones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

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


def pad_list(seqs: Sequence[np.ndarray], pad_value,
             max_len: Optional[int] = None) -> np.ndarray:
    """Rows padded with `pad_value` to `max_len` (default: the longest)."""
    ml = max_len if max_len is not None else max(len(q) for q in seqs)
    out = np.full((len(seqs), ml), pad_value, dtype=np.asarray(seqs[0]).dtype)
    for i, q in enumerate(seqs):
        out[i, : len(q)] = q
    return out


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


class WaveOnlyCollate:
    """Waves without labels (CPC pretraining): `uttids`, `waves`,
    `wave_lengths`."""

    def __init__(self, quantize_shapes=True):
        self.quantize_shapes = quantize_shapes

    def __call__(self, batch: List[dict]) -> Dict:
        waves, wave_lengths = load_wave_batch([d["feat"] for d in batch],
                                              self.quantize_shapes)
        return {
            "uttids": [d["uttid"] for d in batch],
            "waves": waves,
            "wave_lengths": wave_lengths,
        }


class PhoneCharCollate:
    """Phone ids in, char causal targets out."""

    def __init__(self, tokenizer_phone, tokenizer_char, add_eos=False,
                 quantize_shapes=True):
        self.tokenizer_phone = tokenizer_phone
        self.tokenizer_char = tokenizer_char
        self.add_eos = add_eos
        self.quantize_shapes = quantize_shapes

    def phones_of(self, batch):
        phones = [np.asarray(self.tokenizer_phone.encode(d["phones"]), np.int32)
                  for d in batch]
        lens = np.asarray([len(p) for p in phones], np.int32)
        return pad_list(phones, EOS_ID, quantize(int(lens.max()), self.quantize_shapes)), lens

    def chars_of(self, batch):
        rawids = [self.tokenizer_char.encode(d["tokens"]) for d in batch]
        umax = quantize(max(len(r) for r in rawids) + 2, self.quantize_shapes)
        return gen_causal_targets(rawids, self.add_eos, max_len=umax)

    def __call__(self, batch: List[dict]) -> Dict:
        phones, phone_lengths = self.phones_of(batch)
        ids, labels, paddings = self.chars_of(batch)
        return {"uttids": [d["uttid"] for d in batch], "phones": phones,
                "phone_lengths": phone_lengths, "ids": ids, "labels": labels,
                "paddings": paddings}


class FeatPhoneCollate(PhoneCharCollate):
    """Features + phone targets (CIF_FC, CIF_MIX's acoustic batches)."""

    def __init__(self, tokenizer_phone, quantize_shapes=True):
        self.tokenizer_phone = tokenizer_phone
        self.quantize_shapes = quantize_shapes

    def __call__(self, batch: List[dict]) -> Dict:
        feats, feat_lengths = load_feat_batch([d["feat"] for d in batch],
                                              self.quantize_shapes)
        phones, phone_lengths = self.phones_of(batch)
        return {"uttids": [d["uttid"] for d in batch], "feats": feats,
                "feat_lengths": feat_lengths, "phones": phones,
                "phone_lengths": phone_lengths}


class FeatPhoneCharCollate(PhoneCharCollate):
    """Features + phones + char targets (CIF_MIX's paired batches)."""

    def __call__(self, batch: List[dict]) -> Dict:
        feats, feat_lengths = load_feat_batch([d["feat"] for d in batch],
                                              self.quantize_shapes)
        return {**PhoneCharCollate.__call__(self, batch), "feats": feats,
                "feat_lengths": feat_lengths}


class TokenCollate:
    """Unpaired token lines -> `tokens [B, T]` int32 padded with <eos> to
    the quantized length, and `token_lengths [B]`."""

    def __init__(self, tokenizer, quantize_shapes=True):
        self.tokenizer = tokenizer
        self.quantize_shapes = quantize_shapes

    def __call__(self, batch: List[str]) -> Dict:
        toks = [np.asarray(self.tokenizer.encode(t), np.int32) for t in batch]
        lens = np.asarray([len(t) for t in toks], np.int32)
        return {"tokens": pad_list(toks, EOS_ID, quantize(int(lens.max()), self.quantize_shapes)),
                "token_lengths": lens}


class TextCollate:
    """Text lines -> causal LM targets: ids (<sos> first), labels (<eos>
    last) and paddings, each line cut to `maxlen` tokens first (no
    "uttids")."""

    def __init__(self, tokenizer, maxlen: Optional[int] = None, quantize_shapes: bool = True):
        self.tokenizer = tokenizer
        self.maxlen = maxlen
        self.quantize_shapes = quantize_shapes

    def __call__(self, batch: List[str]) -> Dict:
        rawids = [self.tokenizer.encode(t) for t in batch]
        if self.maxlen:
            rawids = [r[: self.maxlen] for r in rawids]
        umax = quantize(max(len(r) for r in rawids) + 2, self.quantize_shapes)
        ids, labels, paddings = gen_causal_targets(rawids, True, max_len=umax)
        return {"ids": ids, "labels": labels, "paddings": paddings}
