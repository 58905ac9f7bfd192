"""CTC prefix beam search (Hannun et al. 2014) on the host.

Counterpart of openasr_tpu/ops/prefix_beam.py.  `CTCPrefixBeamDecoder` is
the NumPy version, the oracle the other two decoders are held to.
`NativeCTCPrefixBeamDecoder` binds the repo's C++ decoder
(native/ctc_decoder/ctc_prefix_beam.cc, multithreaded over the batch)
through ctypes; `make_decoder` returns it.

The C++ library is built at first use with the flags of
native/ctc_decoder/Makefile into `openasr_torch/kernels/build/` (git-ignored),
named by a hash of the source and flags, and written by an atomic rename,
so concurrent processes never load a half-written file.  Nothing is built
in `native/`.  A failed build raises with the compiler's output; there is
no fallback to the NumPy decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from openasr_torch.kernels import BUILD_DIR

NATIVE_SOURCE = (Path(__file__).resolve().parents[2] / "native" / "ctc_decoder"
                 / "ctc_prefix_beam.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

LOG_ZERO = -math.inf


def log_add(a: float, b: float) -> float:
    if a == LOG_ZERO:
        return b
    if b == LOG_ZERO:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


@dataclass
class Hypothesis:
    tokens: Tuple[int, ...]
    score: float
    times: Tuple[int, ...] = field(default_factory=tuple)


class CTCPrefixBeamDecoder:
    """n-best CTC prefix beam search over [T, V] log-probs."""

    def __init__(self, beam_width: int = 10, blank_id: int = 0,
                 cutoff_top_n: int = 40, cutoff_logp: float = -20.0):
        self.beam_width = beam_width
        self.blank_id = blank_id
        self.cutoff_top_n = cutoff_top_n
        self.cutoff_logp = cutoff_logp

    def decode(self, log_probs: np.ndarray, length: int | None = None
               ) -> List[Hypothesis]:
        t_max, vocab = log_probs.shape
        if length is not None:
            t_max = min(t_max, int(length))
        blank = self.blank_id

        # prefix -> (log p ending in blank, log p ending in non-blank)
        beams: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, LOG_ZERO)}
        for t in range(t_max):
            frame = log_probs[t]
            top_n = min(self.cutoff_top_n, vocab)
            cand = np.argpartition(frame, -top_n)[-top_n:]
            cand = cand[frame[cand] >= self.cutoff_logp]
            if blank not in cand:
                cand = np.append(cand, blank)

            new_beams: Dict[Tuple[int, ...], Tuple[float, float]] = {}

            def acc(prefix, pb=LOG_ZERO, pnb=LOG_ZERO):
                old_pb, old_pnb = new_beams.get(prefix, (LOG_ZERO, LOG_ZERO))
                new_beams[prefix] = (log_add(old_pb, pb), log_add(old_pnb, pnb))

            for prefix, (p_b, p_nb) in beams.items():
                p_tot = log_add(p_b, p_nb)
                last = prefix[-1] if prefix else -1
                for c in cand:
                    lp = float(frame[c])
                    if c == blank:
                        acc(prefix, pb=p_tot + lp)
                    elif c == last:
                        # a repeat without a blank between stays the same
                        # prefix; after a blank it is a new token
                        acc(prefix, pnb=p_nb + lp)
                        acc(prefix + (int(c),), pnb=p_b + lp)
                    else:
                        acc(prefix + (int(c),), pnb=p_tot + lp)

            beams = dict(sorted(new_beams.items(), key=lambda kv: log_add(*kv[1]),
                                reverse=True)[: self.beam_width])

        out = [Hypothesis(tokens=prefix, score=log_add(pb, pnb))
               for prefix, (pb, pnb) in beams.items()]
        out.sort(key=lambda h: h.score, reverse=True)
        return out

    def decode_batch(self, log_probs: np.ndarray, lengths: np.ndarray
                     ) -> List[List[Hypothesis]]:
        return [self.decode(log_probs[i], int(lengths[i]))
                for i in range(log_probs.shape[0])]


# ------------------------------------------------------------ native path

def build_native() -> Path:
    """Compile the C++ decoder (if its hash changed) and return the .so."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SOURCE.read_bytes())
    so = BUILD_DIR / f"libctc_decoder-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native CTC decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {NATIVE_SOURCE} (rc {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, so)
    return so


_native_fn = None


def native_fn():
    """`ctc_prefix_beam_decode_batch` of the built library, loaded once."""
    global _native_fn
    if _native_fn is None:
        fn = ctypes.CDLL(str(build_native())).ctc_prefix_beam_decode_batch
        fp, ip, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int
        fn.restype = None
        fn.argtypes = [
            fp, i, i, i, ip,             # log_probs, B, T, V, lengths
            i, i, i, ctypes.c_float,     # beam, blank, cutoff_top_n, cutoff_logp
            i, i,                        # max_out_len, num_threads
            ip, ip, fp,                  # out tokens, lengths, scores
        ]
        _native_fn = fn
    return _native_fn


class NativeCTCPrefixBeamDecoder(CTCPrefixBeamDecoder):
    """The C++ decoder, multithreaded over the batch; the NumPy decoder's
    semantics.  Its output rows hold up to T tokens, as many as the
    frames, so no hypothesis is cut."""

    def __init__(self, *args, num_threads: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_threads = num_threads
        native_fn()

    def decode_batch(self, log_probs, lengths) -> List[List[Hypothesis]]:
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        lens = np.ascontiguousarray(lengths, dtype=np.int32)
        if lp.ndim != 3 or lens.shape != lp.shape[:1]:
            raise ValueError(f"log_probs [B, T, V] and lengths [B], got {lp.shape} "
                             f"and {lens.shape}")
        b, t, v = lp.shape
        beam = self.beam_width
        out_tokens = np.zeros((b, beam, max(t, 1)), np.int32)
        out_lengths = np.zeros((b, beam), np.int32)
        out_scores = np.zeros((b, beam), np.float32)
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        native_fn()(
            lp.ctypes.data_as(fp), b, t, v, lens.ctypes.data_as(ip),
            beam, self.blank_id, self.cutoff_top_n, ctypes.c_float(self.cutoff_logp),
            out_tokens.shape[2], self.num_threads,
            out_tokens.ctypes.data_as(ip), out_lengths.ctypes.data_as(ip),
            out_scores.ctypes.data_as(fp),
        )
        return [
            [Hypothesis(tokens=tuple(out_tokens[i, k, : out_lengths[i, k]]),
                        score=float(out_scores[i, k]))
             for k in range(beam) if out_scores[i, k] > -np.finfo(np.float32).max]
            for i in range(b)
        ]

    def decode(self, log_probs, length=None):
        if length is None:
            length = log_probs.shape[0]
        return self.decode_batch(log_probs[None], np.array([length], np.int32))[0]


def make_decoder(beam_width=10, blank_id=0, **kwargs) -> NativeCTCPrefixBeamDecoder:
    """The native decoder, its library built at first use (a failed build
    raises)."""
    return NativeCTCPrefixBeamDecoder(beam_width=beam_width, blank_id=blank_id, **kwargs)
