"""The fused log-mel fbank core: the Hopper kernel and its plain version.

Counterpart of openasr_tpu/kernels/fbank_fused.py (`_fused_matrices` :48,
`_fbank_kernel` :90, `fused_fbank_from_frames` :106).  Everything Kaldi's
fbank does to a frame before the power spectrum is linear: DC removal,
preemphasis, the window and the zero-padded DFT fold into two matrices
Mc, Ms [window, nfft/2 + 1], built once per config in float64 and cast to
float32, and the plain version is

    power = (F @ Mc)^2 + (F @ Ms)^2,   feats = log(max(power @ MelT, eps))

over frames F [B, T, window].  The kernel (csrc/fbank.cu) computes the
same function the way Kaldi does, in float64 from the f32 samples to the
mel sums: the pre-FFT steps on each frame, a real FFT and a sparse mel
product, from tables built here in float64 and uploaded in float32
(`kernel_tables`); where nfft is not a power of two it runs the folded
products instead.  `fbank_float64` evaluates the function in float64 with
PyTorch ops, the accuracy oracle of the card checks.  `fused_fbank` takes F as a
tensor whose last axis has unit stride: either a strided view of the
padded waves (the frames are never written to memory) or the materialized
frames of a dithered forward.  It also zeroes every frame at or past an
utterance's frame count.  A CUDA tensor launches the kernel; a CPU tensor
takes `fbank_reference`, the folded products in float32 (TF32 is off:
torch's default, which the CLIs and chip_smoke.py keep); there is no
other route.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from openasr_torch import kernels

EPSILON = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=8)
def folded_matrices64(cfg):
    """(Mc [ws, F], Ms [ws, F]) float64, F = nfft/2 + 1: DC removal,
    preemphasis, the window and the zero-padded DFT folded together.
    `cfg` is an ops.fbank.FbankConfig."""
    from openasr_torch.ops.fbank import feature_window

    ws = cfg.window_size
    nfft = cfg.padded_window_size
    f = nfft // 2 + 1

    a = np.eye(ws, dtype=np.float64)
    if cfg.remove_dc_offset:
        a = (np.eye(ws) - np.full((ws, ws), 1.0 / ws)) @ a
    if cfg.preemphasis != 0.0:
        p = np.eye(ws)
        idx = np.arange(1, ws)
        p[idx, idx - 1] = -cfg.preemphasis
        p[0, 0] = 1.0 - cfg.preemphasis
        a = p @ a
    a = np.diag(feature_window(cfg).astype(np.float64)) @ a  # [ws, ws]

    n = np.arange(ws, dtype=np.float64)[None, :]
    k = np.arange(f, dtype=np.float64)[:, None]
    ang = 2.0 * math.pi * k * n / nfft
    return (np.cos(ang) @ a).T, (np.sin(ang) @ a).T


@functools.lru_cache(maxsize=8)
def fused_matrices(cfg):
    """(Mc [ws, F], Ms [ws, F], MelT [F, M]) float32 from float64 math,
    F = nfft/2 + 1."""
    from openasr_torch.ops.fbank import mel_banks

    mc, ms = folded_matrices64(cfg)
    mel_t = mel_banks(cfg).astype(np.float64).T.astype(np.float32)  # [F, M]
    return mc.astype(np.float32), ms.astype(np.float32), mel_t


def fbank_float64(frames: torch.Tensor, feat_lengths: torch.Tensor, cfg) -> torch.Tensor:
    """The same function in float64, as Kaldi computes it (the accuracy
    oracle of the card checks): DC removal, preemphasis and the window on
    each frame, the rfft's power below the Nyquist, the mel banks, the
    log -> [B, T, M] float64, zero at frames t >= feat_lengths[b].  The
    window and banks are the kernel's float32 values, widened."""
    from openasr_torch.ops.fbank import feature_window, mel_banks

    x = frames.double()
    if cfg.remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    if cfg.preemphasis != 0.0:
        x = torch.cat([x[..., :1] * (1.0 - cfg.preemphasis),
                       x[..., 1:] - cfg.preemphasis * x[..., :-1]], dim=-1)
    x = x * torch.from_numpy(feature_window(cfg).astype(np.float64)).to(x.device)
    spec = torch.fft.rfft(x, n=cfg.padded_window_size, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    banks = torch.from_numpy(mel_banks(cfg).astype(np.float64)).to(x.device)
    mel = torch.matmul(power, banks.t())
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp_min(mel, EPSILON))
    return mask_frames(mel, feat_lengths)


def is_power_of_two(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def sparse_mel(cfg):
    """Kaldi's layout of the mel banks (`mel_banks(cfg)`, [M, nfft/2 + 1]):
    -> (idx int32 [3, M]: each bin's first nonzero FFT bin, its count of
    weights and their offset in `w`; w float32, the weights from the first
    nonzero to the last, packed bin after bin)."""
    from openasr_torch.ops.fbank import mel_banks

    banks = mel_banks(cfg)
    idx = np.zeros((3, banks.shape[0]), np.int32)
    rows = []
    for m, row in enumerate(banks):
        nz = np.flatnonzero(row)
        lo, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        idx[:, m] = lo, n, sum(len(r) for r in rows)
        rows.append(row[lo: lo + n])
    return idx, np.concatenate(rows).astype(np.float32)


def twiddles(cfg):
    """(hi, lo) float32 [nfft/2, 2]: cos and sin of 2 pi k / nfft for
    k < nfft/2 (W^k = cos - i sin) in float64, cast (hi), and the rest of
    the float64 value (lo), so that hi + lo carries it to about 48 bits."""
    nfft = cfg.padded_window_size
    ang = 2.0 * math.pi * np.arange(nfft // 2, dtype=np.float64) / nfft
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    hi = tw.astype(np.float32)
    return hi, (tw - hi).astype(np.float32)


def mel_order(counts: np.ndarray) -> np.ndarray:
    """int32 [M]: the order in which a warp's 32 lanes take the mel bins
    (lane l takes entries l, l + 32, ...): by weight count, largest
    first, every full round of 32 reversed after the first, so that each
    lane's total count comes out near the mean."""
    by_count = np.argsort(-np.asarray(counts), kind="stable")
    rounds = [by_count[i: i + 32] for i in range(0, len(by_count), 32)]
    return np.concatenate([r[::-1] if j % 2 and len(r) == 32 else r
                           for j, r in enumerate(rounds)]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def kernel_tables(cfg):
    """The kernel's tables, float32 / int32 numpy: `window` [ws], `twiddle`
    and `twiddle_lo` [nfft/2, 2] (`twiddles`), `mel_idx` [3, M], `mel_w`,
    `mel_order` [M], and where nfft is not a power of two (the folded route) `cs` [ws,
    nfft/2, 2], the folded cos and sin matrices below the Nyquist."""
    from openasr_torch.ops.fbank import feature_window

    mc, ms, mel_t = fused_matrices(cfg)
    if np.any(mel_t[-1] != 0.0):
        raise ValueError("fbank: the Nyquist bin carries mel weight")
    idx, w = sparse_mel(cfg)
    hi, lo = twiddles(cfg)
    tables = {"window": feature_window(cfg), "twiddle": hi, "twiddle_lo": lo,
              "mel_idx": idx, "mel_w": w, "mel_order": mel_order(idx[1])}
    if not is_power_of_two(cfg.padded_window_size):
        k = mel_t.shape[0] - 1
        tables["cs"] = np.stack([mc[:, :k], ms[:, :k]], axis=-1)
    return tables


@functools.lru_cache(maxsize=8)
def device_matrices(cfg, device: torch.device) -> dict:
    """The plain version's `mc`, `ms`, `mel_t` and the kernel's tables
    (`kernel_tables`) on `device`, uploaded once per (config, device)."""
    mc, ms, mel_t = fused_matrices(cfg)
    return {
        name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for name, v in (("mc", mc), ("ms", ms), ("mel_t", mel_t),
                        *kernel_tables(cfg).items())
    }


def mask_frames(feats: torch.Tensor, feat_lengths: torch.Tensor) -> torch.Tensor:
    """feats [B, T, D] with every frame t >= feat_lengths[b] set to 0."""
    valid = torch.arange(feats.shape[1], device=feats.device)[None, :] < feat_lengths[:, None]
    return torch.where(valid[..., None], feats, torch.zeros((), device=feats.device))


def fbank_reference(frames: torch.Tensor, feat_lengths: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version: frames [B, T, ws] f32 -> [B, T, M] f32, zero at frames
    t >= feat_lengths[b]."""
    m = device_matrices(cfg, frames.device)
    frames = frames.float()
    re = torch.matmul(frames, m["mc"])
    im = torch.matmul(frames, m["ms"])
    mel = torch.matmul(re * re + im * im, m["mel_t"])
    if cfg.use_log_fbank:
        mel = torch.log(torch.clamp_min(mel, EPSILON))
    return mask_frames(mel, feat_lengths)


def fused_fbank(frames: torch.Tensor, feat_lengths: torch.Tensor, cfg) -> torch.Tensor:
    """Log-mel (or mel, without `use_log_fbank`) of frames [B, T, ws] f32
    with unit stride on the last axis -> [B, T, M] f32, zero at frames
    t >= feat_lengths[b] (int32 [B]).  CUDA tensors launch csrc/fbank.cu
    (the FFT kernel, or where nfft is not a power of two the folded one),
    reading each frame through the tensor's batch and frame strides; CPU
    tensors take `fbank_reference`."""
    if frames.device.type == "cpu":
        return fbank_reference(frames, feat_lengths, cfg)
    if frames.device.type != "cuda":
        raise RuntimeError(f"fused_fbank: no kernel for device {frames.device}")
    b, t, ws = frames.shape
    if frames.dtype != torch.float32 or ws != cfg.window_size or (t and frames.stride(2) != 1):
        raise ValueError(
            f"fused_fbank: frames must be float32 [B, T, {cfg.window_size}] with "
            f"unit stride on the last axis, got {frames.dtype} {tuple(frames.shape)} "
            f"strides {frames.stride()}"
        )
    if (feat_lengths.shape != (b,) or feat_lengths.dtype != torch.int32
            or feat_lengths.device != frames.device):
        raise ValueError(f"fused_fbank: feat_lengths must be int32 [{b}] on {frames.device}")
    m = device_matrices(cfg, frames.device)
    n_mel = cfg.num_mel_bins
    out = torch.empty((b, t, n_mel), dtype=torch.float32, device=frames.device)
    if b * t == 0:
        return out
    lengths = feat_lengths.contiguous()
    code = kernels.library().openasr_fbank(
        frames.data_ptr(), lengths.data_ptr(), out.data_ptr(), m["window"].data_ptr(),
        m["twiddle"].data_ptr(), m["twiddle_lo"].data_ptr(), m["mel_idx"].data_ptr(),
        m["mel_w"].data_ptr(), m["mel_order"].data_ptr(),
        m["cs"].data_ptr() if "cs" in m else None, b, t, ws, cfg.padded_window_size,
        n_mel, m["mel_w"].numel(), frames.stride(0), frames.stride(1),
        float(cfg.preemphasis), int(bool(cfg.remove_dc_offset)),
        int(bool(cfg.use_log_fbank)), frames.device.index,
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    kernels.check(code, "fbank")
    fused_fbank.launches += 1
    return out


# kernel launches since the last reset (the plain route never counts)
fused_fbank.launches = 0
