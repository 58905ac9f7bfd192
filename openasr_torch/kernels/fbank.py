"""The fused log-mel fbank core: the Hopper kernel and its plain version.

Counterpart of openasr_tpu/kernels/fbank_fused.py (`_fused_matrices` :48,
`_fbank_kernel` :90, `fused_fbank_from_frames` :106).  Everything Kaldi's
fbank does to a frame before the power spectrum is linear: DC removal,
preemphasis, the window and the zero-padded DFT fold into two matrices
Mc, Ms [window, nfft/2 + 1], built once per config in float64 and cast to
float32, and the core is

    power = (F @ Mc)^2 + (F @ Ms)^2,   feats = log(max(power @ MelT, eps))

over frames F [B, T, window].  `fused_fbank` takes F as a tensor whose
last axis has unit stride: either a strided view of the padded waves (the
frames are never written to memory) or the materialized frames of a
dithered forward.  It also zeroes every frame at or past an utterance's
frame count.  A CUDA tensor launches csrc/fbank.cu; a CPU tensor takes
`fbank_reference`, the same folded products in float32 (TF32 is off:
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
def fused_matrices(cfg):
    """(Mc [ws, F], Ms [ws, F], MelT [F, M]) float32 from float64 math,
    F = nfft/2 + 1.  `cfg` is an ops.fbank.FbankConfig."""
    from openasr_torch.ops.fbank import feature_window, mel_banks

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
    mc = (np.cos(ang) @ a).T.astype(np.float32)  # [ws, F]
    ms = (np.sin(ang) @ a).T.astype(np.float32)
    mel_t = mel_banks(cfg).astype(np.float64).T.astype(np.float32)  # [F, M]
    return mc, ms, mel_t


@functools.lru_cache(maxsize=8)
def device_matrices(cfg, device: torch.device) -> dict:
    """The folded matrices on `device`, uploaded once per (config, device):
    `mc`, `ms`, `mel_t` for the plain version, and for the kernel `cs`
    [ws, K, 2] (cos and sin of a bin side by side) and `mel_k` [K, M] over
    the K = nfft/2 bins below the Nyquist, whose mel weights are zero."""
    mc, ms, mel_t = fused_matrices(cfg)
    if np.any(mel_t[-1] != 0.0):
        raise ValueError("fbank: the Nyquist bin carries mel weight")
    k = mel_t.shape[0] - 1
    cs = np.ascontiguousarray(np.stack([mc[:, :k], ms[:, :k]], axis=-1))
    return {
        name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for name, v in (("mc", mc), ("ms", ms), ("mel_t", mel_t), ("cs", cs),
                        ("mel_k", mel_t[:k]))
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
    t >= feat_lengths[b] (int32 [B]).  CUDA tensors launch csrc/fbank.cu,
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
    k, n_mel = m["mel_k"].shape
    if k > 256:
        raise ValueError(f"fused_fbank: {k} FFT bins; the kernel takes at most 256")
    out = torch.empty((b, t, n_mel), dtype=torch.float32, device=frames.device)
    if b * t == 0:
        return out
    lengths = feat_lengths.contiguous()
    code = kernels.library().openasr_fbank(
        frames.data_ptr(), m["cs"].data_ptr(), m["mel_k"].data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, t, ws, k, n_mel,
        frames.stride(0), frames.stride(1), int(bool(cfg.use_log_fbank)),
        frames.device.index, torch.cuda.current_stream(frames.device).cuda_stream,
    )
    kernels.check(code, "fbank")
    fused_fbank.launches += 1
    return out


# kernel launches since the last reset (the plain route never counts)
fused_fbank.launches = 0
