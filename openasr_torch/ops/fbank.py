"""Kaldi-compatible log-mel filterbank over a padded batch of waves.

Counterpart of openasr_tpu/ops/fbank.py (`FbankConfig`, `feature_window`,
`mel_banks` with VTLN, `num_frames_of`, `frame_signal`, `fbank`,
`fbank_config_from_model_cfg`, `spectrogram`, `dct_matrix`,
`lifter_coeffs`, `mfcc`, `_resample_plan`, `resample_waveform`).  Semantics are Kaldi's compute-fbank-feats
with snip_edges=True: 25 ms frames every 10 ms, povey window, DC removal,
preemphasis 0.97, the FFT size rounded up to a power of two, the power
spectrum, triangular mel banks from low_freq 20 Hz to the Nyquist, and a
natural log floored at float32's epsilon.  The window and mel matrices are
NumPy in float64, as in the JAX package.

`fbank` frames the waves as a strided view (never copied), and for the
standard log-power configs (`fused_fbank_supported`) hands the log-mel
core to `kernels.fbank.fused_fbank`: the Hopper kernel on a card, its
plain version on the CPU.  The energy and magnitude variants take the
rfft path written out here.  Dither is drawn only from a generator the
caller passes (a training forward); without one the features are
deterministic.  `mfcc` takes `fbank`'s log-mel (so the kernel on a
card); `spectrogram` and `resample_waveform` are plain tensor ops.  No
SPLayer path calls these three.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from openasr_torch.kernels.fbank import fused_fbank, mask_frames

EPSILON = float(np.finfo(np.float32).eps)

MEL_HIGH_FREQ_Q = 1127.0
MEL_LOW_FREQ = 700.0


def mel_scale(freq):
    return MEL_HIGH_FREQ_Q * np.log(1.0 + freq / MEL_LOW_FREQ)


def inverse_mel_scale(mel):
    return MEL_LOW_FREQ * (np.exp(np.asarray(mel) / MEL_HIGH_FREQ_Q) - 1.0)


def next_power_of_two(x: int) -> int:
    return 1 if x == 0 else 2 ** (int(x) - 1).bit_length()


class FbankConfig(NamedTuple):
    sample_rate: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means offset from Nyquist
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    blackman_coeff: float = 0.42
    dither: float = 1.0
    use_energy: bool = False
    raw_energy: bool = True
    energy_floor: float = 0.0
    use_log_fbank: bool = True
    use_power: bool = True
    round_to_power_of_two: bool = True
    # VTLN piecewise-linear warp (Kaldi semantics; warp 1.0 = off)
    vtln_low: float = 100.0
    vtln_high: float = -500.0  # <0 means offset from Nyquist
    vtln_warp: float = 1.0

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        ws = self.window_size
        return next_power_of_two(ws) if self.round_to_power_of_two else ws

    @property
    def feat_dim(self) -> int:
        return self.num_mel_bins + int(self.use_energy)


def fbank_config_from_model_cfg(signal_cfg) -> FbankConfig:
    """FbankConfig from a YAML `model.signal` section."""
    return FbankConfig(
        sample_rate=float(signal_cfg.get("sample_rate", 16000)),
        num_mel_bins=int(signal_cfg.get("num_mel_bins", 80)),
        use_energy=bool(signal_cfg.get("use_energy", False)),
        dither=float(signal_cfg.get("dither", 1.0)),
    )


def feature_window(cfg: FbankConfig) -> np.ndarray:
    """Kaldi window function (povey = hann^0.85), float32."""
    m = cfg.window_size
    n = np.arange(m, dtype=np.float64)
    a = 2.0 * math.pi / (m - 1)
    if cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif cfg.window_type == "rectangular":
        w = np.ones(m)
    elif cfg.window_type == "blackman":
        b = cfg.blackman_coeff
        w = b - 0.5 * np.cos(a * n) + (0.5 - b) * np.cos(2 * a * n)
    else:
        raise ValueError(f"Unknown window type: {cfg.window_type}")
    return w.astype(np.float32)


def vtln_warp_freq(vtln_low: float, vtln_high: float, low_freq: float,
                   high_freq: float, warp: float, freq):
    """Kaldi's 3-piece linear VTLN warp F(freq) with F(low) == low and
    F(high) == high: the middle piece is freq / warp between the inflection
    points l = vtln_low * max(1, warp) and h = vtln_high * min(1, warp)."""
    l = vtln_low * max(1.0, warp)
    h = vtln_high * min(1.0, warp)
    if not (vtln_low > low_freq and vtln_high < high_freq and l > low_freq
            and h < high_freq):
        raise ValueError(
            f"VTLN: need low_freq < vtln_low ({vtln_low}) and vtln_high "
            f"({vtln_high}) < high_freq at warp {warp}"
        )
    freq = np.asarray(freq, np.float64)
    scale = 1.0 / warp
    scale_left = (scale * l - low_freq) / (l - low_freq)
    scale_right = (high_freq - scale * h) / (high_freq - h)
    res = np.where(
        freq < l,
        low_freq + scale_left * (freq - low_freq),
        np.where(freq < h, scale * freq, high_freq + scale_right * (freq - high_freq)),
    )
    outside = (freq < low_freq) | (freq > high_freq)
    return np.where(outside, freq, res)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank [num_mel_bins, padded_window_size//2 + 1],
    float32, with VTLN warping of the bin edges when cfg.vtln_warp != 1:
    the bins are defined on the first padded_window_size//2 FFT bins and
    the Nyquist column is zero."""
    nfft = cfg.padded_window_size
    num_fft_bins = nfft // 2
    nyquist = 0.5 * cfg.sample_rate
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq

    fft_bin_width = cfg.sample_rate / nfft
    mel_low = mel_scale(cfg.low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_idx = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    if cfg.vtln_warp != 1.0:
        vtln_high = cfg.vtln_high if cfg.vtln_high > 0 else nyquist + cfg.vtln_high

        def warp_mel(m):
            return mel_scale(vtln_warp_freq(
                cfg.vtln_low, vtln_high, cfg.low_freq, high_freq,
                cfg.vtln_warp, inverse_mel_scale(m),
            ))

        left_mel = warp_mel(left_mel)
        center_mel = warp_mel(center_mel)
        right_mel = warp_mel(right_mel)

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :]
    mel = mel_scale(freqs)
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    if cfg.vtln_warp == 1.0:
        weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    else:
        # warping may reorder the edges: assign each region explicitly
        weights = np.zeros_like(up_slope)
        up_idx = (mel > left_mel) & (mel <= center_mel)
        down_idx = (mel > center_mel) & (mel < right_mel)
        weights[up_idx] = up_slope[up_idx]
        weights[down_idx] = down_slope[down_idx]

    full = np.zeros((cfg.num_mel_bins, num_fft_bins + 1), dtype=np.float32)
    full[:, :num_fft_bins] = weights
    return full


def num_frames_of(lengths, cfg: FbankConfig):
    """snip_edges frame count: 0 if len < window else 1 + (len-window)//shift.
    A tensor gives an int32 tensor on its device; anything else an int32
    NumPy array (the host's lengths)."""
    ws, shift = cfg.window_size, cfg.window_shift
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.to(torch.int32)
        n = 1 + torch.div(lengths - ws, shift, rounding_mode="floor")
        return torch.where(lengths < ws, torch.zeros_like(n), n).to(torch.int32)
    lengths = np.asarray(lengths, np.int32)
    n = 1 + (lengths - ws) // shift
    return np.where(lengths < ws, 0, n).astype(np.int32)


def frame_signal(waves: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """[B, N] -> [B, T, window_size] snip_edges frames, T = 1 + (N - ws) //
    shift (0 when N < ws): a strided view of `waves`, not a copy."""
    b, n = waves.shape
    ws = cfg.window_size
    if n < ws:
        return waves.new_zeros((b, 0, ws))
    return waves.unfold(1, ws, cfg.window_shift)


def fused_fbank_supported(cfg: FbankConfig) -> bool:
    """The fused kernel covers the log-power (and power) fbank configs;
    the energy and magnitude-spectrum variants take the rfft path."""
    return bool(cfg.use_power) and not bool(cfg.use_energy)


@functools.lru_cache(maxsize=8)
def _window_and_banks(cfg: FbankConfig, device: torch.device):
    """feature_window and mel_banks on `device`, uploaded once."""
    return (torch.from_numpy(feature_window(cfg)).to(device),
            torch.from_numpy(mel_banks(cfg)).to(device))


def rfft_fbank(frames: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """fbank of frames [B, T, ws] by the rfft (cuFFT on a card): DC
    removal, energy, preemphasis, window, rfft power and the mel product,
    as openasr_tpu/ops/fbank.py:257-301 computes them, unmasked.  `fbank`
    takes it for the energy and magnitude variants."""
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    def log_energy_of(f):
        return torch.log(torch.clamp_min((f * f).sum(dim=-1), EPSILON))

    if cfg.use_energy and cfg.raw_energy:
        log_energy = log_energy_of(frames)
    if cfg.preemphasis != 0.0:
        first = frames[..., :1] - cfg.preemphasis * frames[..., :1]
        rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    window, mel = _window_and_banks(cfg, frames.device)
    frames = frames * window
    if cfg.use_energy and not cfg.raw_energy:
        log_energy = log_energy_of(frames)

    spectrum = torch.fft.rfft(frames, n=cfg.padded_window_size, dim=-1)
    power = spectrum.real ** 2 + spectrum.imag ** 2
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel_energies = torch.matmul(power, mel.t())
    if cfg.use_log_fbank:
        mel_energies = torch.log(torch.clamp_min(mel_energies, EPSILON))
    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_energy = torch.clamp_min(log_energy, math.log(cfg.energy_floor))
        # htk_compat=False: energy goes first (the Kaldi default)
        mel_energies = torch.cat([log_energy[..., None], mel_energies], dim=-1)
    return mel_energies


def fbank(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FbankConfig = FbankConfig(),
    generator: Optional[torch.Generator] = None,
):
    """Batched log-mel fbank.

    waves: [B, N] zero-padded waveforms in the int16 PCM scale; lengths:
    [B] valid sample counts (a tensor on waves' device); `generator` (on
    waves' device) turns on Kaldi dither, drawn with the frames' shape so
    that overlapping frames get independent noise.

    Returns (feats [B, T, feat_dim] float32, zero past each utterance's
    frame count; feat_lengths [B] int32).
    """
    waves = waves.float()
    feat_lengths = num_frames_of(lengths.to(waves.device), cfg)
    frames = frame_signal(waves, cfg)
    if generator is not None and cfg.dither != 0.0:
        noise = torch.randn(frames.shape, generator=generator, device=waves.device)
        frames = frames + cfg.dither * noise
    if fused_fbank_supported(cfg):
        return fused_fbank(frames, feat_lengths, cfg), feat_lengths
    return mask_frames(rfft_fbank(frames, cfg), feat_lengths), feat_lengths


def spectrogram(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FbankConfig = FbankConfig(),
    generator: Optional[torch.Generator] = None,
):
    """Batched Kaldi log power spectrogram (compute-spectrogram-feats):
    framing, dither (with `generator`), DC removal, preemphasis, window,
    the rfft's log power, and bin 0 replaced by the frame's log energy.

    Returns ([B, T, nfft // 2 + 1] float32, zero past each utterance's
    frame count; [B] int32 frame counts)."""
    waves = waves.float()
    frames = frame_signal(waves, cfg)
    if generator is not None and cfg.dither != 0.0:
        frames = frames + cfg.dither * torch.randn(frames.shape, generator=generator,
                                                   device=waves.device)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    def frame_log_energy(f):
        e = torch.log(torch.clamp_min((f * f).sum(dim=-1), EPSILON))
        if cfg.energy_floor > 0.0:
            e = torch.clamp_min(e, math.log(cfg.energy_floor))
        return e

    if cfg.raw_energy:
        log_energy = frame_log_energy(frames)
    if cfg.preemphasis != 0.0:
        first = frames[..., :1] - cfg.preemphasis * frames[..., :1]
        rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    window, _ = _window_and_banks(cfg, frames.device)
    frames = frames * window
    if not cfg.raw_energy:
        log_energy = frame_log_energy(frames)
    spectrum = torch.fft.rfft(frames, n=cfg.padded_window_size, dim=-1)
    power = torch.log(torch.clamp_min(spectrum.real ** 2 + spectrum.imag ** 2, EPSILON))
    power = torch.cat([log_energy[..., None], power[..., 1:]], dim=-1)
    feat_lengths = num_frames_of(lengths.to(waves.device), cfg)
    return mask_frames(power, feat_lengths), feat_lengths


def dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """Kaldi's DCT-II matrix [num_mel_bins, num_ceps] for a right multiply:
    orthonormal columns, column 0 fixed to sqrt(1 / num_mel_bins)."""
    n = num_mel_bins
    i = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(num_ceps, dtype=np.float64)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi / n * (i + 0.5) * j)
    m[:, 0] = math.sqrt(1.0 / n)
    return m.astype(np.float32)


def lifter_coeffs(num_ceps: int, cepstral_lifter: float) -> np.ndarray:
    """Kaldi's cepstral lifter 1 + Q/2 sin(pi i / Q)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * cepstral_lifter * np.sin(math.pi * i / cepstral_lifter)
            ).astype(np.float32)


def mfcc(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FbankConfig = FbankConfig(num_mel_bins=23),
    num_ceps: int = 13,
    cepstral_lifter: float = 22.0,
    htk_compat: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Batched Kaldi MFCC (compute-mfcc-feats): `fbank`'s log-mel, the
    DCT-II, the lifter, and the energy / HTK layouts.

    Returns ([B, T, num_ceps] float32, zero past each utterance's frame
    count; [B] int32 frame counts)."""
    if num_ceps > cfg.num_mel_bins:
        raise ValueError(f"mfcc: num_ceps {num_ceps} > num_mel_bins {cfg.num_mel_bins}")
    feature, feat_lengths = fbank(waves, lengths, cfg, generator)
    if cfg.use_energy:  # fbank puts the energy first
        log_energy = feature[..., 0]
        feature = feature[..., 1:]
    dct = torch.from_numpy(dct_matrix(num_ceps, cfg.num_mel_bins)).to(feature.device)
    feats = torch.matmul(feature, dct)
    if cepstral_lifter != 0.0:
        feats = feats * torch.from_numpy(lifter_coeffs(num_ceps, cepstral_lifter)).to(
            feature.device)
    if cfg.use_energy:
        feats = torch.cat([log_energy[..., None], feats[..., 1:]], dim=-1)
    if htk_compat:
        energy = feats[..., :1]
        if not cfg.use_energy:
            energy = energy * math.sqrt(2.0)
        feats = torch.cat([feats[..., 1:], energy], dim=-1)
    return mask_frames(feats, feat_lengths), feat_lengths


def _resample_plan(n: int, orig_freq: int, new_freq: int, lowpass_filter_width: int):
    """Windowed-sinc interpolation plan of Kaldi's LinearResample: output
    sample j of phase p = j mod U reads the input window that starts at
    first_index[p] + (j // U) * I, with weights[p].

    Returns (indices [T_out, W] into the left-padded signal, weights
    [T_out, W], left padding, padded length, T_out)."""
    gcd = math.gcd(orig_freq, new_freq)
    in_unit = orig_freq // gcd
    out_unit = new_freq // gcd
    lowpass_cutoff = 0.99 * 0.5 * min(orig_freq, new_freq)
    window_width = lowpass_filter_width / (2.0 * lowpass_cutoff)

    output_t = np.arange(out_unit, dtype=np.float64) / new_freq
    min_input_index = np.ceil((output_t - window_width) * orig_freq)
    max_input_index = np.floor((output_t + window_width) * orig_freq)
    w = int((max_input_index - min_input_index).max()) + 1

    j = np.arange(w, dtype=np.float64)[None, :]
    input_index = min_input_index[:, None] + j
    delta_t = input_index / orig_freq - output_t[:, None]
    inside = np.abs(delta_t) < window_width
    weights = np.where(
        inside,
        0.5 * (1.0 + np.cos(2.0 * math.pi * lowpass_cutoff / lowpass_filter_width * delta_t)),
        0.0,
    )
    sinc = np.where(
        delta_t == 0.0,
        2.0 * lowpass_cutoff,
        np.sin(2.0 * math.pi * lowpass_cutoff * delta_t)
        / np.where(delta_t == 0.0, 1.0, math.pi * delta_t),
    )
    weights = weights * sinc / orig_freq  # [U, W]

    # output samples in the open interval [0, n / orig_freq)
    tick = (orig_freq * new_freq) // gcd
    interval = n * (tick // orig_freq)
    last = interval // (tick // new_freq)
    if last * (tick // new_freq) == interval:
        last -= 1
    t_out = max(int(last) + 1, 0)

    phases = np.arange(t_out) % out_unit
    blocks = np.arange(t_out) // out_unit
    starts = min_input_index[phases].astype(np.int64) + blocks * in_unit
    idx = starts[:, None] + np.arange(w)[None, :]  # may reach below 0 or past n
    left = int(max(0, -idx.min())) if t_out else 0
    idx = idx + left
    total = int(idx.max()) + 1 if t_out else n
    return idx.astype(np.int32), weights[phases].astype(np.float32), left, max(total, n + left), t_out


def resample_waveform(
    waves: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    lengths: Optional[torch.Tensor] = None,
):
    """Batched Kaldi LinearResample as one gather and a weighted sum:
    out[b, j] = dot(weights[j mod U], x[b, first(j mod U) + (j div U) I :
    ... + W]).

    waves: [B, N] zero-padded; lengths: optional [B] valid sample counts,
    with which the output past each utterance's own resampled length is
    zeroed and the output lengths are returned too.

    Returns [B, T_out] float32 (and [B] int32 output lengths)."""
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    b, n = waves.shape
    idx, w, left, total, t_out = _resample_plan(n, orig_freq, new_freq, lowpass_filter_width)
    device = waves.device
    if t_out == 0:
        out = torch.zeros((b, 0), dtype=torch.float32, device=device)
        if lengths is None:
            return out
        return out, torch.zeros((b,), dtype=torch.int32, device=device)
    x = torch.nn.functional.pad(waves.float(), (left, total - left - n))
    gathered = x[:, torch.from_numpy(idx).long().to(device)]  # [B, T_out, W]
    out = torch.einsum("btw,tw->bt", gathered, torch.from_numpy(w).to(device))
    if lengths is None:
        return out
    # (lengths * u) // v, less one where it divides, as in _resample_plan
    gcd = math.gcd(orig_freq, new_freq)
    u, v = new_freq // gcd, orig_freq // gcd
    ln = lengths.to(device=device, dtype=torch.int64)
    last = (ln * u) // v - ((ln * u) % v == 0).long()
    out_lengths = torch.clamp_min(last + 1, 0).int()
    valid = torch.arange(t_out, device=device)[None, :] < out_lengths[:, None]
    return torch.where(valid, out, 0.0), out_lengths
