"""The port's fbank frontend against the JAX package's, on the CPU.

The same numpy inputs (the committed audio in tests/data, or a seeded
RandomState) go through openasr_tpu.ops.fbank / its Pallas kernel in
interpret mode and through openasr_torch.ops.fbank / the plain version of
the port's fused-fbank kernel.  Tolerances, on log-mel values:

- matrices, windows, frame counts, frames and audio: exact (the same
  float64 NumPy math, or integer PCM);
- the plain core against the Pallas kernel: atol 1e-3, rtol 1e-4 (the JAX
  test's own is 5e-3 / 1e-4, tests/test_fused_fbank.py:53; the same folded
  products in f32, summed in other orders, measured 4.4e-4 on real audio,
  where near-silent frames cancel a 400-term sum);
- the whole `fbank` against the JAX `fbank` (which takes its rfft path on
  the CPU): atol 1e-3, rtol 1e-4 for the folded-kernel configs; the rfft
  variants run the same math as JAX and are held to 5e-4 (measured 1.2e-4).

A card-only case holds the CUDA kernel against the plain version; it skips
here.  JAX is imported inside the CPU tests only, so the card tests also run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fbank.py
"""

import glob
import os

import numpy as np
import pytest
import torch

from openasr_torch.data.audio import load_wave, write_wav
from openasr_torch.kernels.fbank import (
    fbank_float64,
    fbank_reference,
    folded_matrices64,
    fused_fbank,
    fused_matrices,
    kernel_tables,
    sparse_mel,
    twiddles,
)
from openasr_torch.ops import fbank as P

DATA = os.path.join(os.path.dirname(__file__), "data")
WAV = os.path.join(DATA, "BAC009S0764W0121.wav")
CORE_ATOL, CORE_RTOL = 1e-3, 1e-4
RFFT_ATOL = 5e-4

CONFIGS = {
    "default": {},
    "mel40": {"num_mel_bins": 40},
    "vtln_up": {"vtln_warp": 1.1},
    "vtln_down": {"vtln_warp": 0.9},
    "hamming": {"window_type": "hamming"},
    "8k": {"sample_rate": 8000.0},
}

# the configs the kernel's tables are checked at: the flagship's, 40 bins,
# VTLN, 32 kHz (nfft 1024, 512 bins), nfft not a power of two (400), and
# nfft 128, 256, 2048 and 4096 (8 kHz; 100 ms frames; 48 kHz, 50 ms)
KERNEL_CONFIGS = {
    "default": {},
    "mel40": {"num_mel_bins": 40},
    "vtln_down": {"vtln_warp": 0.9},
    "32k": {"sample_rate": 32000.0},
    "nfft400": {"round_to_power_of_two": False},
    "8k": {"sample_rate": 8000.0},
    "8k_nfft128": {"sample_rate": 8000.0, "frame_length_ms": 16.0, "num_mel_bins": 23},
    "nfft2048": {"frame_length_ms": 100.0},
    "48k_nfft4096": {"sample_rate": 48000.0, "frame_length_ms": 50.0},
}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def jax_side():
    """(the JAX package's fbank module, its fused-fbank kernel module,
    jax.numpy), imported on first use."""
    import jax.numpy as jnp

    from openasr_tpu.kernels import fbank_fused
    from openasr_tpu.ops import fbank

    return fbank, fbank_fused, jnp


def cfg_pair(**kw):
    return P.FbankConfig(**kw), jax_side()[0].FbankConfig(**kw)


def real_batch():
    """Two utterances of the committed audio, 1.25 s and 0.81 s, padded."""
    a = load_wave(WAV)[1][:20000]
    b = load_wave(os.path.join(DATA, "100-121669-0000.wav"))[1][:13000]
    waves = np.zeros((2, 20000), np.float32)
    waves[0], waves[1, : len(b)] = a, b
    return waves, np.array([len(a), len(b)], np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matrices_windows_and_mel_banks_match_jax(name):
    J, K, jnp = jax_side()
    pc, jc = cfg_pair(**CONFIGS[name])
    assert np.array_equal(P.feature_window(pc), J.feature_window(jc))
    assert np.array_equal(P.mel_banks(pc), J.mel_banks(jc))
    mc, ms, mel_t = fused_matrices(pc)
    jmc, jms, jmel = K._fused_matrices(jc)
    f, m = mel_t.shape
    # the JAX matrices carry the TPU's 128-lane zero padding
    assert np.array_equal(mc, jmc[:, :f]) and np.array_equal(ms, jms[:, :f])
    assert np.array_equal(mel_t, jmel[:f, :m])
    assert not jmc[:, f:].any() and not jmel[f:].any() and not jmel[:, m:].any()
    assert not mel_t[-1].any()  # the Nyquist bin has no mel weight


def test_plain_core_matches_the_pallas_kernel_on_real_audio():
    J, K, jnp = jax_side()
    pc, jc = cfg_pair()
    wave = load_wave(WAV)[1][None, :16000]
    frames = np.asarray(J.frame_signal(jnp.asarray(wave), jc))
    assert frames.shape == (1, 98, 400)
    want = np.asarray(K.fused_fbank_from_frames(jnp.asarray(frames), jc, block_t=32,
                                              interpret=True))
    got = fused_fbank(torch.from_numpy(frames.copy()), torch.tensor([98], dtype=torch.int32), pc)
    np.testing.assert_allclose(got.numpy(), want, atol=CORE_ATOL, rtol=CORE_RTOL)


@pytest.mark.parametrize("bins", [80, 40])
def test_plain_core_matches_the_pallas_kernel_on_random_frames(bins):
    """T = 37 is not a multiple of the Pallas block (16) nor of the CUDA
    kernel's tile (32)."""
    J, K, jnp = jax_side()
    pc, jc = cfg_pair(num_mel_bins=bins)
    frames = (np.random.RandomState(0).randn(2, 37, 400) * 1000.0).astype(np.float32)
    want = np.asarray(K.fused_fbank_from_frames(jnp.asarray(frames), jc, block_t=16,
                                              interpret=True))
    fused_fbank.launches = 0
    got = fused_fbank(torch.from_numpy(frames), torch.tensor([37, 20], dtype=torch.int32), pc)
    assert fused_fbank.launches == 0  # CPU tensors never launch
    assert got.shape == (2, 37, bins)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=CORE_ATOL, rtol=CORE_RTOL)
    np.testing.assert_allclose(got[1, :20].numpy(), want[1, :20], atol=CORE_ATOL,
                               rtol=CORE_RTOL)
    assert not got[1, 20:].any()


@pytest.mark.parametrize("kw,atol", [
    ({}, CORE_ATOL),
    ({"num_mel_bins": 40}, CORE_ATOL),
    ({"use_log_fbank": False}, None),
    ({"use_energy": True}, RFFT_ATOL),
    ({"use_energy": True, "raw_energy": False, "energy_floor": 1.0}, RFFT_ATOL),
    ({"use_power": False}, RFFT_ATOL),
])
def test_fbank_matches_jax_fbank_on_a_padded_batch(kw, atol):
    J, K, jnp = jax_side()
    pc, jc = cfg_pair(**kw)
    waves, lens = real_batch()
    want, want_lens = J.fbank(jnp.asarray(waves), jnp.asarray(lens), jc)
    want, want_lens = np.asarray(want), np.asarray(want_lens)
    got, got_lens = P.fbank(torch.from_numpy(waves), torch.from_numpy(lens), pc)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 123, pc.feat_dim)
    assert got_lens.dtype == torch.int32
    assert np.array_equal(got_lens.numpy(), want_lens) and list(want_lens) == [123, 79]
    assert not got[1, 79:].any()  # padding frames are 0
    if atol is None:  # linear mel energies (up to 1e9): relative only
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-4)


def test_num_frames_of_edge_cases_match_jax():
    J, K, jnp = jax_side()
    pc, jc = cfg_pair()
    lens = np.array([0, 1, 399, 400, 559, 560, 561, 16000, 217600], np.int32)
    want = np.asarray(J.num_frames_of(lens, jc))
    assert list(want[:7]) == [0, 0, 0, 1, 1, 2, 2]  # < window: 0; = window: 1
    host = P.num_frames_of(lens, pc)
    assert host.dtype == np.int32 and np.array_equal(host, want)
    dev = P.num_frames_of(torch.from_numpy(lens), pc)
    assert dev.dtype == torch.int32 and np.array_equal(dev.numpy(), want)


def test_frames_are_a_view_of_the_waves_and_match_jax():
    J, K, jnp = jax_side()
    pc, jc = cfg_pair()
    waves = np.random.RandomState(1).randn(2, 1000).astype(np.float32)
    t = torch.from_numpy(waves)
    frames = P.frame_signal(t, pc)
    assert frames.data_ptr() == t.data_ptr() and frames.stride() == (1000, 160, 1)
    assert np.array_equal(frames.numpy(), np.asarray(J.frame_signal(jnp.asarray(waves), jc)))
    assert P.frame_signal(t[:, :399], pc).shape == (2, 0, 400)


def test_utterances_shorter_than_a_window():
    """0 frames below the window, 1 at exactly the window, in one batch and
    in a batch whose padded length is itself below the window."""
    pc, _ = cfg_pair()
    waves = np.random.RandomState(2).randn(2, 400).astype(np.float32) * 100
    feats, lens = P.fbank(torch.from_numpy(waves), torch.tensor([399, 400]), pc)
    assert feats.shape == (2, 1, 80) and lens.tolist() == [0, 1]
    assert not feats[0].any() and torch.isfinite(feats[1]).all() and feats[1].abs().min() > 0
    feats, lens = P.fbank(torch.from_numpy(waves[:, :300]), torch.tensor([300, 200]), pc)
    assert feats.shape == (2, 0, 80) and lens.tolist() == [0, 0]


def test_dither_needs_a_generator():
    pc, _ = cfg_pair()
    waves, lens = real_batch()
    w, n = torch.from_numpy(waves), torch.from_numpy(lens)
    a, _ = P.fbank(w, n, pc)
    b, _ = P.fbank(w, n, pc)
    assert torch.equal(a, b)  # no generator: deterministic
    c, _ = P.fbank(w, n, pc, torch.Generator().manual_seed(3))
    d, _ = P.fbank(w, n, pc, torch.Generator().manual_seed(3))
    e, _ = P.fbank(w, n, pc._replace(dither=0.0), torch.Generator().manual_seed(3))
    assert torch.equal(c, d) and not torch.equal(a, c) and torch.equal(a, e)
    assert not c[1, 79:].any()  # dither never fills the padding frames
    assert torch.isfinite(c).all()


def test_load_wave_matches_the_jax_loader(tmp_path):
    from openasr_tpu.data.audio import load_wave as jax_load_wave

    paths = sorted(glob.glob(os.path.join(DATA, "*.wav")))
    paths += [os.path.join(DATA, "100-121669-0000.flac")]
    for path in paths:
        rate, got = load_wave(path)
        want_rate, want = jax_load_wave(path)
        assert rate == want_rate == 16000 and got.dtype == np.float32
        assert np.array_equal(got, want), path
    # the FLAC and WAV copies of one utterance decode to the same samples
    flac = load_wave(os.path.join(DATA, "100-121669-0000.flac"))[1]
    assert np.array_equal(flac, load_wave(os.path.join(DATA, "100-121669-0000.wav"))[1])
    # the schemes: file:, ark:fn:offset (a wav embedded after 7 bytes)
    tone = np.round(3000 * np.sin(np.arange(800) / 7.0)).astype(np.float32)
    write_wav(str(tmp_path / "t.wav"), 8000, tone)
    blob = b"header:" + (tmp_path / "t.wav").read_bytes()
    (tmp_path / "t.ark").write_bytes(blob)
    for spec in (f"file:{tmp_path / 't.wav'}", f"ark:{tmp_path / 't.ark'}:7"):
        rate, got = load_wave(spec)
        assert rate == 8000 and np.array_equal(got, tone)
        assert np.array_equal(jax_load_wave(spec)[1], got)


@pytest.mark.parametrize("name", sorted(KERNEL_CONFIGS))
def test_sparse_mel_tables_rebuild_the_banks(name):
    """The kernel's mel layout (first bin, count, packed weights) gives back
    `mel_banks` exactly, its offsets packed bin after bin."""
    cfg = P.FbankConfig(**KERNEL_CONFIGS[name])
    idx, w = sparse_mel(cfg)
    banks = P.mel_banks(cfg)
    assert idx.dtype == np.int32 and w.dtype == np.float32 and idx.shape == (3, banks.shape[0])
    lo, n, off = idx
    assert np.array_equal(off, np.concatenate([[0], np.cumsum(n)[:-1]])) and w.size == n.sum()
    dense = np.zeros_like(banks)
    for m in range(banks.shape[0]):
        dense[m, lo[m]: lo[m] + n[m]] = w[off[m]: off[m] + n[m]]
    assert np.array_equal(dense, banks)
    assert (lo + n).max() <= cfg.padded_window_size // 2  # never the Nyquist bin
    order = kernel_tables(cfg)["mel_order"]  # the lanes' order: a permutation
    assert order.dtype == np.int32 and np.array_equal(np.sort(order), np.arange(len(n)))


@pytest.mark.parametrize("name", sorted(KERNEL_CONFIGS))
def test_float64_pipeline_equals_the_folded_matrices(name):
    """In float64, DC removal -> preemphasis -> window -> rfft of random
    frames (the kernel's order of steps) equals the frames times the folded
    matrices to 1e-9 of the spectrum's largest magnitude; those matrices,
    cast, are the JAX package's `_fused_matrices` columns bit for bit; and
    the port's float64 oracle `fbank_float64` is that spectrum's log-mel."""
    J, K, jnp = jax_side()
    cfg = P.FbankConfig(**KERNEL_CONFIGS[name])
    jcfg = J.FbankConfig(**KERNEL_CONFIGS[name])
    ws, nfft = cfg.window_size, cfg.padded_window_size
    frames = np.random.RandomState(3).randn(2, 5, ws) * 1000.0
    x = frames - frames.mean(-1, keepdims=True)
    x = np.concatenate([x[..., :1] * (1 - cfg.preemphasis),
                        x[..., 1:] - cfg.preemphasis * x[..., :-1]], axis=-1)
    x = x * P.feature_window(cfg).astype(np.float64)
    spec = np.fft.rfft(x, n=nfft, axis=-1)
    mc, ms = folded_matrices64(cfg)
    scale = np.abs(spec).max()
    assert np.abs(frames @ mc - spec.real).max() <= 1e-9 * scale
    assert np.abs(frames @ ms + spec.imag).max() <= 1e-9 * scale
    jmc, jms, _ = K._fused_matrices(jcfg)
    f = nfft // 2 + 1
    assert np.array_equal(mc.astype(np.float32), jmc[:, :f])
    assert np.array_equal(ms.astype(np.float32), jms[:, :f])
    power = np.abs(spec) ** 2
    want = np.log(np.maximum(power @ P.mel_banks(cfg).astype(np.float64).T,
                             np.finfo(np.float32).eps))
    got = fbank_float64(torch.from_numpy(frames), torch.tensor([5, 5], dtype=torch.int32), cfg)
    assert got.dtype == torch.float64 and np.abs(got.numpy() - want).max() <= 1e-9


@pytest.mark.parametrize("name", ["default", "32k", "nfft400"])
def test_twiddles_are_float64_to_one_ulp(name):
    """The f32 twiddle table is cos / sin of 2 pi k / nfft to one f32 ulp,
    and its float64 remainder carries the rest."""
    cfg = P.FbankConfig(**KERNEL_CONFIGS[name])
    nfft = cfg.padded_window_size
    hi, lo = twiddles(cfg)
    ang = 2.0 * np.pi * np.arange(nfft // 2, dtype=np.float64) / nfft
    want = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    assert hi.dtype == lo.dtype == np.float32 and hi.shape == (nfft // 2, 2)
    assert (np.abs(hi - want) <= np.spacing(np.abs(hi))).all()
    assert np.abs(hi.astype(np.float64) + lo - want).max() <= 1e-14


@pytest.mark.cuda
@pytest.mark.parametrize("dither", [False, True])
def test_kernel_matches_plain_on_the_card(cuda_card, dither):
    """The CUDA kernel against the plain version on the same card and
    inputs: strided wave frames (or materialized dithered frames), T not a
    tile multiple, a 0-frame and a 1-frame utterance.  atol 1e-4 on the
    log-mel: f32 FMAs in another order than the plain products (the H100
    agreed to 1.9e-6, one ulp at the features' magnitude)."""
    pc, _ = cfg_pair()
    rng = np.random.RandomState(4)
    waves = torch.from_numpy((rng.randn(4, 16160) * 800).astype(np.float32)).cuda()
    lens = torch.tensor([16160, 9000, 399, 400], device="cuda")
    frames = P.frame_signal(waves, pc)
    if dither:
        frames = frames + torch.randn(frames.shape, device="cuda")
    feat_lens = P.num_frames_of(lens, pc)
    fused_fbank.launches = 0
    got = fused_fbank(frames, feat_lens, pc)
    torch.cuda.synchronize()
    assert fused_fbank.launches == 1
    want = fbank_reference(frames, feat_lens, pc)
    assert got.shape == want.shape == (4, 99, 80)
    assert (got - want).abs().max().item() <= 1e-4
    assert not got[2].any() and not got[3, 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_CONFIGS))
def test_kernel_across_configs_on_the_card(cuda_card, name):
    """The kernel at the flagship's config, 40 bins, VTLN 0.9, 32 kHz (nfft
    1024), nfft 128, 256, 2048 and 4096 (the last two the shared-memory FFT
    kernel) and nfft 400 (the folded kernel) against the plain version on
    strided wave frames with a 0-frame and a 1-frame utterance: the log-mel
    within 1e-4, the FFT kernel (float64 inside) within 1e-5 of the float64
    evaluation and no farther from it than the plain version, zero past
    each frame count."""
    cfg = P.FbankConfig(**KERNEL_CONFIGS[name])
    ws, hop = cfg.window_size, cfg.window_shift
    n = ws + 60 * hop + 7
    rng = np.random.RandomState(5)
    waves = torch.from_numpy((rng.randn(4, n) * 800).astype(np.float32)).cuda()
    lens = torch.tensor([n, n // 2, ws - 1, ws], device="cuda")
    frames = P.frame_signal(waves, cfg)
    feat_lens = P.num_frames_of(lens, cfg)
    fused_fbank.launches = 0
    got = fused_fbank(frames, feat_lens, cfg)
    torch.cuda.synchronize()
    assert fused_fbank.launches == 1
    want = fbank_reference(frames, feat_lens, cfg)
    f64 = fbank_float64(frames, feat_lens, cfg)
    assert got.shape == want.shape == (4, 61, cfg.num_mel_bins)
    assert (got - want).abs().max().item() <= 1e-4
    if name != "nfft400":  # the folded kernel sums the plain version's products
        err64 = (got.double() - f64).abs().max().item()
        assert err64 <= 1e-5 and err64 <= (want.double() - f64).abs().max().item()
    assert not got[2].any() and not got[3, 1:].any() and not got[1, feat_lens[1]:].any()
