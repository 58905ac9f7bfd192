"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the JAX kernel in interpret mode (and the JAX plain
reference) on the same numpy inputs.  On a CUDA card the Hopper kernels
are held against the plain versions; those tests skip elsewhere.  JAX is
imported inside the CPU tests only, so the card tests also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from openasr_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

# f32, same formula on both sides; only the summation order differs
LN_TOL = 1e-6
FLASH_TOL = 1e-5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def _ln_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(16, 64), (37, 64), (2, 19, 64)])
def test_layer_norm_plain_matches_jax(shape):
    """37 and 2*19 rows are not multiples of the Pallas row block."""
    from openasr_tpu.kernels.layer_norm import fused_layer_norm as jax_fused_ln
    from openasr_tpu.kernels.layer_norm import layer_norm_reference as jax_ln_ref

    x, g, b = _ln_inputs(shape, seed=len(shape) * 100 + shape[0])
    fused_layer_norm.launches = 0
    y, mean, rstd = fused_layer_norm(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)
    )
    assert fused_layer_norm.launches == 0  # CPU tensors never launch
    assert y.shape == x.shape and mean.shape == x.shape[:-1]
    y = y.numpy()
    y_ref = np.asarray(jax_ln_ref(x, g, b))
    y_pallas = np.asarray(jax_fused_ln(x, g, b, interpret=True))
    assert np.abs(y - y_ref).max() <= LN_TOL
    assert np.abs(y - y_pallas).max() <= LN_TOL
    x64 = x.astype(np.float64)
    mu64 = x64.mean(-1)
    rstd64 = 1 / np.sqrt((x64 ** 2).mean(-1) - mu64 ** 2 + 1e-6)
    assert np.abs(mean.numpy() - mu64).max() <= LN_TOL
    assert np.abs(rstd.numpy() - rstd64).max() <= 1e-5 * rstd64.max()


def _np_attention(q, k, v, lengths, causal):
    """float64 oracle: (out, lse) with O = 0 / lse = +inf on empty rows."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) / np.sqrt(d)
    valid = np.arange(tk)[None, None, None, :] < np.asarray(lengths)[:, None, None, None]
    if causal:
        valid = valid & (np.arange(tk)[None, :] <= np.arange(tq)[:, None])[None, None]
    s = np.where(valid, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.where(valid, np.exp(s - np.where(np.isfinite(m), m, 0)), 0)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p / np.where(l > 0, l, 1), v)
    lse = np.where(l > 0, m + np.log(np.where(l > 0, l, 1)), np.inf)[..., 0]
    return out, lse


FLASH_CASES = [
    # b, tq, tk, h, d, causal, kv_lengths
    (2, 16, 16, 4, 32, False, [16, 9]),
    (2, 19, 19, 4, 32, True, [19, 11]),       # T not a multiple of 8
    (3, 13, 13, 2, 32, False, [13, 0, 5]),    # a length-0 row: O = 0
    (2, 11, 21, 4, 32, False, [21, 7]),       # cross-attention, Tq != Tk
    (2, 21, 21, 2, 64, True, None),           # causal, no key padding
]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", FLASH_CASES)
def test_flash_plain_matches_jax(b, tq, tk, h, d, causal, lengths):
    from openasr_tpu.kernels.flash_attention import flash_attention as jax_flash

    rng = np.random.RandomState(tq * 7 + tk)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    flash_attention.launches = 0
    out, lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lengths=None if lens is None else torch.from_numpy(lens),
        causal=causal,
    )
    assert flash_attention.launches == 0  # CPU tensors never launch
    assert out.shape == (b, tq, h, d) and lse.shape == (b, h, tq)
    jax_out = np.asarray(jax_flash(
        q, k, v, kv_lengths=lens, causal=causal, interpret=True,
        block_q=8, block_k=8,
    ))
    assert np.abs(out.numpy() - jax_out).max() <= FLASH_TOL
    want_out, want_lse = _np_attention(
        q, k, v, [tk] * b if lens is None else lens, causal
    )
    assert np.abs(out.numpy() - want_out).max() <= FLASH_TOL
    lse = lse.numpy()
    assert np.array_equal(np.isinf(lse), np.isinf(want_lse))
    fin = np.isfinite(want_lse)
    assert np.abs(lse[fin] - want_lse[fin]).max() <= FLASH_TOL
    if lens is not None and (lens == 0).any():
        assert not out.numpy()[lens == 0].any()


def test_flash_rejects_dropout():
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(x, x, x, dropout_rate=0.1)


# ------------------------------------------------------------ card only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows", [2400, 40, 1])
def test_layer_norm_kernel_matches_plain(cuda_card, dtype, tol, rows):
    x, g, b = _ln_inputs((rows, 512), seed=rows)
    x = torch.from_numpy(x).to("cuda", dtype)
    g, b = torch.from_numpy(g).cuda(), torch.from_numpy(b).cuda()
    before = fused_layer_norm.launches
    y, mean, rstd = fused_layer_norm(x, g, b)
    assert fused_layer_norm.launches == before + 1
    y_r, mean_r, rstd_r = layer_norm_reference(x, g, b)
    assert (y.float() - y_r.float()).abs().max().item() <= tol
    assert (mean - mean_r).abs().max().item() <= 1e-5
    assert (rstd - rstd_r).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", FLASH_CASES + [
    (4, 304, 304, 8, 64, False, [304, 250, 1, 0]),
    (2, 130, 130, 4, 128, True, [130, 77]),
])
def test_flash_kernel_matches_plain(cuda_card, dtype, tol, b, tq, tk, h, d,
                                    causal, lengths):
    gen = torch.Generator().manual_seed(tq + tk)
    q, k, v = (
        torch.randn(b, t, h, d, generator=gen).to("cuda", dtype)
        for t in (tq, tk, tk)
    )
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal)
    assert flash_attention.launches == before + 1
    out_r, lse_r = flash_attention_reference(q, k, v, lens, causal)
    assert (out.float() - out_r.float()).abs().max().item() <= tol
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_r))
    fin = torch.isfinite(lse_r)
    assert (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-3
