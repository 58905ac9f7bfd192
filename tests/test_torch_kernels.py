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
    attention_dropout_mask,
    check_flash_alignment,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_delta,
    pad_head_dim,
    padded_head_dim,
)
from openasr_torch.kernels.layer_norm import (
    fused_layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_reference,
)

# f32, same formula on both sides; only the summation order differs
LN_TOL = 1e-6
FLASH_TOL = 1e-5
# gradients: f32, sums over rows (LN) or keys/queries (flash) in other orders
LN_GRAD_TOL = 1e-5
FLASH_GRAD_TOL = 1e-4


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
    """Dropout needs a seed, as the JAX wrapper asserts `dropout_seed` for
    dropout_rate > 0."""
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(x, x, x, dropout_rate=0.1)


@pytest.mark.parametrize("shape", [(16, 64), (37, 64), (2, 19, 64)])
def test_layer_norm_grads_match_jax(shape):
    """dx, dgamma, dbeta of the port (autograd through the plain backward)
    against jax.vjp of the Pallas kernel in interpret mode."""
    import jax

    from openasr_tpu.kernels.layer_norm import fused_layer_norm as jax_fused_ln

    x, g, b = _ln_inputs(shape, seed=7 + shape[0])
    dy = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, g, b: jax_fused_ln(x, g, b, interpret=True), x, g, b)
    want = [np.asarray(t) for t in vjp(dy)]
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y, _, _ = fused_layer_norm(xt, gt, bt)
    got = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(dy))
    for name, w, t in zip(("dx", "dgamma", "dbeta"), want, got):
        assert t.shape == w.shape, name
        assert np.abs(t.numpy() - w).max() <= LN_GRAD_TOL * max(1.0, np.abs(w).max()), name


def test_layer_norm_bwd_dx_only_mode():
    x, g, _ = _ln_inputs((9, 64), seed=3)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _, mean, rstd = layer_norm_reference(xt, gt, torch.zeros(64))
    dy = torch.randn(9, 64, generator=torch.Generator().manual_seed(0))
    layer_norm_bwd.launches = layer_norm_bwd.dx_launches = 0
    dx, dg, db = layer_norm_bwd(xt, dy, gt, mean, rstd, dgamma_dbeta=False)
    assert dg is None and db is None
    assert layer_norm_bwd.launches == 0 and layer_norm_bwd.dx_launches == 0
    dx_full, _, _ = layer_norm_bwd_reference(xt, dy, gt, mean, rstd)
    assert torch.equal(dx, dx_full)


def _flash_grads_jax(q, k, v, dout, lens, causal, rate=0.0, seed=0):
    import jax
    import jax.numpy as jnp

    from openasr_tpu.kernels.flash_attention import flash_attention as jax_flash

    def f(q, k, v):
        return jax_flash(q, k, v, kv_lengths=lens, causal=causal, interpret=True,
                         block_q=8, block_k=8, dropout_rate=rate,
                         dropout_seed=jnp.uint32(seed) if rate else None)

    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(dout)

    out, grads = jax.jit(out_and_grads)(q, k, v)
    return np.asarray(out), [np.asarray(t) for t in grads]


def _flash_grads_port(q, k, v, dout, lens, causal, rate=0.0, seed=0):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, _ = flash_attention(
        qt, kt, vt, kv_lengths=None if lens is None else torch.from_numpy(lens),
        causal=causal, dropout_rate=rate, dropout_seed=seed if rate else None)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", FLASH_CASES[1:])
def test_flash_grads_match_jax(b, tq, tk, h, d, causal, lengths):
    """dq, dk, dv through the port's autograd (plain backward) against
    jax.vjp of the Pallas kernels in interpret mode: Tq != Tk, causal and a
    zero-length row are among the cases."""
    rng = np.random.RandomState(tq * 5 + tk)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for t in (tq, tk, tk))
    dout = rng.randn(b, tq, h, d).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    _, want = _flash_grads_jax(q, k, v, dout, lens, causal)
    _, got = _flash_grads_port(q, k, v, dout, lens, causal)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert np.abs(g - w).max() <= FLASH_GRAD_TOL, name


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (123456789, 0.1), (4294967295, 0.3)])
def test_dropout_mask_is_bit_exact(seed, rate):
    from openasr_tpu.kernels.flash_attention import (
        attention_dropout_mask as jax_mask,
    )

    want = np.asarray(jax_mask(seed, 3, 4, 37, 45, rate))
    got = attention_dropout_mask(seed, 3, 4, 37, 45, rate).numpy()
    assert np.array_equal(got, want)
    assert abs(1.0 - got.mean() - rate) < 0.02


@pytest.mark.parametrize("causal,tq,tk,lengths", [
    (True, 19, 19, [19, 0]), (False, 11, 21, [21, 7]),
])
def test_flash_dropout_matches_jax(causal, tq, tk, lengths):
    """Forward and grads with dropout 0.1 at one seed: the port's plain
    versions against the JAX kernels in interpret mode, which draw the
    same hash mask."""
    rng = np.random.RandomState(tq + 100 * tk)
    b, h, d = 2, 4, 32
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for t in (tq, tk, tk))
    dout = rng.randn(b, tq, h, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    out_j, want = _flash_grads_jax(q, k, v, dout, lens, causal, 0.1, 2024)
    out_t, got = _flash_grads_port(q, k, v, dout, lens, causal, 0.1, 2024)
    assert np.abs(out_t - out_j).max() <= FLASH_TOL
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert np.abs(g - w).max() <= FLASH_GRAD_TOL, name


def test_flash_bwd_wrappers_are_the_plain_backward_on_cpu():
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, t, 2, 32).astype(np.float32))
               for t in (7, 9, 9))
    lens = torch.tensor([9, 4])
    out, lse = flash_attention_reference(q, k, v, lens, False, None, 0.1, 77)
    dout = torch.from_numpy(rng.randn(2, 7, 2, 32).astype(np.float32))
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, dout, lens,
                                               False, None, 0.1, 77)
    launches = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    delta = flash_delta(out, dout)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, out, lse, dout, delta, lens, False,
                                       None, 0.1, 77)
    dq2 = flash_attention_bwd_dq(q, k, v, out, lse, dout, delta, lens, False, None,
                                 0.1, 77)
    dq3, dk3, dv3 = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None,
                                        0.1, 77)
    assert (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches) == launches
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq3) and torch.equal(dk, dk3) and torch.equal(dv, dv3)


def _strided(shape, strides, offset, dtype):
    """A [B, T, H, D] view with the given strides, `offset` elements into a
    fresh (64-byte aligned) buffer."""
    n = offset + 1 + sum((z - 1) * st for z, st in zip(shape, strides))
    return torch.zeros(n, dtype=dtype).as_strided(shape, strides, offset)


@pytest.mark.parametrize("case,shape,strides,offset,dtype,error", [
    # the path's views: a packed [B, T, 3, H, D] projection, dO transposed
    # from [B, H, T, D]
    ("packed q", (2, 5, 4, 32), (5 * 3 * 128, 3 * 128, 32, 1), 0, torch.bfloat16, None),
    ("transposed dO", (2, 5, 4, 32), (4 * 5 * 32, 32, 5 * 32, 1), 0, torch.bfloat16, None),
    ("start 2 bytes off", (2, 5, 4, 32), (5 * 128, 128, 32, 1), 1, torch.bfloat16,
     "16-byte boundary"),
    ("time stride of 68", (2, 5, 2, 32), (5 * 68, 68, 32, 1), 0, torch.bfloat16,
     r"multiples of 16 bytes \(8 elements\)"),
    ("head stride of 36", (1, 3, 2, 32), (3 * 72, 72, 36, 1), 0, torch.bfloat16,
     "multiples of 16 bytes"),
    ("odd strides of size-1 dims", (1, 1, 1, 32), (3, 5, 7, 1), 0, torch.bfloat16, None),
    ("f32 time stride of 68", (2, 5, 2, 32), (5 * 68, 68, 32, 1), 0, torch.float32, None),
    ("f32 time stride of 66", (2, 5, 2, 32), (5 * 66, 66, 32, 1), 0, torch.float32,
     r"multiples of 16 bytes \(4 elements\)"),
    ("f32 start 4 bytes off", (2, 5, 2, 32), (5 * 64, 64, 32, 1), 1, torch.float32,
     "16-byte boundary"),
    # the forward's views: the model's q/k/v, each its own nn.Linear output
    # [B, T, H*D] viewed as [B, T, H, D], and k of a packed [B, T, 2, H, D]
    ("projection view", (2, 5, 8, 64), (5 * 512, 512, 64, 1), 0, torch.bfloat16, None),
    ("packed k", (2, 5, 8, 64), (5 * 1024, 1024, 64, 1), 512, torch.float32, None),
])
def test_flash_alignment_check(case, shape, strides, offset, dtype, error):
    """The forward and backward kernels' 16-byte cp.async needs 16-byte
    aligned rows; the wrappers' check names the view and the condition."""
    t = _strided(shape, strides, offset, dtype)
    if error is None:
        check_flash_alignment(q=t)
    else:
        with pytest.raises(ValueError, match=f"q.*{error}"):
            check_flash_alignment(q=t)
        # a fresh contiguous copy is aligned
        check_flash_alignment(q=t.clone(memory_format=torch.contiguous_format))


# the head dims the kernels take by zero padding: 16 -> 32, 48 -> 64
PAD_CASES = [
    # b, tq, tk, h, d, causal, kv_lengths
    (2, 19, 19, 2, 16, True, None),
    (2, 11, 21, 2, 16, False, [21, 7]),
    (2, 19, 19, 2, 48, True, [19, 0]),
    (2, 11, 21, 2, 48, False, [21, 7]),
]


def test_padded_head_dim():
    assert [padded_head_dim(d) for d in (1, 16, 32, 33, 48, 64, 65, 96, 128)] == [
        32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="above the largest"):
        padded_head_dim(129)
    x = torch.ones(1, 2, 1, 16)
    assert pad_head_dim(x, 16) is x
    assert torch.equal(pad_head_dim(x, 32)[..., :16], x) and not pad_head_dim(x, 32)[..., 16:].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", PAD_CASES)
def test_head_dim_padding_is_exact(rate, b, tq, tk, h, d, causal, lengths):
    """What the wrappers do on the card, through the plain path: attention
    on q, k, v zero-padded to the kernel's head dim, with the true D's
    sm_scale and the same dropout seed, sliced back, equals attention at D
    (O, lse, dq, dk, dv to 1e-6), and the padded columns of O are zero."""
    rng = np.random.RandomState(d * 10 + tq)
    q, k, v = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
               for t in (tq, tk, tk))
    dout = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32))
    lens = None if lengths is None else torch.tensor(lengths)
    dp, scale, seed = padded_head_dim(d), 1.0 / np.sqrt(d), 2024
    out, lse = flash_attention_reference(q, k, v, lens, causal, None, rate, seed)
    grads = flash_attention_bwd_reference(q, k, v, out, lse, dout, lens, causal, None,
                                          rate, seed)
    qp, kp, vp, dop = (pad_head_dim(t, dp) for t in (q, k, v, dout))
    out_p, lse_p = flash_attention_reference(qp, kp, vp, lens, causal, scale, rate, seed)
    grads_p = flash_attention_bwd_reference(qp, kp, vp, out_p, lse_p, dop, lens, causal,
                                            scale, rate, seed)
    assert out_p.shape[-1] == dp and not out_p[..., d:].any()
    assert (out_p[..., :d] - out).abs().max().item() <= 1e-6
    assert torch.equal(torch.isinf(lse_p), torch.isinf(lse))
    fin = torch.isfinite(lse)
    assert (lse_p[fin] - lse[fin]).abs().max().item() <= 1e-6
    for name, g, gp in zip(("dq", "dk", "dv"), grads, grads_p):
        assert (gp[..., :d] - g).abs().max().item() <= 1e-6, name


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("rows,d", [(8128, 512), (40, 512), (37, 64), (1, 1000)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_card, dtype, tol, rows, d):
    """dx (both modes) and dgamma / dbeta against the plain backward; the
    dgamma / dbeta tolerance is relative to their largest magnitude (sums
    over `rows` rows in another order)."""
    x, g, b = _ln_inputs((rows, d), seed=rows + d)
    x = torch.from_numpy(x).to("cuda", dtype)
    g = torch.from_numpy(g).cuda()
    dy = torch.randn(rows, d, generator=torch.Generator().manual_seed(rows)).to("cuda", dtype)
    _, mean, rstd = layer_norm_reference(x, g, torch.from_numpy(b).cuda())
    before, before_dx = layer_norm_bwd.launches, layer_norm_bwd.dx_launches
    dx, dg, db = layer_norm_bwd(x, dy, g, mean, rstd)
    dx1, none_g, none_b = layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)
    assert none_g is None and none_b is None
    assert (layer_norm_bwd.launches, layer_norm_bwd.dx_launches) == (before + 1, before_dx + 1)
    dx_r, dg_r, db_r = layer_norm_bwd_reference(x, dy, g, mean, rstd)
    for got, want, rel in ((dx, dx_r, False), (dx1, dx_r, False), (dg, dg_r, True),
                           (db, db_r, True)):
        scale = want.float().abs().max().item() if rel else 1.0
        assert (got.float() - want.float()).abs().max().item() <= tol * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", FLASH_CASES + [
    (64, 127, 127, 8, 64, False, None),
    (64, 25, 25, 8, 64, True, None),
    (64, 25, 127, 8, 64, False, None),
    (2, 130, 130, 4, 128, True, [130, 0]),
])
def test_flash_bwd_kernels_match_plain(cuda_card, dtype, tol, rate, b, tq, tk, h,
                                       d, causal, lengths):
    """Forward (with dropout) and dq / dk / dv through autograd on the card
    against the plain versions on the same inputs and seed."""
    gen = torch.Generator().manual_seed(tq * 3 + tk)
    q, k, v = (
        torch.randn(b, t, h, d, generator=gen).to("cuda", dtype).requires_grad_()
        for t in (tq, tk, tk)
    )
    dout = torch.randn(b, tq, h, d, generator=gen).to("cuda", dtype)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else None
    before = (flash_attention.launches + flash_attention.dropout_launches,
              flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal,
                               dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    after = (flash_attention.launches + flash_attention.dropout_launches,
             flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    out_r, lse_r = flash_attention_reference(q, k, v, lens, causal, None, rate, seed or 0)
    want = flash_attention_bwd_reference(q, k, v, out_r, lse_r, dout, lens, causal,
                                         None, rate, seed or 0)
    assert (out.float() - out_r.float()).abs().max().item() <= tol
    for got, w in zip(grads, want):
        assert (got.float() - w.float()).abs().max().item() <= tol * max(
            1.0, w.float().abs().max().item())


# the kernels' tile edges: T of 1, 15, 17, 63, 65 and 139 against 16-row
# fragments, 32-row walk steps and 64-row blocks; lengths of 0, 1 and
# partial; causal with Tq != Tk
BWD_EDGE_CASES = [
    # b, tq, tk, h, d, causal, kv_lengths
    (2, 1, 1, 2, 64, False, None),
    (2, 15, 17, 2, 32, False, [17, 0]),
    (2, 17, 15, 2, 64, True, None),
    (2, 63, 65, 2, 128, False, [65, 30]),
    (2, 65, 63, 2, 64, True, [63, 1]),
    (2, 139, 139, 2, 64, False, [139, 0]),
    (3, 139, 65, 2, 128, False, [0, 64, 65]),
    (2, 65, 139, 2, 32, True, [100, 139]),
]


def _bwd_case(b, tq, tk, h, d, dtype, seed):
    """q, k, v as views of packed projections, dO transposed from
    [B, H, Tq, D] (unit D stride only), on the card."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, 3, h, d, generator=gen).to("cuda", dtype)[:, :, 0]
    kv = torch.randn(b, tk, 2, h, d, generator=gen).to("cuda", dtype)
    dout = torch.randn(b, h, tq, d, generator=gen).to("cuda", dtype).transpose(1, 2)
    return q, kv[:, :, 0], kv[:, :, 1], dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", BWD_EDGE_CASES)
def test_flash_bwd_kernels_tile_edges(cuda_card, dtype, tol, rate, b, tq, tk, h, d,
                                      causal, lengths):
    """dq, dk, dv of the backward kernels against the plain backward on the
    same forward outputs, with a non-contiguous dO; keys past a length get
    exactly zero gradients."""
    q, k, v, dout = _bwd_case(b, tq, tk, h, d, dtype, tq * 7 + tk)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else 0
    out, lse = flash_attention_reference(q, k, v, lens, causal, None, rate, seed)
    got = flash_attention_bwd(q, k, v, out, lse, dout, lens, causal, None, rate, seed)
    want = flash_attention_bwd_reference(q, k, v, out, lse, dout, lens, causal, None,
                                         rate, seed)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= tol * max(
            1.0, w.float().abs().max().item())
    if lens is not None:
        for i, n in enumerate(lengths):
            assert not got[1][i, n:].any() and not got[2][i, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_are_deterministic(cuda_card, dtype):
    """No atomics: two backward calls give bit-identical gradients."""
    q, k, v, dout = _bwd_case(4, 139, 139, 8, 64, dtype, 11)
    lens = torch.tensor([139, 100, 37, 0], device="cuda")
    out, lse = flash_attention_reference(q, k, v, lens, False, None, 0.1, 5)
    first = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, 0.1, 5)
    second = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, 0.1, 5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_misaligned_view_raises(cuda_card):
    """A bf16 q that starts 2 bytes past a 16-byte boundary is refused by
    the backward wrappers (out and lse from the plain forward, which takes
    any view)."""
    b, t, h, d = 2, 17, 2, 64
    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(b * t * h * d + 1, generator=gen).to("cuda", torch.bfloat16)
    q = flat[1:].view(b, t, h, d)
    k, v, dout = (torch.randn(b, t, h, d, generator=gen).to("cuda", torch.bfloat16)
                  for _ in range(3))
    out, lse = flash_attention_reference(q, k, v)
    delta = flash_delta(out, dout)
    for call in (lambda: flash_attention_bwd(q, k, v, out, lse, dout),
                 lambda: flash_attention_bwd_dkv(q, k, v, out, lse, dout, delta),
                 lambda: flash_attention_bwd_dq(q, k, v, out, lse, dout, delta)):
        with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
            call()


@pytest.mark.cuda
def test_flash_fwd_misaligned_view_raises(cuda_card):
    """The forward refuses a bf16 view that starts 2 bytes past a 16-byte
    boundary, and one whose time stride is not a multiple of 16 bytes,
    without launching; the model's views (each projection's nn.Linear
    output viewed as [B, T, H, D]) are aligned and launch."""
    b, t, h, d = 2, 17, 2, 64
    gen = torch.Generator().manual_seed(5)
    flat = torch.randn(b * t * h * d + 1, generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn(b, t, h, d, generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    wide = torch.randn(b, t, h * d + 4, generator=gen).to("cuda", torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        flash_attention(flat[1:].view(b, t, h, d), k, v)
    with pytest.raises(ValueError, match="k's batch, time and head strides"):
        flash_attention(k, wide[..., : h * d].view(b, t, h, d), v)
    assert flash_attention.launches == before
    x = torch.randn(b, t, h * d, generator=gen).to("cuda", torch.bfloat16)
    proj = [torch.nn.Linear(h * d, h * d).to("cuda", torch.bfloat16) for _ in range(3)]
    with torch.no_grad():
        q, k, v = (p(x).view(b, t, h, d) for p in proj)
        out, lse = flash_attention(q, k, v, kv_lengths=torch.tensor([t, 9], device="cuda"))
    assert flash_attention.launches == before + 1
    out_r, _ = flash_attention_reference(q, k, v, torch.tensor([t, 9], device="cuda"))
    assert (out.float() - out_r.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", BWD_EDGE_CASES)
def test_flash_fwd_kernel_tile_edges(cuda_card, dtype, tol, rate, b, tq, tk, h, d,
                                     causal, lengths):
    """O and lse of the forward kernel against the plain version at the
    tile edges (16-row fragments, 32-key steps, 64-query blocks), with the
    same dropout seed on both sides; rows without a valid key give O = 0
    and lse = +inf."""
    q, k, v, _ = _bwd_case(b, tq, tk, h, d, dtype, tq * 5 + tk)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else None
    before = flash_attention.launches + flash_attention.dropout_launches
    out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal,
                               dropout_rate=rate, dropout_seed=seed)
    assert flash_attention.launches + flash_attention.dropout_launches == before + 1
    out_r, lse_r = flash_attention_reference(q, k, v, lens, causal, None, rate, seed or 0)
    assert out.shape == out_r.shape and out.dtype == out_r.dtype
    assert (out.float() - out_r.float()).abs().max().item() <= tol
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_r))
    fin = torch.isfinite(lse_r)
    if bool(fin.any()):
        assert (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-3
    if lens is not None:
        for i, n in enumerate(lengths):
            if n == 0:
                assert not out[i].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_is_deterministic(cuda_card, dtype):
    """Two forward launches give bit-identical O and lse."""
    q, k, v, _ = _bwd_case(4, 139, 139, 8, 64, dtype, 13)
    lens = torch.tensor([139, 100, 37, 0], device="cuda")
    first = flash_attention(q, k, v, kv_lengths=lens, dropout_rate=0.1, dropout_seed=5)
    second = flash_attention(q, k, v, kv_lengths=lens, dropout_rate=0.1, dropout_seed=5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,tol_bwd", [(torch.float32, 2e-5, 1e-4),
                                               (torch.bfloat16, 2e-2, 5e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", PAD_CASES)
def test_flash_kernels_at_padded_head_dims(cuda_card, dtype, tol, tol_bwd, rate, b, tq, tk,
                                           h, d, causal, lengths):
    """D = 16 and 48, zero-padded to 32 and 64 by the wrappers: O, lse and
    dq, dk, dv through autograd on the card against the plain versions at
    D, one launch of each kernel."""
    gen = torch.Generator().manual_seed(tq * 3 + d)
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype).requires_grad_()
               for t in (tq, tk, tk))
    dout = torch.randn(b, tq, h, d, generator=gen).to("cuda", dtype)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else None
    before = (flash_attention.launches + flash_attention.dropout_launches,
              flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal,
                               dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    after = (flash_attention.launches + flash_attention.dropout_launches,
             flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    out_r, lse_r = flash_attention_reference(q, k, v, lens, causal, None, rate, seed or 0)
    want = flash_attention_bwd_reference(q, k, v, out_r, lse_r, dout, lens, causal, None,
                                         rate, seed or 0)
    assert out.shape == out_r.shape and (out.float() - out_r.float()).abs().max().item() <= tol
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_r))
    fin = torch.isfinite(lse_r)
    assert (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-3
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        assert (got.float() - w.float()).abs().max().item() <= tol_bwd * max(
            1.0, w.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_padded_head_dim_keeps_dropped_pairs(cuda_card, dtype, causal):
    """At D = 16 (padded to 32) with dropout 0.1, v[b, key, h] = e_key makes
    O[b, q, h, key] the kept weight of (q, key): its zeros are the dropped
    (or masked) pairs, and they are the hash mask's, as in the plain
    version with the same seed."""
    b, h, d, tq, tk, seed = 2, 2, 16, 37, 16, 4242
    gen = torch.Generator().manual_seed(7)
    q, k = (torch.randn(b, tq if i == 0 else tk, h, d, generator=gen).to("cuda", dtype)
            for i in range(2))
    v = torch.eye(tk)[None, :, None, :].expand(b, tk, h, d).to("cuda", dtype).contiguous()
    out, _ = flash_attention(q, k, v, causal=causal, dropout_rate=0.1, dropout_seed=seed)
    out_r, _ = flash_attention_reference(q, k, v, None, causal, None, 0.1, seed)
    keep = attention_dropout_mask(seed, b, h, tq, tk, 0.1, "cuda")
    if causal:
        keep = keep & (torch.arange(tk, device="cuda")[None, :]
                       <= torch.arange(tq, device="cuda")[:, None])
    assert 0 < int((~keep).sum()) < keep.numel()
    for o in (out, out_r):
        assert torch.equal(o.permute(0, 2, 1, 3) != 0, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,d", [(11398, 512), (1, 512), (5, 512), (1027, 512),
                                    (300, 1536)])
def test_layer_norm_bwd_partials_mode(cuda_card, dtype, tol, rows, d):
    """The partials mode (dx, dgamma, dbeta in one call) at the training
    path's [11398, 512], at odd row counts and at D = 1536 (beyond the
    rows held in registers; the forward too), against the plain versions:
    dx to tol, dgamma and dbeta to tol of their largest magnitude."""
    x, g, b = _ln_inputs((rows, d), seed=rows + d)
    x = torch.from_numpy(x).to("cuda", dtype)
    g, b = torch.from_numpy(g).cuda(), torch.from_numpy(b).cuda()
    dy = torch.randn(rows, d, generator=torch.Generator().manual_seed(rows)).to("cuda", dtype)
    y, mean, rstd = fused_layer_norm(x, g, b)
    y_r, mean_r, rstd_r = layer_norm_reference(x, g, b)
    assert (y.float() - y_r.float()).abs().max().item() <= (1e-5 if dtype == torch.float32
                                                             else 2e-2)
    assert (mean - mean_r).abs().max().item() <= 1e-5
    before = layer_norm_bwd.launches
    dx, dg, db = layer_norm_bwd(x, dy, g, mean_r, rstd_r)
    assert layer_norm_bwd.launches == before + 1
    dx_r, dg_r, db_r = layer_norm_bwd_reference(x, dy, g, mean_r, rstd_r)
    for got, want, rel in ((dx, dx_r, False), (dg, dg_r, True), (db, db_r, True)):
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = want.float().abs().max().item() if rel else 1.0
        assert (got.float() - want.float()).abs().max().item() <= tol * max(scale, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(11398, 512), (300, 1536)])
def test_layer_norm_bwd_is_deterministic(cuda_card, dtype, rows, d):
    """dgamma and dbeta are summed in a fixed order: two runs give the same
    bits (and so does dx)."""
    x, g, b = _ln_inputs((rows, d), seed=3)
    x = torch.from_numpy(x).to("cuda", dtype)
    g = torch.from_numpy(g).cuda()
    dy = torch.randn(rows, d, generator=torch.Generator().manual_seed(9)).to("cuda", dtype)
    _, mean, rstd = layer_norm_reference(x, g, torch.from_numpy(b).cuda())
    first = layer_norm_bwd(x, dy, g, mean, rstd)
    second = layer_norm_bwd(x, dy, g, mean, rstd)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
