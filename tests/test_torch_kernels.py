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
    bwd_route,
    flash_bwd_stats,
    flash_bwd_stats_reference,
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
    launches = (flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
                flash_attention_bwd_dq.launches)
    stats = flash_bwd_stats(q, k, v, dout, lens, False, None, 0.1, 77)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, out, lse, dout, stats, lens, False,
                                       None, 0.1, 77)
    dq2 = flash_attention_bwd_dq(q, k, v, out, lse, dout, stats, lens, False, None,
                                 0.1, 77)
    dq3, dk3, dv3 = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None,
                                        0.1, 77)
    assert (flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == launches
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq3) and torch.equal(dk, dk3) and torch.equal(dv, dv3)


def _np_backward_statistics(q, k, v, dout, lengths, causal, rate, seed):
    """float64 oracle of the statistics pass: (m, 1 / l, delta) [B, H, Tq],
    m the row max of S scale log2(e) over the valid keys, l = sum
    exp2(s' - m), delta = rowsum(P o dP o D), P = exp2(s' - m) / l; 0, 0, 0
    on a row with no valid key."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) / np.sqrt(d) * np.log2(np.e)
    valid = np.arange(tk)[None, None, None, :] < np.asarray(lengths)[:, None, None, None]
    if causal:
        valid = valid & (np.arange(tk)[None, :] <= np.arange(tq)[:, None])[None, None]
    valid = np.broadcast_to(valid, s.shape)
    any_key = valid.any(-1)
    m = np.where(any_key, np.where(valid, s, -np.inf).max(-1), 0.0)
    e = np.where(valid, np.exp2(np.where(valid, s, 0.0) - m[..., None]), 0.0)
    l = e.sum(-1)
    inv = np.where(any_key, 1.0 / np.where(any_key, l, 1.0), 0.0)
    dp = np.einsum("bqhd,bkhd->bhqk", dout.astype(np.float64), v)
    if rate:
        keep = attention_dropout_mask(seed, b, h, tq, tk, rate).numpy()
        dp = np.where(keep, dp / (1.0 - rate), 0.0)
    return m, inv, (e * dp).sum(-1) * inv


@pytest.mark.parametrize("causal,lengths", [(False, [9, 4]), (True, [9, 0])])
def test_backward_statistics(causal, lengths):
    """The statistics pass's plain version (what the CPU wrapper returns):
    each row's max m of the log2-scaled scores, 1 / l and delta against a
    float64 evaluation (0, 0, 0 on an empty row); the forward's lse is m +
    log2(l) in natural units, and delta, from P and dP o D, equals
    rowsum(dO o O) of the forward to f32 rounding."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, t, 2, 32).astype(np.float32) for t in (7, 9, 9))
    dout = rng.randn(2, 7, 2, 32).astype(np.float32)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, dout))
    lens = torch.tensor(lengths)
    out, lse = flash_attention_reference(qt, kt, vt, lens, causal, None, 0.1, 77)
    launches = flash_bwd_stats.launches
    m, inv, delta = flash_bwd_stats(qt, kt, vt, dot, lens, causal, None, 0.1, 77)
    assert flash_bwd_stats.launches == launches  # CPU tensors never launch
    m64, inv64, delta64 = _np_backward_statistics(q, k, v, dout, lengths, causal, 0.1, 77)
    assert np.abs(m.numpy() - m64).max() <= 1e-5 * max(1.0, np.abs(m64).max())
    assert np.abs(inv.numpy() - inv64).max() <= 1e-6
    assert np.abs(delta.numpy() - delta64).max() <= 1e-5
    valid = torch.isfinite(lse)
    assert (m[~valid] == 0).all() and (inv[~valid] == 0).all() and (delta[~valid] == 0).all()
    natural = (m[valid] - torch.log2(inv[valid])) * float(np.log(2.0))
    assert (natural - lse[valid]).abs().max() <= 1e-5
    want = (dot * out).sum(-1).transpose(1, 2)
    assert (delta - want).abs().max() <= 1e-5


def test_statistics_check_holds_inverse_row_sum_relative():
    """chip_smoke.py holds the statistics pass to its plain version with
    1 / l relative to each row's own 1 / l: at Tk 130, 1 / l is far below
    1, so 5% of it is far under an absolute 5e-2 and still fails; a row
    with no valid key must give 0 and only such a row; m and delta are
    held over max(1, their largest magnitude)."""
    import chip_smoke

    rng = np.random.RandomState(8)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 130, 2, 32).astype(np.float32))
                     for _ in range(4))
    want = flash_bwd_stats_reference(q, k, v, dout, torch.tensor([130, 0]))
    assert want[1, 0].max() < 0.5 and not want[:, 1].any()
    assert [e for *_, e in chip_smoke.stats_errs(want.clone(), want)] == [0.0, 0.0, 0.0]
    off = want.clone()
    off[1, 0] *= 1.05
    worst = dict((name, e) for name, _, e in chip_smoke.stats_errs(off, want))
    assert (off[1] - want[1]).abs().max() < 5e-2
    assert worst["1 / l"] > chip_smoke.TOL_FLASH_STATS and worst["m"] == worst["delta"] == 0
    off = want.clone()
    off[1, 1, 0, 0] = 1e-9
    assert dict((name, e) for name, _, e in chip_smoke.stats_errs(off, want))["1 / l"] == float(
        "inf")


def _saturated_qk(b, t, h, d, lens, gen, last_step, step=32):
    """(q, k) [B, T, H, D] f32 where each query lies near one valid key and
    both are scaled by 300: the matching score (about 5e5) leads the others
    by about 1e5, so every softmax row is one-hot.  `last_step`: each
    query's key lies in its row's last `step`-key step of the kernels' walk
    (32 for the mma.sync kernels, 64 for the wgmma ones), so the row's max
    arrives after earlier steps' (and l and delta were summed against a
    smaller running max first); else query t matches key t mod length."""
    k = torch.randn(b, t, h, d, generator=gen) * 300.0
    n = lens[:, None].long()
    pos = torch.arange(t)[None, :]
    if last_step:
        first = (n - 1) // step * step
        match = first + pos % (n - first)
    else:
        match = pos % n
    return k[torch.arange(b)[:, None], match] + torch.randn(b, t, h, d, generator=gen), k


@pytest.mark.parametrize("rate,b,t,lengths,last_step", [
    pytest.param(rate, *case, id=f"{rate}{name}")
    for name, case in (("", (4, 17, [17, 12, 9, 17], False)),
                       # Tk > 64: the max in step 3 of 3
                       ("-max-in-last-step", (4, 80, [80, 70, 65, 80], True)))
    for rate in (0.0, 0.1)
])
def test_plain_backward_is_exact_in_a_saturated_softmax(rate, b, t, lengths, last_step):
    """Every row one-hot (`_saturated_qk`): the true dQ and dK are 0
    (exactly, in float64 autograd).  The plain backward recomputes the
    forward's probabilities and takes delta = rowsum(P o dP), so dP - delta
    cancels exactly: dQ, dK are 0, dV is the float64 autograd's to 1e-5.
    Taking P from the rounded lse and delta = rowsum(dO o O), it left 1e-3
    in dQ and dK.  The statistics' plain version is exact there too: 1 / l
    = 1 and delta = the max key's dP o D on every row."""
    import math

    g = torch.Generator().manual_seed(0)
    h, d = 2, 32
    lens = torch.tensor(lengths, dtype=torch.int32)
    q, k = _saturated_qk(b, t, h, d, lens, g, last_step)
    v, dout = (torch.randn(b, t, h, d, generator=g) for _ in range(2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, _ = flash_attention(*leaves, kv_lengths=lens, dropout_rate=rate, dropout_seed=7)
    (out * dout).sum().backward()
    q6, k6, v6 = (x.double().requires_grad_() for x in (q, k, v))
    keys = torch.arange(t)[None, None, None, :] < lens[:, None, None, None].long()
    s = torch.einsum("bqhd,bkhd->bhqk", q6, k6) / math.sqrt(d)
    p = torch.softmax(torch.where(keys, s, torch.tensor(-1e30, dtype=s.dtype)), dim=-1)
    if rate:
        keep = attention_dropout_mask(7, b, h, t, t, rate, "cpu")
        p = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
    (torch.einsum("bhqk,bkhd->bqhd", p, v6) * dout.double()).sum().backward()
    assert float(q6.grad.abs().max()) == 0.0 and float(k6.grad.abs().max()) == 0.0
    assert float(leaves[0].grad.abs().max()) == 0.0 and float(leaves[1].grad.abs().max()) == 0.0
    assert float((leaves[2].grad.double() - v6.grad).abs().max()) <= 1e-5
    _, inv, delta = flash_bwd_stats_reference(q, k, v, dout, lens, False, None, rate, 7)
    dpd = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    if rate:
        dpd = torch.where(keep, dpd / (1.0 - rate), torch.zeros_like(dpd))
    top = torch.where(keys, s.float(), torch.tensor(float("-inf"))).argmax(-1, keepdim=True)
    assert (inv == 1.0).all()
    assert torch.equal(delta, dpd.gather(-1, top)[..., 0])


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
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths,saturated", [
    c + (False,) for c in FLASH_CASES + [
        (64, 127, 127, 8, 64, False, None),
        (64, 25, 25, 8, 64, True, None),
        (64, 25, 127, 8, 64, False, None),
        (2, 130, 130, 4, 128, True, [130, 0]),
    ]
] + [(4, 80, 80, 2, 64, False, [80, 70, 65, 80], True)])
def test_flash_bwd_kernels_match_plain(cuda_card, dtype, tol, rate, b, tq, tk, h,
                                       d, causal, lengths, saturated):
    """Forward (with dropout) and dq / dk / dv through autograd on the card
    against the plain versions on the same inputs and seed.  `saturated`:
    every softmax row one-hot with its max in the row's last key step
    (`_saturated_qk`), where dq and dk must be exactly 0, as the true
    gradient."""
    gen = torch.Generator().manual_seed(tq * 3 + tk)
    q, k, v = (torch.randn(b, t, h, d, generator=gen) for t in (tq, tk, tk))
    if saturated:
        q, k = _saturated_qk(b, tq, h, d, torch.tensor(lengths), gen, True)
    q, k, v = (x.to("cuda", dtype).requires_grad_() for x in (q, k, v))
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
    if saturated:
        assert not grads[0].any() and not grads[1].any()


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
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths,saturated", [
    c + (False,) for c in BWD_EDGE_CASES
] + [(2, 139, 139, 2, 64, False, [139, 100], True)])
def test_flash_bwd_kernels_tile_edges(cuda_card, dtype, tol, rate, b, tq, tk, h, d,
                                      causal, lengths, saturated):
    """dq, dk, dv of the backward kernels against the plain backward on the
    same forward outputs, with a non-contiguous dO; keys past a length get
    exactly zero gradients.  `saturated`: every row one-hot with its max in
    the row's last key step (step 5 of 5 at length 139), dq and dk exactly
    0."""
    q, k, v, dout = _bwd_case(b, tq, tk, h, d, dtype, tq * 7 + tk)
    if saturated:
        gen = torch.Generator().manual_seed(tq)
        for view, x in zip((q, k), _saturated_qk(b, tq, h, d, torch.tensor(lengths), gen, True)):
            view.copy_(x)
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
    if saturated:
        assert not got[0].any() and not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths", BWD_EDGE_CASES)
def test_flash_bwd_stats_kernel_matches_plain(cuda_card, dtype, rate, b, tq, tk, h, d,
                                              causal, lengths):
    """The statistics pass alone against its plain version, to 1e-4 in
    both dtypes: both compute in f32 from the same inputs (bf16 products
    are exact in f32), so only the order of f32 sums differs.  m and delta
    are held over max(1, their largest magnitude), 1 / l relative to each
    row's own 1 / l; rows without a valid key give 0, 0, 0."""
    q, k, v, dout = _bwd_case(b, tq, tk, h, d, dtype, tq * 11 + tk)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else 0
    before = flash_bwd_stats.launches
    got = flash_bwd_stats(q, k, v, dout, lens, causal, None, rate, seed)
    assert flash_bwd_stats.launches == before + 1
    want = flash_bwd_stats_reference(q, k, v, dout, lens, causal, None, rate, seed)
    (m, inv, delta), (m_w, inv_w, delta_w) = got, want
    assert (m - m_w).abs().max().item() <= 1e-4 * max(1.0, m_w.abs().max().item())
    assert torch.equal(inv == 0, inv_w == 0)
    assert ((inv - inv_w).abs() <= 1e-4 * inv_w).all()
    assert (delta - delta_w).abs().max().item() <= 1e-4 * max(1.0, delta_w.abs().max().item())
    if lens is not None:
        for i, n in enumerate(lengths):
            if n == 0:
                assert not got[:, i].any()


# The routes of the backward at the shapes PERF.md times (B, Tq, Tk): the
# training batches of the flagship's encoder, decoder and cross-attention,
# the CIF decoder, the Transformer LM, the streaming chunk mode, the text
# CTC model, bench_flash's two shapes and wav2vec's largest batch.
ROUTE_SHAPES = [
    # name, tq, tk, bf16 route
    ("encoder (5+6)", 139, 139, 1),
    ("decoder", 32, 32, 0),
    ("cross", 32, 139, 0),
    ("CIF decoder (5+6c)", 32, 32, 0),
    ("LM (5+6l)", 64, 64, 0),
    ("chunk mode (5+6ch)", 339, 339, 1),
    ("text CTC (5+6p)", 120, 120, 1),
    ("bench_flash (8, 256)", 256, 256, 1),
    ("bench_flash (16, 2048)", 2048, 2048, 1),
    ("wav2vec (5+6w)", 2802, 2802, 1),
    ("the crossover", 71, 2048, 0),
    ("the crossover", 72, 72, 1),
]


@pytest.mark.parametrize("name,tq,tk,route", ROUTE_SHAPES)
def test_bwd_route_of_each_timed_shape(name, tq, tk, route):
    """bf16 takes the wgmma kernels where the crossover measured on the card
    puts them, the same route for all three kernels (a function of Tq and
    Tk alone); f32 always the mma.sync kernels."""
    assert bwd_route(torch.bfloat16, tq, tk) == route, name
    assert bwd_route(torch.bfloat16, tk, tq) == route, name
    assert bwd_route(torch.float32, tq, tk) == 0


# The wgmma route (bf16, `bwd_route` 1): blocks of 128 keys or queries,
# query steps of 64 (32 at D 128) and key steps of 64, ragged at both ends;
# key padding (a length of 0 too), causal, the chunk mask, D 32, 64 and
# 128, Tq != Tk both ways
WGMMA_CASES = [
    # b, tq, tk, h, d, causal, kv_lengths, chunk mask (chunk, left, phase)
    (2, 1100, 1100, 4, 64, False, [1100, 1037], None),
    (2, 1100, 1100, 4, 64, True, None, None),
    (2, 1100, 1100, 4, 64, False, [1100, 700], (16, 4, 1)),
    (2, 1100, 1100, 4, 32, False, [1100, 1037], None),
    (2, 1100, 1100, 4, 128, True, [900, 1100], None),
    (2, 600, 1100, 4, 64, False, [1100, 517], None),
    (2, 1100, 517, 4, 128, False, [517, 0], None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,lengths,chunk", WGMMA_CASES)
def test_flash_bwd_wgmma_route_matches_plain(cuda_card, rate, b, tq, tk, h, d, causal,
                                             lengths, chunk):
    """The bf16 backward on the wgmma route against the plain backward on
    the same forward outputs, at the backward's tolerance of 5e-2 of max(1,
    |grad|), with a non-contiguous dO; padded keys get exactly zero
    gradients; the statistics pass alone to 1e-4 as on the other route."""
    from openasr_torch.ops.masks import ChunkMask

    assert bwd_route(torch.bfloat16, tq, tk) == 1
    q, k, v, dout = _bwd_case(b, tq, tk, h, d, torch.bfloat16, tq + 3 * tk + d)
    lens = None if lengths is None else torch.tensor(lengths, device="cuda")
    mask = None if chunk is None else ChunkMask(*chunk)
    seed = 987654321 if rate else 0
    out, lse = flash_attention_reference(q, k, v, lens, causal, None, rate, seed, mask)
    got = flash_attention_bwd(q, k, v, out, lse, dout, lens, causal, None, rate, seed, mask)
    want = flash_attention_bwd_reference(q, k, v, out, lse, dout, lens, causal, None, rate,
                                         seed, mask)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= 5e-2 * max(
            1.0, w.float().abs().max().item())
    if lens is not None:
        for i, n in enumerate(lengths):
            assert not got[1][i, n:].any() and not got[2][i, n:].any()
    (m, inv, delta) = flash_bwd_stats(q, k, v, dout, lens, causal, None, rate, seed, mask)
    m_w, inv_w, delta_w = flash_bwd_stats_reference(q, k, v, dout, lens, causal, None, rate,
                                                    seed, mask)
    assert (m - m_w).abs().max().item() <= 1e-4 * max(1.0, m_w.abs().max().item())
    assert torch.equal(inv == 0, inv_w == 0)
    assert ((inv - inv_w).abs() <= 1e-4 * inv_w).all()
    assert (delta - delta_w).abs().max().item() <= 1e-4 * max(1.0, delta_w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_bwd_wgmma_route_saturated_and_deterministic(cuda_card, rate):
    """The wgmma route where every softmax row is one-hot with its max in
    the row's last 64-key step: the statistics pass's S = Q K^T and dK/dV's
    S^T = K Q^T are the same bits, so 1 / l is exactly 1 and dQ and dK are
    exactly 0; and two calls give bit-identical gradients (no atomics)."""
    b, t, h, d, lengths = 2, 1100, 4, 64, [1100, 1037]
    gen = torch.Generator().manual_seed(t)
    q, k = _saturated_qk(b, t, h, d, torch.tensor(lengths), gen, True, step=64)
    v, dout = (torch.randn(b, t, h, d, generator=gen) for _ in range(2))
    q, k, v, dout = (x.to("cuda", torch.bfloat16) for x in (q, k, v, dout))
    lens = torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else 0
    out, lse = flash_attention_reference(q, k, v, lens, False, None, rate, seed)
    first = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, rate, seed)
    second = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, rate, seed)
    assert not first[0].any() and not first[1].any()
    assert (flash_bwd_stats(q, k, v, dout, lens, False, None, rate, seed)[1] == 1.0).all()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


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
    stats = torch.zeros((3, b, h, t), device="cuda")
    for call in (lambda: flash_attention_bwd(q, k, v, out, lse, dout),
                 lambda: flash_bwd_stats(q, k, v, dout),
                 lambda: flash_attention_bwd_dkv(q, k, v, out, lse, dout, stats),
                 lambda: flash_attention_bwd_dq(q, k, v, out, lse, dout, stats)):
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


# ----------------------------------------------------------- chunk mode

# b, t, h, d, kv_lengths, (chunk, left, phase): the streaming config's
# shape (chunk 16, left 4) at T' 139 and 300, rows whose chunk window
# starts past their length (left 0, and length 0), unlimited left context
CHUNK_CASES = [
    (3, 139, 8, 64, [139, 100, 37], (16, 4, 1)),
    (2, 300, 2, 64, [300, 180], (16, 4, 2)),
    (2, 65, 2, 32, [65, 9], (4, 0, 1)),
    (2, 77, 2, 128, [77, 50], (5, -1, 0)),
    (2, 17, 2, 64, [17, 0], (16, 1, 1)),
]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_chunk_mode_plain_backward_is_autograd_of_the_plain_forward(rate):
    """On the CPU the chunk mode's plain backward (and the statistics that
    the kernels take) equal autograd of the plain forward; rows that see no
    key have O = 0, lse = +inf, statistics (0, 0, 0) and zero gradients."""
    from openasr_torch.ops.masks import ChunkMask

    mask = ChunkMask(4, 0, 1)
    gen = torch.Generator().manual_seed(17)
    q, k, v, dout = (torch.randn(2, 13, 2, 8, generator=gen) for _ in range(4))
    lens = torch.tensor([13, 5])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    seed = 987654321 if rate else 0
    out, lse = flash_attention_reference(q, k, v, lens, False, None, rate, seed, mask)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, rate, seed, mask)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= FLASH_GRAD_TOL
    # row 1 (length 5): chunks 0-2 | 3-6 | 7-10 | 11-12, left 0: rows 7-12 see none
    assert (out[1, 7:] == 0).all() and torch.isinf(lse[1, :, 7:]).all()
    assert not flash_bwd_stats(q, k, v, dout, lens, False, None, rate, seed,
                               mask)[:, 1, :, 7:].any()
    assert not got[0][1, 7:].any() and not got[1][1, 5:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,h,d,lengths,mask", CHUNK_CASES)
def test_flash_chunk_kernels_match_plain(cuda_card, dtype, tol, rate, b, t, h, d, lengths,
                                         mask):
    """The chunk mode of the forward (O, lse), the statistics pass and the
    backward on the card against the plain versions (dense under
    chunk_bias) on the same inputs and seed: O to the forward's tolerance,
    the statistics to 1e-4, the gradients to the backward's; rows that see
    no key give O = 0, lse = +inf, statistics 0 and zero gradients."""
    from openasr_torch.ops.masks import ChunkMask

    mask = ChunkMask(*mask)
    q, k, v, dout = _bwd_case(b, t, t, h, d, dtype, t * 5 + h)
    lens = torch.tensor(lengths, device="cuda")
    seed = 987654321 if rate else 0
    before = (flash_attention.launches + flash_attention.dropout_launches,
              flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    out, lse = flash_attention(q, k, v, kv_lengths=lens, dropout_rate=rate,
                               dropout_seed=seed, chunk_mask=mask)
    stats = flash_bwd_stats(q, k, v, dout, lens, False, None, rate, seed, mask)
    got = flash_attention_bwd(q, k, v, out, lse, dout, lens, False, None, rate, seed, mask)
    after = (flash_attention.launches + flash_attention.dropout_launches,
             flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
             flash_attention_bwd_dq.launches)
    assert after == (before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 1)
    out_r, lse_r = flash_attention_reference(q, k, v, lens, False, None, rate, seed, mask)
    fwd_tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - out_r.float()).abs().max().item() <= fwd_tol
    empty = torch.isinf(lse_r)
    assert torch.equal(torch.isinf(lse), empty)
    assert (lse - lse_r)[~empty].abs().max().item() <= 1e-4 * max(1.0, lse_r[~empty].abs().max())
    want_stats = flash_bwd_stats_reference(q, k, v, dout, lens, False, None, rate, seed, mask)
    (m, inv, delta), (m_w, inv_w, delta_w) = stats, want_stats
    assert (m - m_w).abs().max().item() <= 1e-4 * max(1.0, m_w.abs().max().item())
    assert torch.equal(inv == 0, inv_w == 0) and torch.equal(inv == 0, empty)
    assert ((inv - inv_w).abs() <= 1e-4 * inv_w).all()
    assert (delta - delta_w).abs().max().item() <= 1e-4 * max(1.0, delta_w.abs().max().item())
    want = flash_attention_bwd_reference(q, k, v, out_r, lse_r, dout, lens, False, None,
                                         rate, seed, mask)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= tol * max(
            1.0, w.float().abs().max().item())
    rows = empty.any(dim=1)  # [B, T]: no head sees a key
    assert not out[rows].any() and not got[0][rows].any()
    for i, n in enumerate(lengths):
        assert not got[1][i, n:].any() and not got[2][i, n:].any()
