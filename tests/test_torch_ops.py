"""The kernels' operators (openasr_torch/kernels/ops.py, `torch.ops.openasr`).

On the CPU, `torch.library.opcheck` holds each of the 7 operators to its
registration: the schema, the fake (shapes, dtypes and strides against
the plain implementation's) and the autograd registration; the wrappers'
gradients through the autograd formulas of `layer_norm_fwd` and
`flash_fwd` (the backward operators) equal the plain backward's.  On a CUDA card each operator's CUDA implementation is held
against its plain version through `torch.ops.openasr.*`, at the
tolerances of tests/test_torch_kernels.py; those tests skip elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_ops.py
"""

import os
import re

import pytest
import torch

from openasr_torch.kernels import ops
from openasr_torch.kernels.fbank import (
    device_matrices,
    fbank_float64,
    fbank_reference,
    fused_fbank,
)
from openasr_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_bwd_stats,
    flash_bwd_stats_reference,
)
from openasr_torch.kernels.layer_norm import (
    fused_layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_reference,
    layer_norm_reference,
)
from openasr_torch.ops.fbank import FbankConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.openasr
# the schema, the fake against the plain implementation, the autograd
# registration (the gradients themselves: test_wrappers_are_the_operators)
CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor")
# (kv_lengths, causal, sm_scale, dropout_rate, seed, chunk, left, phase)
MASKS = {
    "lengths": (torch.tensor([6, 3]), False, 0.25, 0.0, 0, 0, -1, 0),
    "causal dropout": (None, True, 0.25, 0.1, 7, 0, -1, 0),
    "chunk": (torch.tensor([6, 4]), False, 0.25, 0.0, 0, 2, 1, 1),
}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ln_inputs(device="cpu", dtype=torch.float32, shape=(2, 5, 48)):
    g = _gen(0)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(device, dtype)
    scale = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(device)
    bias = (0.1 * torch.randn(shape[-1], generator=g)).to(device)
    return x, scale, bias


def _qkv(device="cpu", dtype=torch.float32, shape=(2, 6, 2, 16)):
    g = _gen(1)
    return tuple(torch.randn(shape, generator=g).to(device, dtype) for _ in range(4))


def _fbank_args(device="cpu", nfft_pow2=True):
    cfg = FbankConfig(num_mel_bins=20) if nfft_pow2 else FbankConfig(
        num_mel_bins=20, round_to_power_of_two=False)
    m = device_matrices(cfg, torch.device(device))
    frames = torch.randn(2, 7, cfg.window_size, generator=_gen(2)).to(device) * 100
    lens = torch.tensor([7, 4], dtype=torch.int32, device=device)
    return cfg, (frames, lens, m["window"], m["twiddle"], m["twiddle_lo"], m["mel_idx"],
                 m["mel_w"], m["mel_order"], m.get("cs"), m["mc"], m["ms"], m["mel_t"],
                 cfg.padded_window_size, cfg.num_mel_bins, cfg.preemphasis,
                 cfg.remove_dc_offset, cfg.use_log_fbank)


def test_every_kernel_entry_point_is_an_operator():
    assert set(ops.SCHEMAS) == {"layer_norm_fwd", "layer_norm_bwd", "flash_fwd", "flash_bwd_stats",
                            "flash_bwd_dkv", "flash_bwd_dq", "fbank"}
    for name in ops.SCHEMAS:
        assert hasattr(OPS, name)
    # no kernel launch hides in an autograd.Function any more
    src_dir = os.path.join(ROOT, "openasr_torch", "kernels")
    for fn in os.listdir(src_dir):
        if fn.endswith(".py"):
            with open(os.path.join(src_dir, fn)) as f:
                assert not re.search(r"autograd\.Function", f.read()), fn


def test_opcheck_layer_norm():
    x, scale, bias = _ln_inputs()
    grads = tuple(t.clone().requires_grad_() for t in (x, scale, bias))
    torch.library.opcheck(OPS.layer_norm_fwd, grads + (1e-6,), test_utils=CHECKS)
    _, mean, rstd = OPS.layer_norm_fwd(x, scale, bias, 1e-6)
    for partials in (True, False):
        args = (x, torch.randn_like(x), scale, mean, rstd, partials)
        torch.library.opcheck(OPS.layer_norm_bwd, args, test_utils=CHECKS)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_opcheck_flash(mask):
    args = MASKS[mask]
    q, k, v, dout = _qkv()
    grads = tuple(t.clone().requires_grad_() for t in (q, k, v))
    torch.library.opcheck(OPS.flash_fwd, grads + args, test_utils=CHECKS)
    out, lse = OPS.flash_fwd(q, k, v, *args)
    torch.library.opcheck(OPS.flash_bwd_stats, (q, k, v, dout) + args, test_utils=CHECKS)
    stats = OPS.flash_bwd_stats(q, k, v, dout, *args)
    for op in (OPS.flash_bwd_dkv, OPS.flash_bwd_dq):
        torch.library.opcheck(op, (q, k, v, out, lse, dout, stats) + args, test_utils=CHECKS)


def test_opcheck_fbank():
    _, args = _fbank_args()
    torch.library.opcheck(OPS.fbank, args, test_utils=CHECKS)


def test_wrappers_are_the_operators_on_the_cpu():
    """The wrappers give what their operators give, and autograd of the
    forward operators is the plain backward's."""
    x, scale, bias = _ln_inputs()
    assert all(torch.equal(a, b) for a, b in zip(fused_layer_norm(x, scale, bias),
                                                 layer_norm_reference(x, scale, bias)))
    xg = x.clone().requires_grad_()
    dy = torch.randn_like(x)
    fused_layer_norm(xg, scale, bias)[0].backward(dy)
    _, mean, rstd = layer_norm_reference(x, scale, bias)
    want = layer_norm_bwd_reference(x, dy, scale, mean, rstd)[0]
    assert torch.equal(xg.grad, want)
    assert layer_norm_bwd(x, dy, scale, mean, rstd, False)[1:] == (None, None)

    q, k, v, dout = _qkv()
    lens = torch.tensor([6, 3])
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = flash_attention(qg, kg, vg, kv_lengths=lens)
    want_out, want_lse = flash_attention_reference(q, k, v, lens)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    out.backward(dout)
    grads = flash_attention_bwd_reference(q, k, v, want_out, want_lse, dout, lens)
    for got, want in zip((qg.grad, kg.grad, vg.grad), grads):
        assert torch.equal(got, want)

    cfg, args = _fbank_args()
    assert torch.equal(fused_fbank(args[0], args[1], cfg), fbank_reference(args[0], args[1], cfg))


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,bwd_tol", [(torch.float32, 1e-5, 1e-4),
                                               (torch.bfloat16, 2e-2, 5e-2)])
def test_layer_norm_operators_on_the_card(cuda_card, dtype, tol, bwd_tol):
    """test_torch_kernels.py's tolerances: dgamma and dbeta relative to
    their largest magnitude (sums over the rows in another order)."""
    x, scale, bias = _ln_inputs("cuda", dtype, (37, 1024))
    before = fused_layer_norm.launches
    y, mean, rstd = OPS.layer_norm_fwd(x, scale, bias, 1e-6)
    assert fused_layer_norm.launches == before + 1
    assert (y.float() - layer_norm_reference(x, scale, bias)[0].float()).abs().max() <= tol
    dy = torch.randn_like(x)
    before = (layer_norm_bwd.launches, layer_norm_bwd.dx_launches)
    dx, dg, db = OPS.layer_norm_bwd(x, dy, scale, mean, rstd, True)
    dx1, dg1, db1 = OPS.layer_norm_bwd(x, dy, scale, mean, rstd, False)
    assert (layer_norm_bwd.launches, layer_norm_bwd.dx_launches) == (before[0] + 1,
                                                                       before[1] + 1)
    assert dg1.numel() == 0 and db1.numel() == 0
    dx_r, dg_r, db_r = layer_norm_bwd_reference(x, dy, scale, mean, rstd)
    for got, want, rel in ((dx, dx_r, False), (dx1, dx_r, False), (dg, dg_r, True),
                           (db, db_r, True)):
        scale_ = want.float().abs().max().item() if rel else 1.0
        assert (got.float() - want.float()).abs().max().item() <= bwd_tol * max(scale_, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("d", [16, 64])
def test_flash_operators_on_the_card(cuda_card, mask, d):
    """D 16 runs padded to 32 inside the operator; O and the gradients come
    back contiguous at the true D."""
    lens, *rest = MASKS[mask]
    lens = None if lens is None else torch.tensor([70, 33], device="cuda")
    args = (lens, *rest)
    plain = (lens, *rest[:4], None if rest[4] == 0 else tuple(rest[4:]))
    q, k, v, dout = _qkv("cuda", torch.float32, (2, 70, 2, d))
    before = flash_attention.launches + flash_attention.dropout_launches
    out, lse = OPS.flash_fwd(q, k, v, *args)
    assert flash_attention.launches + flash_attention.dropout_launches == before + 1
    assert out.is_contiguous() and out.shape == q.shape
    assert (out - flash_attention_reference(q, k, v, *plain)[0]).abs().max().item() <= 1e-5
    before = (flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    stats = OPS.flash_bwd_stats(q, k, v, dout, *args)
    want = flash_bwd_stats_reference(q, k, v, dout, *plain)
    assert ((stats - want).abs() <= 1e-4 * (1 + want.abs())).all()
    dk, dv = OPS.flash_bwd_dkv(q, k, v, out, lse, dout, stats, *args)
    dq = OPS.flash_bwd_dq(q, k, v, out, lse, dout, stats, *args)
    assert (flash_bwd_stats.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    grads = flash_attention_bwd_reference(q, k, v, out, lse, dout, *plain)
    for got, want in zip((dq, dk, dv), grads):
        assert got.is_contiguous()
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("nfft_pow2", [True, False])
def test_fbank_operator_on_the_card(cuda_card, nfft_pow2):
    cfg, args = _fbank_args("cuda", nfft_pow2)
    before = fused_fbank.launches
    got = OPS.fbank(*args)
    assert fused_fbank.launches == before + 1
    want = fbank_reference(args[0], args[1], cfg)
    # the kernel computes in float64 (kernels/fbank.py): within the plain
    # version's own float64 error of it, + 1e-5
    plain_err = (want.double() - fbank_float64(args[0], args[1], cfg)).abs().max().item()
    assert (got - want).abs().max().item() <= plain_err + 1e-5
