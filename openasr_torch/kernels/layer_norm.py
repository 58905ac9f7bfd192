"""LayerNorm forward and backward: the Hopper kernels and their plain versions.

Counterpart of openasr_tpu/kernels/layer_norm.py (`fused_layer_norm` :265,
custom VJP :245-262, `layer_norm_reference` :280): statistics in f32 with
var = E[x^2] - E[x]^2, y = (x - mean) * rstd * gamma + beta cast back to
x's dtype.  Unlike torch.nn.LayerNorm (eps 1e-5, two-pass variance) this
is the JAX package's exact formula.

The wrappers call the operators `torch.ops.openasr.layer_norm_fwd` and
`layer_norm_bwd` (kernels/ops.py), whose CUDA implementations launch
csrc/layer_norm.cu and whose CPU implementations are the plain versions;
there is no other route.  `fused_layer_norm` is differentiable through the
forward operator's autograd formula, which saves x, gamma, mean and rstd
and calls the backward operator (dx, dgamma and dbeta from one library
call: the row kernel and its column sum).

The LayerNorm of a sequence-parallel site (models/layers.py:
`layer_norm_rows`) takes the same forward operator and the backward
operator's dx-only mode (the JAX package's `_bwd_dx_kernel`, its SPMD
path), with dgamma and dbeta as column sums outside the kernel.
"""

from __future__ import annotations

import torch

from openasr_torch import kernels


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-6):
    """Plain version: -> (y in x.dtype, mean f32, rstd f32), the stats shaped
    like x without its last axis."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * rstd
    y = y * scale.float() + bias.float()
    return y.to(x.dtype), mu[..., 0], rstd[..., 0]


def layer_norm_bwd_reference(x, dy, scale, mean, rstd, dgamma_dbeta=True):
    """Plain version of the backward: -> (dx in x.dtype, dgamma f32,
    dbeta f32), or (dx, None, None) when `dgamma_dbeta` is False."""
    d = x.shape[-1]
    xf, dyf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    rs = rstd.reshape(-1, 1)
    xhat = (xf - mean.reshape(-1, 1)) * rs
    g = dyf * scale.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rs * (g - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    if not dgamma_dbeta:
        return dx, None, None
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


def _rows(t: torch.Tensor, d: int, name: str) -> torch.Tensor:
    t2 = t.reshape(-1, d)
    if t2.stride(1) != 1:
        raise ValueError(f"layer_norm: {name} must have unit stride on its last axis")
    return t2


def _check_params(x, **params):
    d = x.shape[-1]
    for name, t in params.items():
        if t.shape != (d,):
            raise ValueError(f"layer_norm: {name} must be [{d}], got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous float32 on {x.device}")
    if d < 1:
        raise ValueError(f"layer_norm: last dim {d} is empty")


def layer_norm_fwd_cuda(x, scale, bias, eps):
    """The forward kernel: the CUDA implementation of
    `torch.ops.openasr.layer_norm_fwd`."""
    _check_params(x, scale=scale, bias=bias)
    d = x.shape[-1]
    lead = x.shape[:-1]
    dtype = kernels.dtype_code(x.dtype)
    x2 = _rows(x, d, "x")
    n = x2.shape[0]
    y = torch.empty((n, d), dtype=x.dtype, device=x.device)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n:
        code = kernels.library().openasr_layer_norm_fwd(
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, d, x2.stride(0), y.stride(0),
            float(eps), dtype, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        kernels.check(code, "layer_norm_fwd")
        fused_layer_norm.launches += 1
    return y.reshape(*lead, d), mean.reshape(lead), rstd.reshape(lead)


def _partial_rows_at_most(n: int, d: int, device) -> int:
    """The most partial rows the backward's partials mode writes for n rows
    of d: one a block of 4 warps (csrc/layer_norm.cu, kWarps), with at most
    a block for every 4 rows and as many blocks as 2048 threads an SM hold;
    one a warp for rows wider than 1024 (kMaxRegD)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = min(-(-n // 4), sms * 2048 // 128)
    return blocks * (4 if d > 1024 else 1)


def layer_norm_bwd(x, dy, scale, mean, rstd, dgamma_dbeta: bool = True):
    """LayerNorm backward -> (dx in x.dtype, dgamma f32, dbeta f32).

    x, dy: [..., D] (f32 or bf16); scale f32 [D]; mean, rstd: f32, shaped
    like x without its last axis (the forward's).  One library call gives
    all three: the row kernel writes dx and per-block dgamma / dbeta
    partials into a scratch buffer, and a second kernel sums them in a
    fixed order.
    `dgamma_dbeta=False` is the library's dx-only mode (the counterpart of
    the JAX package's `_bwd_dx_kernel`): it returns (dx, None, None).
    CUDA tensors launch csrc/layer_norm.cu; CPU tensors take
    `layer_norm_bwd_reference`."""
    dx, dg, db = torch.ops.openasr.layer_norm_bwd(x, dy, scale, mean, rstd,
                                                 bool(dgamma_dbeta))
    return (dx, dg, db) if dgamma_dbeta else (dx, None, None)


def layer_norm_bwd_cuda(x, dy, scale, mean, rstd, dgamma_dbeta):
    """The backward kernels: the CUDA implementation of
    `torch.ops.openasr.layer_norm_bwd`; dgamma and dbeta come back empty
    ([0]) in the dx-only mode, as the operator's schema has no optional
    outputs."""
    _check_params(x, scale=scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("layer_norm_bwd: dy must match x's shape, dtype and device")
    d = x.shape[-1]
    x2 = _rows(x, d, "x")
    dy2 = dy.reshape(-1, d)
    if dy2.stride(1) != 1:
        dy2 = dy2.contiguous()
    n = x2.shape[0]
    stats = []
    for name, t in (("mean", mean), ("rstd", rstd)):
        t = t.reshape(-1)
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"layer_norm_bwd: {name} must be f32 [{n}] on {x.device}")
        stats.append(t.contiguous())
    dx = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0:
        zero = torch.zeros((d,), dtype=torch.float32, device=x.device)
        return dx.reshape(x.shape), *((zero, zero.clone()) if dgamma_dbeta else _no_dgamma(x))
    if dgamma_dbeta:
        rows = _partial_rows_at_most(n, d, x.device)
        # (the launch uses its first 2 * r * d floats, as [2, r, d], r <= rows)
        scratch = torch.empty((2 * rows * d,), dtype=torch.float32, device=x.device)
        dg = torch.empty((d,), dtype=torch.float32, device=x.device)
        db = torch.empty((d,), dtype=torch.float32, device=x.device)
        outs = (dg.data_ptr(), db.data_ptr(), scratch.data_ptr(), rows)
    else:
        outs = (None, None, None, 0)
    code = kernels.library().openasr_layer_norm_bwd(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), dx.data_ptr(), *outs, n, d, x2.stride(0), dy2.stride(0),
        dx.stride(0), kernels.dtype_code(x.dtype), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(code, "layer_norm_bwd")
    if not dgamma_dbeta:
        layer_norm_bwd.dx_launches += 1
        return dx.reshape(x.shape), *_no_dgamma(x)
    layer_norm_bwd.launches += 1
    return dx.reshape(x.shape), dg, db


def _no_dgamma(x):
    """The dx-only mode's dgamma and dbeta: two empty f32 tensors."""
    return (torch.empty((0,), dtype=torch.float32, device=x.device),
            torch.empty((0,), dtype=torch.float32, device=x.device))


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6):
    """LayerNorm over the last axis: -> (y, mean, rstd) as
    `layer_norm_reference`, differentiable in x, scale and bias.  CUDA
    tensors go through the kernels (x f32 or bf16, any last dim;
    scale/bias f32); CPU tensors through the plain versions."""
    return torch.ops.openasr.layer_norm_fwd(x, scale, bias, float(eps))


# kernel launches since the last reset (the plain route never counts);
# layer_norm_bwd counts its partials mode and its dx-only mode apart
fused_layer_norm.launches = 0
layer_norm_bwd.launches = 0
layer_norm_bwd.dx_launches = 0

from openasr_torch.kernels import ops  # noqa: E402,F401  (registers torch.ops.openasr)
