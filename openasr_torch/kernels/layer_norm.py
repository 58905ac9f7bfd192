"""LayerNorm forward and backward: the Hopper kernels and their plain versions.

Counterpart of openasr_tpu/kernels/layer_norm.py (`fused_layer_norm` :265,
custom VJP :245-262, `layer_norm_reference` :280): statistics in f32 with
var = E[x^2] - E[x]^2, y = (x - mean) * rstd * gamma + beta cast back to
x's dtype.  Unlike torch.nn.LayerNorm (eps 1e-5, two-pass variance) this
is the JAX package's exact formula.

`fused_layer_norm` is differentiable: a `torch.autograd.Function` saves x,
gamma, mean and rstd, and its backward is `layer_norm_bwd` (dx plus the
per-block dgamma / dbeta partials of one kernel, summed here).  Each
wrapper launches csrc/layer_norm.cu for a CUDA tensor and runs its plain
version for a CPU tensor; there is no other route.
"""

from __future__ import annotations

import torch

from openasr_torch import kernels

# rows of one LayerNorm block (csrc/layer_norm.cu kRowsPerBlock)
_ROWS_PER_BLOCK = 4


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
    if not 1 <= d <= 1024:
        raise ValueError(f"layer_norm: last dim {d} outside [1, 1024]")


def _layer_norm_fwd(x, scale, bias, eps):
    """The forward kernel (CUDA) or its plain version (CPU)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_layer_norm: no kernel for device {x.device}")
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


def _partial_blocks(n: int, device: torch.device) -> int:
    """Blocks of the partials mode: two per SM (each warp then strides over
    several rows), never more than one row per warp."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // _ROWS_PER_BLOCK), 2 * sms))


def layer_norm_bwd(x, dy, scale, mean, rstd, dgamma_dbeta: bool = True):
    """LayerNorm backward -> (dx in x.dtype, dgamma f32, dbeta f32).

    x, dy: [..., D] (f32 or bf16, D <= 1024 on the card); scale f32 [D];
    mean, rstd: f32, shaped like x without its last axis (the forward's).
    One kernel gives dx and per-block dgamma / dbeta partials, summed here.
    `dgamma_dbeta=False` is the same kernel's dx-only mode (the counterpart
    of the JAX package's `_bwd_dx_kernel`): it returns (dx, None, None).
    CUDA tensors launch csrc/layer_norm.cu; CPU tensors take
    `layer_norm_bwd_reference`."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(x, dy, scale, mean, rstd, dgamma_dbeta)
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm_bwd: no kernel for device {x.device}")
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
        return dx.reshape(x.shape), *((zero, zero.clone()) if dgamma_dbeta else (None, None))
    if dgamma_dbeta:
        blocks = _partial_blocks(n, x.device)
        dg_part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
        db_part = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
        parts = (dg_part.data_ptr(), db_part.data_ptr())
    else:
        blocks = -(-n // _ROWS_PER_BLOCK)
        parts = (None, None)
    code = kernels.library().openasr_layer_norm_bwd(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), dx.data_ptr(), *parts, n, d, x2.stride(0),
        dy2.stride(0), dx.stride(0), blocks, kernels.dtype_code(x.dtype),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(code, "layer_norm_bwd")
    if not dgamma_dbeta:
        layer_norm_bwd.dx_launches += 1
        return dx.reshape(x.shape), None, None
    layer_norm_bwd.launches += 1
    return dx.reshape(x.shape), dg_part.sum(0), db_part.sum(0)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = _layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, dy.to(x.dtype), scale, mean, rstd)
        return dx, dg, db, None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6):
    """LayerNorm over the last axis: -> (y, mean, rstd) as
    `layer_norm_reference`, differentiable in x, scale and bias.  CUDA
    tensors go through the kernels (x f32 or bf16, last dim <= 1024;
    scale/bias f32); CPU tensors through the plain versions."""
    if torch.is_grad_enabled() and (
        x.requires_grad or scale.requires_grad or bias.requires_grad
    ):
        return _LayerNormFn.apply(x, scale, bias, float(eps))
    return _layer_norm_fwd(x, scale, bias, eps)


# kernel launches since the last reset (the plain route never counts);
# layer_norm_bwd counts its partials mode and its dx-only mode apart
fused_layer_norm.launches = 0
layer_norm_bwd.launches = 0
layer_norm_bwd.dx_launches = 0
