"""LayerNorm forward: the Hopper kernel and its plain PyTorch version.

Counterpart of openasr_tpu/kernels/layer_norm.py (`fused_layer_norm` :265,
`layer_norm_reference` :280): statistics in f32 with var = E[x^2] - E[x]^2,
y = (x - mean) * rstd * gamma + beta cast back to x's dtype.  Unlike
torch.nn.LayerNorm (eps 1e-5, two-pass variance) this is the JAX
package's exact formula.

`fused_layer_norm` launches csrc/layer_norm.cu for a CUDA tensor and runs
`layer_norm_reference` for a CPU tensor; there is no other route.
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


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6):
    """LayerNorm over the last axis: -> (y, mean, rstd) as
    `layer_norm_reference`.  CUDA tensors go through the kernel (x f32 or
    bf16, last dim <= 1024; scale/bias f32); CPU tensors through the plain
    version."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_layer_norm: no kernel for device {x.device}")
    d = x.shape[-1]
    lead = x.shape[:-1]
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(
            f"scale/bias must be [{d}], got {tuple(scale.shape)}, {tuple(bias.shape)}"
        )
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")
    if not 1 <= d <= 1024:
        raise ValueError(f"fused_layer_norm: last dim {d} outside [1, 1024]")
    dtype = kernels.dtype_code(x.dtype)
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        raise ValueError("fused_layer_norm: x must have unit stride on its last axis")
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


# kernel launches since the last reset (the plain route never counts)
fused_layer_norm.launches = 0
