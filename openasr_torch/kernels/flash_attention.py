"""Flash attention forward: the Hopper kernel and its plain PyTorch version.

Counterpart of openasr_tpu/kernels/flash_attention.py (`flash_attention`
:627, forward kernel `_fwd_kernel` :146) in the [B, T, H, D] layout:
key padding from `kv_lengths`, an optional causal mask, sm_scale 1/sqrt(D)
by default, fully masked rows giving O = 0 and lse = +inf.

`flash_attention` launches csrc/flash_attention.cu for CUDA tensors and
runs `flash_attention_reference` for CPU tensors; there is no other route.
Attention dropout (the TPU kernel's positional hash mask) belongs to the
training slice and is rejected until then.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from openasr_torch import kernels
from openasr_torch.ops.masks import NEG_INF, causal_bias, combine_bias, padding_bias

HEAD_DIMS = (32, 64, 128)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
):
    """Plain version: additive bias + f32 softmax.  q [B, Tq, H, D],
    k/v [B, Tk, H, D] -> (out [B, Tq, H, D] in q.dtype, lse [B, H, Tq] f32)."""
    b, tq, _, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lengths = (
        kv_lengths.to(q.device) if kv_lengths is not None
        else torch.full((b,), tk, device=q.device)
    )
    bias = combine_bias(
        padding_bias(lengths, tk),
        causal_bias(max(tq, tk), q.device)[..., :tq, :tk] if causal else None,
    )
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores + bias
    valid = (bias > 0.5 * NEG_INF).expand_as(scores)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    has_any = l > 0
    probs = p / torch.where(has_any, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    lse = torch.where(
        has_any, m + torch.log(l), torch.full_like(l, float("inf"))
    )[..., 0]
    return out.to(q.dtype), lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
):
    """Streaming masked attention -> (out [B, Tq, H, D], lse [B, H, Tq]).

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D], f32 or bf16, any strides with
    unit stride along D (the projection views are read in place);
    kv_lengths: optional [B] int — keys >= length are masked; causal:
    query t attends to keys <= t; D in (32, 64, 128) on the card."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout is ported with the training "
            "slice (ROADMAP queue 2, flash hash dropout)"
        )
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_lengths, causal, sm_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, T, H, D]")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} disagree"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must match q's dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride along D")
    dtype = kernels.dtype_code(q.dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lens_ptr = None
    if kv_lengths is not None:
        if kv_lengths.shape != (b,):
            raise ValueError(f"flash_attention: kv_lengths must be [{b}]")
        kv_lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        lens_ptr = kv_lengths.data_ptr()
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tk == 0:  # no keys at all: every row is fully masked
        return out.zero_(), lse.fill_(float("inf"))
    if b and tq:
        code = kernels.library().openasr_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr,
            out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(sm_scale), int(causal), dtype, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        kernels.check(code, "flash_attention_fwd")
        flash_attention.launches += 1
    return out, lse


# kernel launches since the last reset (the plain route never counts)
flash_attention.launches = 0
