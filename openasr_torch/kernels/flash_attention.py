"""Flash attention forward and backward: the Hopper kernels and their plain
PyTorch versions.

Counterpart of openasr_tpu/kernels/flash_attention.py (`flash_attention`
:627, forward `_fwd_kernel` :146, backward `_bwd_dkv_kernel` :238 and
`_bwd_dq_kernel` :327, custom VJP :567-596) in the [B, T, H, D] layout:
key padding from `kv_lengths`, an optional causal mask, sm_scale 1/sqrt(D)
by default, fully masked rows giving O = 0 and lse = +inf, and attention
dropout through the stateless positional hash mask (:78-134) that
`attention_dropout_mask` reproduces bit for bit.

The kernels are instantiated at D = 32, 64 and 128.  On the card the
wrappers zero-pad any other D up to the next of them, as the JAX wrapper
pads to a lane width (:670-672): zero columns of q and k leave QK^T as it
is, the extra columns of O, dQ, dK and dV are sliced off, sm_scale comes
from the true D, and the hash mask keys on positions, not on D.

The chunk mode (`chunk_mask`, a `ChunkMask`) is the mask of a streaming
encoder, which the JAX package applies as a dense bias
(`chunk_bias`, openasr_tpu/models/encoder.py:205-227) and the kernels as
a runtime mask that skips whole tiles outside each chunk window.  A query
that sees no key (a padded query whose window starts past the length)
gets O = 0, lse = +inf and zero gradients, where the JAX dense path gives
softmax over NEG_INF; nothing reads such rows.  It does not combine with
`causal`.

The wrappers call the operators `torch.ops.openasr.flash_fwd`,
`flash_bwd_stats`, `flash_bwd_dkv` and `flash_bwd_dq` (kernels/ops.py),
whose CUDA implementations launch the kernels and whose CPU
implementations are the plain versions.  `flash_attention` is
differentiable through the forward operator's autograd formula, which
saves q, k, v, O and lse; its backward launches three kernels: the statistics
pass (one walk over the keys that writes each query row's max m of the
log2-scaled scores, 1 / l with l = sum exp2(s' - m), and delta =
rowsum(P o dP o D) with P = exp2(s' - m) / l), then dK/dV and dQ, which
take P and delta from the same products, bit for bit, so that dS is
exactly 0 where a softmax row is one-hot.  Every wrapper launches
csrc/flash_attention*.cu for CUDA tensors and runs its plain version for
CPU tensors; there is no other route.  On the CPU, `flash_attention_bwd`
runs the plain backward once (the three backward operators' plain
versions would run it twice over).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from openasr_torch import kernels
from openasr_torch.ops.masks import (
    NEG_INF,
    ChunkMask,
    causal_bias,
    chunk_bias,
    combine_bias,
    padding_bias,
)

HEAD_DIMS = (32, 64, 128)
LOG2E = 1.4426950408889634
_GOLDEN = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ dropout mask


def keep_threshold(dropout_rate: float) -> int:
    """uint32 keep threshold: a weight is kept where its hash is below it."""
    return min(int(round((1.0 - dropout_rate) * 4294967296.0)), 4294967295)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64: products wrap mod
    2^64 and their low 32 bits stay exact, so masking after each multiply
    gives the uint32 result."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def attention_dropout_mask(seed: int, b: int, h: int, tq: int, tk: int,
                           dropout_rate: float, device=None) -> torch.Tensor:
    """Keep mask bool [B, H, Tq, Tk] (True = keep) of the kernels' dropout:
    the hash of (seed, b*H + h, qpos, kpos), equal bit for bit to the JAX
    package's `attention_dropout_mask`."""
    i64 = dict(dtype=torch.int64, device=device)
    bh = (torch.arange(b, **i64)[:, None] * h + torch.arange(h, **i64)[None, :])
    qpos = torch.arange(tq, **i64)[:, None]
    kpos = torch.arange(tk, **i64)[None, :]
    x = (qpos * 2654435761 + kpos) & _MASK32                      # [Tq, Tk]
    mix = (int(seed) + bh * _GOLDEN) & _MASK32                     # [B, H]
    x = x[None, None] ^ mix[:, :, None, None]
    return _fmix32(x) < keep_threshold(dropout_rate)


def draw_dropout_seed(generator: torch.Generator) -> int:
    """A uint32 hash seed for one dropping call, drawn from the caller's
    (CPU) generator, as the JAX layer draws its seed from the dropout rng."""
    return int(torch.randint(0, 1 << 32, (1,), generator=generator, dtype=torch.int64))


# ---------------------------------------------------------- plain versions
#
# The plain versions run in f32 with autocast off, as the kernels do: under
# bf16 autocast (training in bfloat16) einsum would otherwise drop to bf16.


def _f32_plain(fn):
    @functools.wraps(fn)
    def wrapped(q, *args, **kwargs):
        with torch.autocast(q.device.type, enabled=False):
            return fn(q, *args, **kwargs)

    return wrapped


def _bias(q, k, kv_lengths, causal, chunk_mask=None):
    b, tq = q.shape[:2]
    tk = k.shape[1]
    lengths = (
        kv_lengths.to(q.device) if kv_lengths is not None
        else torch.full((b,), tk, device=q.device)
    )
    t = max(tq, tk)
    return combine_bias(
        padding_bias(lengths, tk),
        causal_bias(t, q.device)[..., :tq, :tk] if causal else None,
        None if chunk_mask is None
        else chunk_bias(t, *chunk_mask, device=q.device)[..., :tq, :tk],
    )


def _mask_args(causal, chunk_mask):
    """The C interface's mask arguments (causal, chunk, left, phase);
    raises on a mask the kernels do not take."""
    if chunk_mask is None:
        return int(causal), 0, -1, 0
    chunk, left, phase = (int(x) for x in chunk_mask)
    if causal:
        raise ValueError("flash_attention: causal and chunk_mask do not combine")
    if chunk < 1 or phase < 0 or left >= 1 << 20:
        raise ValueError(f"flash_attention: chunk_mask {tuple(chunk_mask)} needs chunk >= 1, "
                         "phase >= 0 and left < 2^20")
    return 0, chunk, left, phase


@_f32_plain
def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
    chunk_mask: Optional[ChunkMask] = None,
):
    """Plain version: additive bias + f32 softmax, dropout on the normalized
    weights.  q [B, Tq, H, D], k/v [B, Tk, H, D] -> (out [B, Tq, H, D] in
    q.dtype, lse [B, H, Tq] f32)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bias = _bias(q, k, kv_lengths, causal, chunk_mask)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    scores = scores + bias
    valid = (bias > 0.5 * NEG_INF).expand_as(scores)
    m = scores.max(dim=-1, keepdim=True).values
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    has_any = l > 0
    probs = p / torch.where(has_any, l, torch.ones_like(l))
    if dropout_rate > 0.0:
        keep = attention_dropout_mask(dropout_seed, b, h, tq, tk, dropout_rate, q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    lse = torch.where(
        has_any, m + torch.log(l), torch.full_like(l, float("inf"))
    )[..., 0]
    return out.to(q.dtype), lse


@_f32_plain
def flash_attention_bwd_reference(q, k, v, out, lse, dout, kv_lengths=None,
                                  causal=False, sm_scale=None,
                                  dropout_rate=0.0, dropout_seed=0, chunk_mask=None):
    """Plain version of the backward in f32 -> (dq, dk, dv) in the dtypes
    of q, k, v: the softmax gradient dS = P o (dP - delta) with P
    recomputed as the forward computes it (rows summing to 1) and delta =
    rowsum(P o dP) from the same dP, as autograd of the forward takes it.
    So where a row is one-hot (scores of 1e4 and more, as at the recipe
    gate's first layer), dP - delta cancels exactly and dS is 0, as in the
    kernels, which take P from the row's max and 1 / l and delta from the
    same P and dP (`flash_bwd_stats`)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    bias = _bias(q, k, kv_lengths, causal, chunk_mask)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale + bias
    # the forward's probabilities, recomputed as the forward computes them
    # (rows sum to 1, so delta below cancels dp exactly where a row is
    # one-hot); lse = +inf on empty rows gives p = 0 there
    valid = (bias > 0.5 * NEG_INF).expand_as(s) & torch.isfinite(lse)[..., None]
    e = torch.where(valid, torch.exp(s - s.max(dim=-1, keepdim=True).values),
                    torch.zeros_like(s))
    p = e / torch.clamp_min(e.sum(dim=-1, keepdim=True), torch.finfo(e.dtype).tiny)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    p_drop = p
    if dropout_rate > 0.0:
        keep = attention_dropout_mask(dropout_seed, b, h, tq, tk, dropout_rate, q.device)
        scale = 1.0 / (1.0 - dropout_rate)
        p_drop = torch.where(keep, p * scale, torch.zeros_like(p))
        dp = torch.where(keep, dp * scale, torch.zeros_like(dp))
    delta = (p * dp).sum(-1, keepdim=True)  # [B, H, Tq, 1]
    ds = p * (dp - delta) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------- the kernels


def padded_head_dim(d: int) -> int:
    """The kernel instantiation a head dim `d` runs at: the least of
    HEAD_DIMS that is >= d.  Raises ValueError above the largest."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head dim {d} above the largest kernel's "
                     f"{HEAD_DIMS[-1]}")


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """[B, T, H, D] -> [B, T, H, dp], zero columns past D (t itself when D is
    dp already)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _check_qkv(q, k, v):
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
        raise ValueError(f"flash_attention: the kernels take a head dim in {HEAD_DIMS}, "
                         f"got {d} (pad_head_dim pads it)")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must match q's dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride along D")


def _lengths_arg(kv_lengths, b, device):
    """-> (int32 lengths tensor or None, its pointer or None)."""
    if kv_lengths is None:
        return None, None
    if kv_lengths.shape != (b,):
        raise ValueError(f"flash_attention: kv_lengths must be [{b}]")
    lens = kv_lengths.to(device=device, dtype=torch.int32).contiguous()
    return lens, lens.data_ptr()


def _dropout_args(dropout_rate, seed):
    if dropout_rate <= 0.0:
        return 0, 0, 1.0, 0
    return seed, keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate), 1


def chunk_args(chunk_mask: Optional[ChunkMask]):
    """The operators' three ints of a chunk mask: (chunk, left, phase),
    chunk 0 = no chunk mask."""
    return (0, -1, 0) if chunk_mask is None else tuple(int(x) for x in chunk_mask)


def chunk_mask_of(chunk: int, left: int, phase: int) -> Optional[ChunkMask]:
    """The inverse of `chunk_args`."""
    return ChunkMask(chunk, left, phase) if chunk > 0 else None


def _scale(q, sm_scale) -> float:
    """sm_scale, 1 / sqrt(D) by default (D: q's true head dim)."""
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def flash_fwd_cuda(q, k, v, kv_lengths, causal, sm_scale, dropout_rate, seed,
                   chunk_mask=None):
    """The forward kernel: the CUDA implementation of
    `torch.ops.openasr.flash_fwd`; a head dim other than 32, 64 or 128 runs
    zero-padded, and O comes back contiguous at the true D."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp != d:
        out, lse = flash_fwd_cuda(*(pad_head_dim(t, dp) for t in (q, k, v)), kv_lengths,
                                  causal, sm_scale, dropout_rate, seed, chunk_mask)
        return out[..., :d].contiguous(), lse
    _check_qkv(q, k, v)
    check_flash_alignment(q=q, k=k, v=v)
    mask = _mask_args(causal, chunk_mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    lens, lens_ptr = _lengths_arg(kv_lengths, b, q.device)
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
            float(sm_scale), *mask, *_dropout_args(dropout_rate, seed),
            kernels.dtype_code(q.dtype), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        kernels.check(code, "flash_attention_fwd")
        if dropout_rate > 0.0:
            flash_attention.dropout_launches += 1
        else:
            flash_attention.launches += 1
    return out, lse


@_f32_plain
def flash_bwd_stats_reference(q, k, v, dout, kv_lengths=None, causal=False, sm_scale=None,
                              dropout_rate=0.0, dropout_seed=0, chunk_mask=None):
    """Plain version of the statistics pass -> [3, B, H, Tq] f32: for each
    query row, over its valid keys and in log2 units s' = S sm_scale
    log2(e), the max m, 1 / l with l = sum exp2(s' - m), and delta =
    rowsum(P o dP o D) with P = exp2(s' - m) / l (0, 0, 0 on a row with no
    valid key)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    valid = (_bias(q, k, kv_lengths, causal, chunk_mask) > 0.5 * NEG_INF).expand(b, h, tq, tk)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (sm_scale * LOG2E)
    s = torch.where(valid, s, torch.full_like(s, float("-inf")))
    any_key = valid.any(-1)
    m = torch.where(any_key, s.amax(-1), torch.zeros_like(any_key, dtype=s.dtype))
    e = torch.where(valid, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    l = e.sum(-1)
    inv = torch.where(any_key, 1.0 / torch.where(any_key, l, torch.ones_like(l)),
                      torch.zeros_like(l))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    if dropout_rate > 0.0:
        keep = attention_dropout_mask(dropout_seed, b, h, tq, tk, dropout_rate, q.device)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), torch.zeros_like(dp))
    return torch.stack([m, inv, (e * dp).sum(-1) * inv])


def flash_bwd_stats(q, k, v, dout, kv_lengths=None, causal=False, sm_scale=None,
                    dropout_rate=0.0, dropout_seed=0, chunk_mask=None):
    """The backward's row statistics -> [3, B, H, Tq] f32, contiguous: each
    query row's max m of s' = S sm_scale log2(e), 1 / l with l = sum
    exp2(s' - m), and delta = rowsum(P o dP o D), P = exp2(s' - m) / l.
    The dK/dV and dQ kernels take all three and recompute P and dP as this
    kernel does, bit for bit.  CUDA tensors launch the statistics pass of
    csrc/flash_attention_bwd.cu (one walk over the keys); CPU tensors take
    `flash_bwd_stats_reference`."""
    return torch.ops.openasr.flash_bwd_stats(
        q, k, v, dout, kv_lengths, bool(causal), _scale(q, sm_scale), float(dropout_rate),
        int(dropout_seed), *chunk_args(chunk_mask))


def flash_bwd_stats_cuda(q, k, v, dout, kv_lengths, causal, sm_scale, dropout_rate,
                         dropout_seed, chunk_mask=None):
    """The statistics pass: the CUDA implementation of
    `torch.ops.openasr.flash_bwd_stats`."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp != d:
        return flash_bwd_stats_cuda(*(pad_head_dim(t, dp) for t in (q, k, v, dout)),
                                    kv_lengths, causal, sm_scale, dropout_rate,
                                    dropout_seed, chunk_mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # every row is written, (0, 0, 0) where it has no valid key
    stats = torch.empty((3, b, h, tq), dtype=torch.float32, device=q.device)
    dout, _, lens, lens_ptr, strides = _bwd_inputs(q, k, v, dout, dout, stats, kv_lengths)
    if b * tq * tk * h == 0:
        return stats.zero_()
    code = kernels.library().openasr_flash_attention_bwd_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        lens_ptr, b, h, tq, tk, d, strides, float(sm_scale), *_mask_args(causal, chunk_mask),
        *_dropout_args(dropout_rate, dropout_seed), kernels.dtype_code(q.dtype),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(code, "flash_bwd_stats")
    flash_bwd_stats.launches += 1
    return stats


def check_flash_alignment(**views) -> None:
    """The forward and backward kernels copy rows of q, k, v (and dO) into
    shared memory with 16-byte cp.async: each [B, T, H, D] view must start
    on a 16-byte boundary, and its batch, time and head strides must be
    multiples of 16 bytes (8 bf16 or 4 f32 elements) where the dimension
    is longer than 1.  Raises ValueError naming the view and the
    condition."""
    for name, t in views.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must start on a 16-byte boundary "
                f"(its address is {t.data_ptr() % 16} bytes past one)")
        # a dimension of size 1 never steps by its stride
        if any(n > 1 and (s * t.element_size()) % 16
               for n, s in zip(t.shape[:3], t.stride()[:3])):
            raise ValueError(
                f"flash_attention: {name}'s batch, time and head strides "
                f"{tuple(t.stride()[:3])} must be multiples of 16 bytes "
                f"({16 // t.element_size()} elements)")


def _bwd_inputs(q, k, v, out, dout, stats, kv_lengths):
    """Checked kernel inputs of the backward: (dout with unit D stride,
    contiguous stats, lengths, lengths pointer, the 12 strides)."""
    _check_qkv(q, k, v)
    b, tq, h, d = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or out.shape != q.shape:
        raise ValueError("flash_attention bwd: dout and out must match q")
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    check_flash_alignment(q=q, k=k, v=v, dout=dout)
    if stats.shape != (3, b, h, tq) or stats.dtype != torch.float32:
        raise ValueError(f"flash_attention bwd: stats must be f32 [3, {b}, {h}, {tq}]")
    lens, lens_ptr = _lengths_arg(kv_lengths, b, q.device)
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, dout) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    return dout, stats.contiguous(), lens, lens_ptr, strides


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, stats, kv_lengths=None,
                            causal=False, sm_scale=None, dropout_rate=0.0,
                            dropout_seed=0, chunk_mask=None):
    """dK, dV of `flash_attention` -> (dk [B, Tk, H, D], dv), in k's dtype,
    with stats = `flash_bwd_stats(...)` of the same inputs.  CUDA tensors
    launch the dK/dV kernel, which takes P from the statistics, not from
    lse; CPU tensors take the plain backward (which forms its statistics
    itself)."""
    return torch.ops.openasr.flash_bwd_dkv(
        q, k, v, out, lse, dout, stats, kv_lengths, bool(causal), _scale(q, sm_scale),
        float(dropout_rate), int(dropout_seed), *chunk_args(chunk_mask))


def flash_bwd_dkv_cuda(q, k, v, out, lse, dout, stats, kv_lengths, causal, sm_scale,
                       dropout_rate, dropout_seed, chunk_mask=None):
    """The dK/dV kernel: the CUDA implementation of
    `torch.ops.openasr.flash_bwd_dkv`."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp != d:
        dk, dv = flash_bwd_dkv_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, out)), lse, pad_head_dim(dout, dp),
            stats, kv_lengths, causal, sm_scale, dropout_rate, dropout_seed, chunk_mask)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dout, stats, lens, lens_ptr, strides = _bwd_inputs(q, k, v, out, dout, stats, kv_lengths)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if b * tq * tk * h == 0:
        return dk.zero_(), dv.zero_()
    code = kernels.library().openasr_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        lens_ptr, dk.data_ptr(), dv.data_ptr(),
        b, h, tq, tk, d, strides, float(sm_scale), *_mask_args(causal, chunk_mask),
        *_dropout_args(dropout_rate, dropout_seed), kernels.dtype_code(q.dtype),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, out, lse, dout, stats, kv_lengths=None,
                           causal=False, sm_scale=None, dropout_rate=0.0,
                           dropout_seed=0, chunk_mask=None):
    """dQ of `flash_attention` -> dq [B, Tq, H, D] in q's dtype, with stats
    = `flash_bwd_stats(...)` of the same inputs.  CUDA tensors launch the
    dQ kernel; CPU tensors take the plain backward."""
    return torch.ops.openasr.flash_bwd_dq(
        q, k, v, out, lse, dout, stats, kv_lengths, bool(causal), _scale(q, sm_scale),
        float(dropout_rate), int(dropout_seed), *chunk_args(chunk_mask))


def flash_bwd_dq_cuda(q, k, v, out, lse, dout, stats, kv_lengths, causal, sm_scale,
                      dropout_rate, dropout_seed, chunk_mask=None):
    """The dQ kernel: the CUDA implementation of
    `torch.ops.openasr.flash_bwd_dq`."""
    d = q.shape[-1]
    dp = padded_head_dim(d)
    if dp != d:
        return flash_bwd_dq_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, out)), lse, pad_head_dim(dout, dp),
            stats, kv_lengths, causal, sm_scale, dropout_rate, dropout_seed,
            chunk_mask)[..., :d].contiguous()
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dout, stats, lens, lens_ptr, strides = _bwd_inputs(q, k, v, out, dout, stats, kv_lengths)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if b * tq * tk * h == 0:
        return dq.zero_()
    code = kernels.library().openasr_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        lens_ptr, dq.data_ptr(),
        b, h, tq, tk, d, strides, float(sm_scale), *_mask_args(causal, chunk_mask),
        *_dropout_args(dropout_rate, dropout_seed), kernels.dtype_code(q.dtype),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, out, lse, dout, kv_lengths=None, causal=False,
                        sm_scale=None, dropout_rate=0.0, dropout_seed=0, chunk_mask=None):
    """The whole backward of `flash_attention` -> (dq, dk, dv): on the card
    the statistics pass, then the dK/dV kernel and the dQ kernel; on the CPU
    the plain backward."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, kv_lengths,
                                             causal, sm_scale, dropout_rate,
                                             dropout_seed, chunk_mask)
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dp = padded_head_dim(d)
    if dp != d:  # pad once for both kernels
        grads = flash_attention_bwd(
            *(pad_head_dim(t, dp) for t in (q, k, v, out)), lse, pad_head_dim(dout, dp),
            kv_lengths, causal, sm_scale, dropout_rate, dropout_seed, chunk_mask)
        return tuple(g[..., :d] for g in grads)
    stats = flash_bwd_stats(q, k, v, dout, kv_lengths, causal, sm_scale, dropout_rate,
                            dropout_seed, chunk_mask)
    args = (q, k, v, out, lse, dout, stats, kv_lengths, causal, sm_scale,
            dropout_rate, dropout_seed, chunk_mask)
    dk, dv = flash_attention_bwd_dkv(*args)
    return flash_attention_bwd_dq(*args), dk, dv


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    chunk_mask: Optional[ChunkMask] = None,
):
    """Streaming masked attention -> (out [B, Tq, H, D], lse [B, H, Tq]),
    differentiable in q, k and v.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D], f32 or bf16, any strides with
    unit stride along D and 16-byte aligned rows on the card (the
    projection views are read in place; `check_flash_alignment`);
    kv_lengths: optional [B] int — keys >= length are masked; causal:
    query t attends to keys <= t; chunk_mask: the chunk mode of a
    streaming encoder (not with causal); D <= 128 on the card (any other D than
    32, 64 or 128 runs zero-padded to the next of them).
    dropout_rate > 0 drops normalized weights by the positional hash mask
    of `dropout_seed` (a uint32; `draw_dropout_seed` draws one)."""
    _mask_args(causal, chunk_mask)  # raises on a mask no route takes
    seed = 0
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout_rate > 0 needs a dropout_seed")
        seed = int(dropout_seed) & _MASK32
    return torch.ops.openasr.flash_fwd(q, k, v, kv_lengths, bool(causal), _scale(q, sm_scale),
                                       float(dropout_rate), seed, *chunk_args(chunk_mask))


# kernel launches since the last reset (the plain route never counts):
# the forward kernel without and with dropout, and the three backward ones
flash_attention.launches = 0
flash_attention.dropout_launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
flash_bwd_stats.launches = 0

from openasr_torch.kernels import ops  # noqa: E402,F401  (registers torch.ops.openasr)
