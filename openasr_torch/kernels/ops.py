"""The kernels' entry points as `torch.library` operators (`torch.ops.openasr`).

Every kernel wrapper (`fused_layer_norm`, `layer_norm_bwd`,
`flash_attention` and its backward wrappers, `fused_fbank`) calls one of
these operators, so that `torch.export` and CUDA-graph capture see each
launch as one node of the graph:

  layer_norm_fwd   (x, scale, bias, eps) -> (y, mean f32, rstd f32)
  layer_norm_bwd   (x, dy, scale, mean, rstd, dgamma_dbeta) -> (dx, dgamma,
                   dbeta), the last two empty [0] in the dx-only mode
  flash_fwd        (q, k, v, kv_lengths?, causal, sm_scale, dropout_rate,
                   seed, chunk, left, phase) -> (O, lse f32 [B, H, Tq])
  flash_bwd_stats  (q, k, v, dout, ...) -> f32 [3, B, H, Tq]
  flash_bwd_dkv    (q, k, v, out, lse, dout, stats, ...) -> (dk, dv)
  flash_bwd_dq     (q, k, v, out, lse, dout, stats, ...) -> dq
  fbank            (frames, feat_lengths, the kernel's tables, cs?, the
                   plain version's mc, ms, mel_t, nfft, num_mel_bins,
                   preemphasis, remove_dc_offset, use_log) -> f32 [B, T, M]

A chunk mask is three ints (chunk 0: none; `flash_attention.chunk_args`).
Each operator has two implementations, chosen by the dispatcher from the
device of its tensors: CUDA launches the kernel (and counts the launch on
its wrapper), CPU runs the plain version.  Neither falls back to the
other.  Outputs are fresh contiguous tensors (the fakes below say so), and
`layer_norm_fwd` and `flash_fwd` carry autograd formulas that call the
backward operators, so training and exported decoding go through the same
operators.  They are registered through `torch.library.Library` rather
than the `custom_op` decorator, whose extra Python layers cost more a call
(the decode beams are bound by the host's launches).
"""

from __future__ import annotations

import torch

from openasr_torch.kernels import fbank as _fbank
from openasr_torch.kernels import flash_attention as _flash
from openasr_torch.kernels import layer_norm as _ln

NAMESPACE = "openasr"
_LIB = torch.library.Library(NAMESPACE, "DEF")

_MASK = "bool causal, float sm_scale, float dropout_rate, int seed, int chunk, int left, int phase"
SCHEMAS = {
    "layer_norm_fwd": "(Tensor x, Tensor scale, Tensor bias, float eps) -> (Tensor, Tensor, Tensor)",
    "layer_norm_bwd": ("(Tensor x, Tensor dy, Tensor scale, Tensor mean, Tensor rstd, "
                       "bool dgamma_dbeta) -> (Tensor, Tensor, Tensor)"),
    "flash_fwd": f"(Tensor q, Tensor k, Tensor v, Tensor? kv_lengths, {_MASK}) -> (Tensor, Tensor)",
    "flash_bwd_stats": (f"(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor? kv_lengths, "
                        f"{_MASK}) -> Tensor"),
    "flash_bwd_dkv": (f"(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
                      f"Tensor stats, Tensor? kv_lengths, {_MASK}) -> (Tensor, Tensor)"),
    "flash_bwd_dq": (f"(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
                     f"Tensor stats, Tensor? kv_lengths, {_MASK}) -> Tensor"),
    "fbank": ("(Tensor frames, Tensor feat_lengths, Tensor window, Tensor twiddle, "
              "Tensor twiddle_lo, Tensor mel_idx, Tensor mel_w, Tensor mel_order, Tensor? cs, "
              "Tensor mc, Tensor ms, Tensor mel_t, int nfft, int num_mel_bins, "
              "float preemphasis, bool remove_dc_offset, bool use_log) -> Tensor"),
}


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _register(name, cpu, cuda, fake):
    _LIB.define(name + SCHEMAS[name])
    _LIB.impl(name, lambda *a: _contiguous(cpu(*a)), "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


# ---------------------------------------------------------------- LayerNorm


def _ln_stats_fake(x):
    return x.new_empty(x.shape[:-1], dtype=torch.float32)


_register(
    "layer_norm_fwd",
    lambda x, scale, bias, eps: _ln.layer_norm_reference(x, scale, bias, eps),
    _ln.layer_norm_fwd_cuda,
    lambda x, scale, bias, eps: (torch.empty_like(x, memory_format=torch.contiguous_format),
                                 _ln_stats_fake(x), _ln_stats_fake(x)),
)


def _ln_bwd_cpu(x, dy, scale, mean, rstd, dgamma_dbeta):
    dx, dg, db = _ln.layer_norm_bwd_reference(x, dy, scale, mean, rstd, dgamma_dbeta)
    if not dgamma_dbeta:
        dg, db = _ln._no_dgamma(x)
    return dx, dg, db


def _ln_bwd_fake(x, dy, scale, mean, rstd, dgamma_dbeta):
    n = x.shape[-1] if dgamma_dbeta else 0
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((n,), dtype=torch.float32), x.new_empty((n,), dtype=torch.float32))


_register("layer_norm_bwd", _ln_bwd_cpu, _ln.layer_norm_bwd_cuda, _ln_bwd_fake)


def _ln_setup(ctx, inputs, output):
    x, scale, _bias, _eps = inputs
    _y, mean, rstd = output
    ctx.save_for_backward(x, scale, mean, rstd)


def _ln_backward(ctx, dy, _dmean, _drstd):
    x, scale, mean, rstd = ctx.saved_tensors
    dx, dg, db = torch.ops.openasr.layer_norm_bwd(x, dy.to(x.dtype), scale, mean, rstd, True)
    return dx, dg, db, None


torch.library.register_autograd(f"{NAMESPACE}::layer_norm_fwd", _ln_backward,
                                setup_context=_ln_setup, lib=_LIB)


# ---------------------------------------------------------- flash attention


def _flash_impl(fn):
    """An implementation taking the operator's trailing ints (chunk, left,
    phase) as the wrappers' `chunk_mask`."""
    def impl(*args):
        *head, chunk, left, phase = args
        return fn(*head, _flash.chunk_mask_of(chunk, left, phase))
    return impl


def _lse_fake(q):
    b, tq, h, _ = q.shape
    return q.new_empty((b, h, tq), dtype=torch.float32)


_register(
    "flash_fwd",
    _flash_impl(_flash.flash_attention_reference),
    _flash_impl(_flash.flash_fwd_cuda),
    lambda q, k, v, *rest: (q.new_empty(q.shape), _lse_fake(q)),
)
_register(
    "flash_bwd_stats",
    _flash_impl(_flash.flash_bwd_stats_reference),
    _flash_impl(_flash.flash_bwd_stats_cuda),
    lambda q, *rest: q.new_empty((3,) + _lse_fake(q).shape, dtype=torch.float32),
)


def _plain_bwd(q, k, v, out, lse, dout, _stats, *rest):
    """The plain backward (which forms its own statistics)."""
    return _flash.flash_attention_bwd_reference(q, k, v, out, lse, dout, *rest)


_register(
    "flash_bwd_dkv",
    _flash_impl(lambda *a: _plain_bwd(*a)[1:]),
    _flash_impl(_flash.flash_bwd_dkv_cuda),
    lambda q, k, v, *rest: (k.new_empty(k.shape), v.new_empty(v.shape)),
)
_register(
    "flash_bwd_dq",
    _flash_impl(lambda *a: _plain_bwd(*a)[0]),
    _flash_impl(_flash.flash_bwd_dq_cuda),
    lambda q, *rest: q.new_empty(q.shape),
)


def _flash_setup(ctx, inputs, output):
    q, k, v, kv_lengths, *args = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, kv_lengths)
    ctx.args = args


def _flash_backward(ctx, dout, _dlse):
    q, k, v, out, lse, kv_lengths = ctx.saved_tensors
    causal, sm_scale, rate, seed, chunk, left, phase = ctx.args
    dq, dk, dv = _flash.flash_attention_bwd(
        q, k, v, out, lse, dout.to(q.dtype), kv_lengths, causal, sm_scale, rate, seed,
        _flash.chunk_mask_of(chunk, left, phase))
    return (dq, dk, dv) + (None,) * 8


torch.library.register_autograd(f"{NAMESPACE}::flash_fwd", _flash_backward,
                                setup_context=_flash_setup, lib=_LIB)


# -------------------------------------------------------------------- fbank


def _fbank_cpu(frames, feat_lengths, _window, _tw, _tw_lo, _idx, _w, _order, _cs,
               mc, ms, mel_t, _nfft, _n_mel, _pre, _dc, use_log):
    return _fbank.fbank_plain(frames, feat_lengths, mc, ms, mel_t, use_log)


def _fbank_cuda(frames, feat_lengths, window, tw, tw_lo, idx, w, order, cs,
                _mc, _ms, _mel_t, nfft, n_mel, pre, dc, use_log):
    return _fbank.fbank_cuda(frames, feat_lengths, window, tw, tw_lo, idx, w, order, cs,
                             nfft, n_mel, pre, dc, use_log)


def _fbank_fake(frames, feat_lengths, window, tw, tw_lo, idx, w, order, cs,
                mc, ms, mel_t, nfft, n_mel, pre, dc, use_log):
    return frames.new_empty((frames.shape[0], frames.shape[1], n_mel), dtype=torch.float32)


_register("fbank", _fbank_cpu, _fbank_cuda, _fbank_fake)
