"""Continuous Integrate-and-Fire (CIF).

Counterpart of openasr_tpu/ops/cif.py: the train-time quantity scaling
(`scale_alphas`), the per-frame recurrence (`cif_scan`, a Python loop,
kept as the oracle of the tests) and its closed form (`cif_parallel`,
which `cif` runs), and the decode length `cif_output_lengths`.

The closed form: with S_t = cumsum(alpha) and c_t = max(0, ceil(S_t -
threshold)), the fire count is F_t = t + min(1, cummin_j(c_j - j)), so
each frame gives its weight to at most two output slots, F_{t-1} and
F_{t-1} + 1.  The output is a one-hot weight tensor [B, T, capacity + 1]
times the hidden frames [B, T, D], a batched product with no kernel of
its own (the JAX package's is an einsum at Precision.HIGHEST, outside any
Pallas kernel).  It runs in IEEE f32 on every device: autocast off and,
on the card, TF32 off for the forward's and the backward's products
(`_OneHotProduct`), so bf16 training does not round the CIF frames.

The fires are discontinuous in S_t: a frame whose S_t lies within
rounding of n + threshold may fire on one device and not on another
(`fire_margin` reports the smallest distance over a batch).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def scale_alphas(
    alphas: torch.Tensor,
    target_lengths: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-time quantity scaling: alphas * (N + 0.9 u - 0.45) / sum(alphas),
    u ~ U(0, 1) a row, given as `noise` [B] or drawn from `generator` (on
    its own device); without either, N / sum(alphas).  Returns (scaled
    alphas, raw sum [B])."""
    raw_num = alphas.sum(dim=-1)
    num = target_lengths.float()
    if noise is None and generator is not None:
        noise = torch.rand(num.shape, generator=generator, device=generator.device)
    if noise is not None:
        num = num + 0.9 * noise.to(num.device, torch.float32) - 0.45
    scale = num / torch.clamp(raw_num, min=1e-9)
    return alphas * scale[:, None], raw_num


def cif_scan(hidden: torch.Tensor, alphas: torch.Tensor, capacity: int,
             threshold: float = 0.95) -> torch.Tensor:
    """Integrate-and-fire frame by frame.  hidden [B, T, D], alphas [B, T]
    -> fired frames [B, capacity, D] f32, zero-padded; fires past the
    capacity are dropped."""
    b, t, d = hidden.shape
    hidden, alphas = hidden.float(), alphas.float()
    integrate = hidden.new_zeros(b)
    frame = hidden.new_zeros(b, d)
    fires, frames = [], []
    for i in range(t):
        alpha_t, hidden_t = alphas[:, i], hidden[:, i]
        completion = 1.0 - integrate
        integrate = integrate + alpha_t
        fire = integrate > threshold
        cur = torch.where(fire, completion, alpha_t)
        emitted = frame + cur[:, None] * hidden_t
        frame = torch.where(fire[:, None], (alpha_t - cur)[:, None] * hidden_t, emitted)
        integrate = torch.where(fire, integrate - 1.0, integrate)
        fires.append(fire)
        frames.append(emitted)
    fires = torch.stack(fires, dim=1)                  # [B, T]
    frames = torch.stack(frames, dim=1)                # [B, T, D]
    pos = torch.cumsum(fires.to(torch.int64), dim=1) - 1
    keep = fires & (pos < capacity)
    bi = torch.arange(b, device=hidden.device)[:, None].expand(b, t)
    out = hidden.new_zeros(b, capacity, d)
    return out.index_put((bi[keep], pos[keep]), frames[keep])


@contextmanager
def _ieee_f32():
    """Autocast off and, on the card, no TF32 in f32 products."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


class _OneHotProduct(torch.autograd.Function):
    """out[b, k] = sum_t w[b, t, k] hidden[b, t] in IEEE f32, forward and
    backward."""

    @staticmethod
    def forward(ctx, w, hidden):
        ctx.save_for_backward(w, hidden)
        with _ieee_f32(), torch.autocast(hidden.device.type, enabled=False):
            return torch.bmm(w.transpose(1, 2), hidden)

    @staticmethod
    def backward(ctx, grad_out):
        w, hidden = ctx.saved_tensors
        grad_out = grad_out.float()
        with _ieee_f32(), torch.autocast(hidden.device.type, enabled=False):
            grad_w = torch.bmm(hidden, grad_out.transpose(1, 2)) if ctx.needs_input_grad[0] else None
            grad_h = torch.bmm(w, grad_out) if ctx.needs_input_grad[1] else None
        return grad_w, grad_h


def fire_counts(alphas: torch.Tensor, threshold: float = 0.95):
    """(S_t, F_t): the running sum of alphas and the closed form's fire
    count after each frame, [B, T] f32 (F_t exact integers)."""
    t = alphas.shape[1]
    s = torch.cumsum(alphas.float(), dim=1)
    c = torch.clamp(torch.ceil(s - threshold), min=0.0)
    j = torch.arange(t, dtype=torch.float32, device=alphas.device)
    m = torch.cummin(c - j[None, :], dim=1).values
    return s, j[None, :] + torch.clamp(m, max=1.0)


def fire_margin(alphas: torch.Tensor, lengths: torch.Tensor,
                threshold: float = 0.95) -> float:
    """The smallest |S_t - threshold - n| over the valid frames of a batch,
    n the nearest integer: how far the batch's running sums lie from a
    rounding that would move a fire (read back to the host)."""
    s, _ = fire_counts(alphas, threshold)
    x = s - threshold
    dist = (x - torch.round(x)).abs()
    valid = torch.arange(s.shape[1], device=s.device)[None, :] < lengths.to(s.device)[:, None]
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    return float(dist.min())


def cif_parallel(hidden: torch.Tensor, alphas: torch.Tensor, capacity: int,
                 threshold: float = 0.95) -> torch.Tensor:
    """Closed-form integrate-and-fire (see the module docstring):
    hidden [B, T, D], alphas [B, T] -> fired frames [B, capacity, D] f32.
    The semantics of `cif_scan` up to f32 summation order."""
    with torch.autocast(hidden.device.type, enabled=False):
        hidden, alphas = hidden.float(), alphas.float()
        s, fires_cum = fire_counts(alphas, threshold)
        f_prev = F.pad(fires_cum[:, :-1], (1, 0))              # F_{t-1}, F_-1 = 0
        fire = fires_cum > f_prev + 0.5
        completion = 1.0 - ((s - alphas) - f_prev)             # 1 - integrate_{t-1}
        zero = torch.zeros((), dtype=torch.float32, device=alphas.device)
        w_low = torch.where(fire, completion, alphas)          # -> slot F_{t-1}
        w_high = torch.where(fire, alphas - completion, zero)  # -> slot F_{t-1} + 1
        # a slot is emitted iff it fired and fits the capacity; the
        # trailing partial frame and the overflow go to a dump slot
        limit = torch.clamp(fires_cum[:, -1:], max=float(capacity))
        dump = torch.full((), float(capacity), device=alphas.device)
        k_low = torch.where(f_prev < limit, f_prev, dump).to(torch.int64)
        k_high = torch.where(f_prev + 1.0 < limit, f_prev + 1.0, dump).to(torch.int64)
        w = (F.one_hot(k_low, capacity + 1).float() * w_low[..., None]
             + F.one_hot(k_high, capacity + 1).float() * w_high[..., None])
        return _OneHotProduct.apply(w, hidden)[:, :capacity]


def cif(hidden: torch.Tensor, alphas: torch.Tensor, capacity: int,
        threshold: float = 0.95) -> torch.Tensor:
    """Integrate-and-fire, the closed form: hidden [B, T, D], alphas [B, T]
    -> fired frames [B, capacity, D] f32, zero-padded."""
    return cif_parallel(hidden, alphas, capacity, threshold)


def cif_output_lengths(alphas: torch.Tensor) -> torch.Tensor:
    """Decode length round(sum(alphas)) (half to even), int32."""
    return torch.round(alphas.sum(dim=-1)).to(torch.int32)
