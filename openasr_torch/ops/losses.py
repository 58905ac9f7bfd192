"""Sequence losses: CTC with blank = V-1, label-smoothed CE, and CIF's
quantity and square losses.

Counterparts of `cal_ctc_loss` (openasr_tpu/ops/ctc.py:274), `cal_ce_loss`
(openasr_tpu/ops/losses.py:40), `cal_qua_loss` and `cal_ce_square_loss`
(openasr_tpu/ops/losses.py:64-76).  Each returns a sum over the batch, in
f32 whatever the logits' dtype (the CTC loss of float64 logits, a float64
reference model's, in float64); the solvers normalize them (CE by tokens,
CTC and quantity by sequences).

The JAX package's CTC is its own XLA forward-backward; here it is
`F.ctc_loss` on f32 log-probs with `zero_infinity`, plus the package's two
rules: rows with target_length <= 0 and losses >= 1e29 count as 0.  A
target may equal the blank id V-1 where the vocabulary has no blank of
its own (`add_blk: false`, as in the CIF configs); `F.ctc_loss` then
keeps only one of the two end states' shares of the last frame's blank
gradient, and `_LastBlankFrame` restores it (see there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openasr_torch.parallel.mesh import DataGroup, all_reduce_with_grad


class _LastBlankFrame(torch.autograd.Function):
    """The identity on log-probs [T, B, V]; its backward rewrites the blank
    entry of the gradient at frame `frames[b]` of the rows b where
    `ends_in_blank` (a row's last valid frame, where its last target is
    the blank id) as minus the sum of the row's other entries.
    F.ctc_loss's gradient is exp(lp) - gamma, with gamma the frame's class
    occupancy, so each frame's entries sum to 0; on such a row both end
    states emit the blank id and gamma is all on it, but F.ctc_loss keeps
    only one end state's share there.  The other entries are right (gamma
    is 0 on them), so the sum restores the blank's exactly.  Only the B
    last frames are read and B entries written, in place: F.ctc_loss's
    backward hands over a fresh buffer that nothing else holds."""

    @staticmethod
    def forward(ctx, log_probs, frames, ends_in_blank, blank):
        ctx.save_for_backward(frames, ends_in_blank)
        ctx.blank = blank
        return log_probs.view_as(log_probs)

    @staticmethod
    def backward(ctx, grad):
        frames, ends_in_blank = ctx.saved_tensors
        rows = torch.arange(grad.shape[1], device=grad.device)
        last = grad[frames, rows]                                          # [B, V]
        col = last[:, ctx.blank]
        grad[frames, rows, ctx.blank] = torch.where(ends_in_blank, col - last.sum(dim=-1), col)
        return grad, None, None, None


def cal_ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
                 targets: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """Summed CTC loss, blank = V-1.  logits [B, T, V]; logit_lengths [B];
    targets [B, U] (padding past target_lengths is ignored);
    target_lengths [B].  f32 for f32 and bf16 logits: its log-space
    recursion then rounds the logits' gradient to some 1e-2 of float64 at
    a thousand frames and 1e4 nats a sequence, as the JAX package's f32
    CTC does (ROADMAP queue 3 item 39); float64 logits keep float64."""
    v = logits.shape[-1]
    log_probs = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                              dim=-1).transpose(0, 1)                   # [T, B, V]
    tlen = target_lengths.to(torch.int64)
    llen = logit_lengths.to(torch.int64).clamp(min=0)
    if log_probs.requires_grad:
        targets64 = targets.to(torch.int64)
        last = targets64.gather(1, (tlen - 1).clamp(min=0)[:, None])[:, 0]
        ends_in_blank = (tlen > 0) & (last == v - 1) & (llen > 0)
        frames = (llen - 1).clamp(min=0, max=log_probs.shape[0] - 1)
        log_probs = _LastBlankFrame.apply(log_probs, frames, ends_in_blank, v - 1)
    losses = F.ctc_loss(
        log_probs, targets.to(torch.int64), llen,
        tlen.clamp(min=0), blank=v - 1, reduction="none", zero_infinity=True,
    )
    zero = torch.zeros((), dtype=losses.dtype, device=losses.device)
    losses = torch.where(tlen.to(losses.device) > 0, losses, zero)
    losses = torch.where(losses < 1.0e29, losses, zero)
    return losses.sum()


def cal_ce_loss(logits: torch.Tensor, labels: torch.Tensor, paddings: torch.Tensor,
                label_smooth: float = 0.0) -> torch.Tensor:
    """Summed CE over unpadded tokens (paddings 1.0 = padded), mixed with the
    mean negative log-prob over the vocabulary by `label_smooth`:
    -mean_v log_softmax(x)_v = logsumexp(x) - mean_v(x)."""
    x32 = logits.float()
    keep = 1.0 - paddings.float()
    lse = torch.logsumexp(x32, dim=-1)
    label_logit = x32.gather(-1, labels.long()[..., None])[..., 0]
    loss = ((lse - label_logit) * keep).sum()
    if label_smooth > 0.0:
        smooth = ((lse - x32.mean(dim=-1)) * keep).sum()
        loss = loss * (1.0 - label_smooth) + smooth * label_smooth
    return loss


def cal_qua_loss(num_hat: torch.Tensor, num: torch.Tensor,
                 group: DataGroup = DataGroup.single()) -> torch.Tensor:
    """CIF's quantity loss sqrt(sum((n_hat - n)^2)) over the batch.  The
    root of a sum over the batch is not a sum of the ranks' values, so it is
    this rank's share sqrt(S) * S_r / S of the global batch's, S the sum of
    the data `group`'s S_r (all-reduced with its gradient): the shares add
    up, value and gradient, to the one-process loss."""
    sq = ((num_hat.float() - num.float()) ** 2).sum()
    total = all_reduce_with_grad(group, sq)
    return torch.sqrt(total) * sq / total.clamp(min=1e-30)


def cal_ce_square_loss(prob_square: torch.Tensor,
                       target_square: torch.Tensor) -> torch.Tensor:
    """L1 distance between two [B, T, T] squares."""
    return (prob_square - target_square).abs().sum()
