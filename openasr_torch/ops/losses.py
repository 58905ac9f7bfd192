"""Sequence losses: CTC with blank = V-1 and label-smoothed CE.

Counterparts of `cal_ctc_loss` (openasr_tpu/ops/ctc.py:274) and
`cal_ce_loss` (openasr_tpu/ops/losses.py:40).  Both return sums over the
batch, in f32 whatever the logits' dtype; the solvers normalize them (CE
by tokens, CTC by sequences).

The JAX package's CTC is its own XLA forward-backward; here it is
`F.ctc_loss` on f32 log-probs with `zero_infinity`, plus the package's two
rules: rows with target_length <= 0 and losses >= 1e29 count as 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cal_ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
                 targets: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """Summed CTC loss, blank = V-1.  logits [B, T, V]; logit_lengths [B];
    targets [B, U] (padding past target_lengths is ignored);
    target_lengths [B]."""
    v = logits.shape[-1]
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)   # [T, B, V]
    tlen = target_lengths.to(torch.int64)
    losses = F.ctc_loss(
        log_probs, targets.to(torch.int64), logit_lengths.to(torch.int64).clamp(min=0),
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
