"""CTC greedy decoding: the frame-wise argmax path and its collapse.

Counterpart of openasr_tpu/ops/ctc_decode.py.  The collapse (drop repeats,
then blanks) is a cumsum of the surviving frames' mask and one scatter,
so a whole batch is a few tensor ops and the result stays on the device.
`ctc_shrink_soft` gathers the surviving frames' logits instead of their
ids, with gradients to the gathered frames, for the GAN generator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from openasr_torch.ops.masks import sequence_mask


def greedy_path(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Frame-wise argmax [B, T] (ties to the lowest id), padding frames
    forced to blank (V-1)."""
    v = logits.shape[-1]
    ids = logits.argmax(dim=-1)
    return torch.where(sequence_mask(lengths, ids.shape[1]), ids, v - 1)


def ctc_collapse_mask(path: torch.Tensor, lengths: torch.Tensor,
                      blank_id: int) -> torch.Tensor:
    """True at frames that survive the collapse: the first of each run,
    not blank, within the valid region."""
    prev = F.pad(path, (1, 0), value=-1)[:, :-1]
    valid = sequence_mask(lengths, path.shape[1])
    return (path != prev) & (path != blank_id) & valid


def _compact(keep: torch.Tensor, values: torch.Tensor, fill):
    """Rows of `values` [B, T, ...] where `keep` [B, T], packed to the
    left of [B, T, ...] filled with `fill`; and the kept counts [B]."""
    b, t = keep.shape
    pos = torch.where(keep, keep.long().cumsum(dim=1) - 1, t)  # dropped: slot t
    out = values.new_full((b, t + 1) + values.shape[2:], fill)
    rows = torch.arange(b, device=keep.device)[:, None].expand(b, t)
    out = out.index_put((rows, pos), values)
    return out[:, :t], keep.sum(dim=1)


def ctc_shrink_ids(path: torch.Tensor, lengths: torch.Tensor, blank_id: int,
                   pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse repeats and remove blanks, compacted left:
    path [B, T] -> (ids [B, T] padded with pad_id, lengths [B])."""
    return _compact(ctc_collapse_mask(path, lengths, blank_id), path, pad_id)


def ctc_greedy_decode(logits: torch.Tensor, lengths: torch.Tensor,
                      blank_id: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax path -> collapsed token ids [B, T] and their counts [B]."""
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    return ctc_shrink_ids(greedy_path(logits, lengths), lengths, blank_id)


def ctc_shrink_soft(logits: torch.Tensor, lengths: torch.Tensor,
                    blank_id: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LOGITS [B, T, V] of the frames the greedy collapse keeps,
    compacted left and zero-padded, and their counts.  Gradients flow to
    the gathered frames; the selection is a hard choice."""
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    keep = ctc_collapse_mask(greedy_path(logits, lengths), lengths, blank_id)
    return _compact(keep, logits, 0.0)
