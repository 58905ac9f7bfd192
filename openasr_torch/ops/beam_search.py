"""Batched attention beam search with KV-cached decoder steps.

Counterpart of openasr_tpu/ops/beam_search.py (`batch_beam_search`,
`beam_expand`) with LM shallow fusion and Aho-Corasick hotword biasing.
The JAX `lax.while_loop` becomes a Python loop that keeps its
all-finished early exit (one device->host read of the finished flags a
step); `stop_when_finished=False` runs all `max_decode_len` steps with no
host read, for a traced program (serving.py).  The result is the same:
a finished beam is frozen on EOS with log-prob 0, so a step after every
beam finished keeps each beam's tokens and score, and its top-k only
sorts the beams by score, stably, as the final sort does.  Kept as in
the JAX package:

  * initial scores [0, -inf, ...] per batch, so identical initial beams
    don't duplicate;
  * finished beams are forced to emit EOS with log-prob 0 (score freeze);
  * a flat per-batch top-k over beam*beam candidates;
  * shallow fusion: with an LM step and lm_weight != 0, every step's
    scores are log p_am + lm_weight * log p_lm (the LM fed the same
    tokens, from <sos>), and the LM cache is reordered with the beams;
  * every cache tensor is reordered by the source beam;
  * lengths are the position of the first EOS;
  * a final per-batch sort by score;
  * biasing runs the device CTC beam's automaton (ops/ctc_beam_device.py):
    each beam carries a match state per phrase, reordered with the beams;
    every token's score gains context_weight times its boost delta, and
    EOS (forced EOS on finished beams too) neither earns nor rolls back
    boost and leaves the automaton as it was.

With `use_eos=False` (the CIF decode) every beam runs all
`max_decode_len` steps: no EOS finishing, no score freeze, no early exit,
and the biasing automaton advances on every emitted token, EOS included;
lengths come back as `max_decode_len` and the caller cuts each utterance
to its own length.

Every top-k here is a stable descending sort, so ties resolve to the lower
index first, as `lax.top_k` does.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from openasr_torch.data.tokenizer import EOS_ID, SOS_ID
from openasr_torch.ops.ctc_beam_device import (
    context_advance,
    context_boost,
    context_tensors,
)
from openasr_torch.ops.masks import NEG_INF


def beam_expand(x: torch.Tensor, beam_size: int) -> torch.Tensor:
    """[B, ...] -> [B*beam, ...] repeating each row `beam` times."""
    return x.repeat_interleave(beam_size, dim=0)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _reorder(tree, idx: torch.Tensor):
    """Gather rows `idx` of every tensor in a nest of lists and dicts."""
    if isinstance(tree, dict):
        return {k: _reorder(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reorder(v, idx) for v in tree)
    return tree[idx]


def batch_beam_search(
    step_fn: Callable,
    init_cache,
    batch_size: int,
    beam_size: int,
    max_decode_len: int,
    vocab_size: int,
    device=None,
    context_tables=None,
    context_weight: float = 0.0,
    use_eos: bool = True,
    lm_step_fn: Optional[Callable] = None,
    init_lm_cache=None,
    lm_weight: float = 0.0,
    stop_when_finished: bool = True,
):
    """Run beam search, optionally with LM fusion and hotword biasing.

    Args:
      step_fn: (tokens [BB], index, cache) -> (logits [BB, V], cache);
        BB = batch*beam.  Must already close over beam-expanded memory.
      init_cache: nest of tensors with leading dim BB.
      lm_step_fn: (tokens [BB], lm_cache) -> (log-probs [BB, V], lm_cache),
        with `init_lm_cache` (leading dim BB) and `lm_weight` (off when
        None or 0; models/lm.py:make_lm_fusion builds them).
      context_tables, context_weight: hotword biasing, the tables of
        ops.ctc_beam_device.build_context_tables (off when either is
        None or 0).
      use_eos: EOS finishes a beam (False: every beam runs every step).
      stop_when_finished: with `use_eos`, stop once every beam has
        finished (a host read a step); False runs every step, with the
        same result.

    Returns:
      preds [B, beam, max_decode_len] (EOS-padded, no SOS),
      lengths [B, beam] token counts before EOS,
      scores [B, beam] sorted descending.
    """
    bb = batch_size * beam_size
    tokens = torch.full((bb,), SOS_ID, dtype=torch.long, device=device)
    preds = torch.full((bb, max_decode_len), EOS_ID, dtype=torch.long, device=device)
    first = torch.full((beam_size,), NEG_INF, dtype=torch.float32, device=device)
    first[0] = 0.0
    scores = first.repeat(batch_size)
    finished = torch.zeros((bb,), dtype=torch.bool, device=device)
    base = (
        torch.arange(batch_size, device=device)[:, None] * beam_size * beam_size
    )
    eos_row = torch.full((1, vocab_size), NEG_INF, dtype=torch.float32, device=device)
    eos_row[0, EOS_ID] = 0.0
    ctx = None
    if context_tables is not None and context_weight != 0.0:
        ctx = context_tensors(context_tables, device)
        cmatch = torch.zeros((bb, ctx["plen"].shape[0]), dtype=torch.long, device=device)

    use_lm = lm_step_fn is not None and lm_weight != 0.0
    cache, lm_cache = init_cache, init_lm_cache
    for step in range(max_decode_len):
        if use_eos and stop_when_finished and bool(finished.all()):
            break
        logits, cache = step_fn(tokens, step, cache)
        z = torch.log_softmax(logits.float(), dim=-1)
        if use_lm:
            lm_logp, lm_cache = lm_step_fn(tokens, lm_cache)
            z = z + lm_weight * lm_logp.float()
        if use_eos:
            # finished beams: force EOS with log-prob 0 (score freeze)
            z = torch.where(finished[:, None], eos_row, z)
        if ctx is not None:
            bias = context_weight * context_boost(ctx, cmatch)  # [BB, V]
            bias[:, EOS_ID] = 0.0
            z = z + bias

        next_scores, next_tokens = _top_k(z, beam_size)  # [BB, beam]
        comb = (scores[:, None] + next_scores).reshape(
            batch_size, beam_size * beam_size
        )
        top_scores, k_idx = _top_k(comb, beam_size)  # [B, beam]
        flat_k = (base + k_idx).reshape(-1)
        beam_src = flat_k // beam_size

        tokens = next_tokens.reshape(-1)[flat_k]
        preds = preds[beam_src]
        preds[:, step] = tokens
        scores = top_scores.reshape(-1)
        if use_eos:
            finished = finished[beam_src] | (tokens == EOS_ID)
        cache = _reorder(cache, beam_src)
        if use_lm:
            lm_cache = _reorder(lm_cache, beam_src)
        if ctx is not None:
            pmatch = cmatch[beam_src]
            advanced = context_advance(ctx, pmatch, tokens)
            cmatch = (torch.where((tokens == EOS_ID)[:, None], pmatch, advanced)
                      if use_eos else advanced)

    if use_eos:
        is_eos = (preds == EOS_ID).to(torch.int32)
        lengths = torch.where(
            is_eos.any(dim=1),
            is_eos.argmax(dim=1),
            torch.full((bb,), max_decode_len, device=device),
        )
    else:
        lengths = torch.full((bb,), max_decode_len, device=device)

    sorted_scores, order = _top_k(scores.reshape(batch_size, beam_size), beam_size)
    gather = (
        torch.arange(batch_size, device=device)[:, None] * beam_size + order
    ).reshape(-1)
    return (
        preds[gather].reshape(batch_size, beam_size, max_decode_len),
        lengths[gather].reshape(batch_size, beam_size),
        sorted_scores,
    )
