"""CTC prefix beam search on the device, batched, with static shapes.

Counterpart of `ctc_prefix_beam_device` in openasr_tpu/ops/ctc_beam_device.py
(the one-shot search, with LM shallow fusion and Aho-Corasick hotword
biasing) and of its streaming variant, `ctc_beam_stream_init` and
`ctc_beam_stream_step`, which carry the same state across chunks.  The JAX
package vmaps one utterance's `lax.scan`; here every tensor carries a
leading batch dimension and the scan is a Python loop over the frames
whose body reads nothing back to the host (no `.item()`, no shape that
depends on the data), so it could be captured in a CUDA graph.

The recursion (Hannun et al. 2014) as dense tensor algebra, as in JAX:

  * A prefix is identified by a pair of 32-bit rolling hashes,
    h' = h * M + c + 1 mod 2^32 with two odd multipliers; its tokens are
    stored beside it.  Each frame builds N "stay" candidates and N x V
    extensions, folds an extension whose hash pair equals a live beam's
    into that beam's non-blank mass, and keeps the best N of the
    N + N x V totals.
  * PyTorch has no uint32 multiply on CUDA, so the hashes are int64
    tensors holding uint32 values.  The multiplier is split into 16-bit
    halves, which keeps every product below 2^49 (no signed overflow),
    and each step masks to 32 bits: the pairs equal JAX's bit for bit.
  * NEG_INF is -1e30, not -inf, as `_logaddexp`'s guard and the CLI's
    sentinel filter (scores > -1e29) expect.
  * `jax.lax.top_k` breaks ties to the lowest index; `torch.topk` promises
    no order for ties.  Both the frame cutoff (top-n symbols) and the
    pruning use a stable descending sort, and the final n-best order a
    stable argsort, as `jnp.argsort` is.

Shallow fusion, as in JAX: p_lm(. | <sos>) seeds every beam; a new token
c pays lm_weight * log p_lm(c | prefix) once, when it extends a prefix
(over the first min(V, V_lm) tokens; the others get lm_weight * NEG_INF);
every frame the LM steps once from each new beam's parent state with its
appended token, and a stay keeps its parent's state and log-probs.  The
LM state is gathered by parent every frame (one copy of the cache).  The
Transformer LM's step writes its K/V into that copy in place, at the
row's own position, so a stay needs no select of its K/V: it keeps the
parent's position, and the slot written past it is never read before the
row's next token overwrites it.  Frames past an utterance's length take
each beam as its own parent and stay.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

NEG_INF = -1e30
HASH_MULT1 = 1000003
HASH_MULT2 = 2654435761
_MASK32 = 0xFFFFFFFF
_SENTINEL = 0x80000000


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(torch.minimum(a, b) <= NEG_INF / 2, m, out)


def hash_step(h: torch.Tensor, mult: int, c: torch.Tensor) -> torch.Tensor:
    """(h * mult + c + 1) mod 2^32 of int64 tensors holding uint32 values;
    `mult` < 2^32 is split into 16-bit halves so no product passes 2^49."""
    lo, hi = mult & 0xFFFF, mult >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16) + c + 1) & _MASK32


def init_hashes(beam: int, device=None):
    """The initial hash pair: beam 0 is the live empty prefix, hash 0; the
    dead sentinel slots get 0x80000000 + i, so they never merge with
    anything (their mass is NEG_INF anyway)."""
    sent = _SENTINEL + torch.arange(beam, dtype=torch.int64, device=device)
    sent[0] = 0
    return sent, sent.clone()


# ------------------------------------------------------ contextual biasing

def build_context_tables(phrases, vocab_size: int) -> dict:
    """The Aho-Corasick / KMP automaton of the hotword phrases, NumPy in
    and out (built once on the host).

    phrases: [P, L] int32 token ids, -1 padding (`load_context_phrases`'
    layout).  Returns:

      j_of  [V, P]     first index j with phrases[p, j] == token (L if the
                       token is not in the phrase: column L of `trans` is
                       0 from every state);
      trans [P, L+1, L+1]  trans[p, m, j]: the match length after token
                       phrases[p, j] in state m, following failure links
                       (== plen[p]: a completed match);
      plen  [P]        phrase lengths;
      fail  [P]        fail[plen]: the matched prefix carried over after a
                       completion (self-overlapping phrases keep it).

    A prefix's boost is context_weight * (completions * plen + current
    match), a function of the prefix alone, so merging beams stays
    consistent.
    """
    phrases = np.asarray(phrases, np.int32)
    n_phrases, max_len = phrases.shape
    plen = (phrases >= 0).sum(axis=1).astype(np.int32)
    trans = np.zeros((n_phrases, max_len + 1, max_len + 1), np.int32)
    fail_full = np.zeros((n_phrases,), np.int32)
    j_of = np.full((vocab_size, n_phrases), max_len, np.int32)
    for p in range(n_phrases):
        ph = [int(c) for c in phrases[p, : plen[p]]]
        n = len(ph)
        # the KMP failure function of ph, with fail[n]
        fail = np.zeros(n + 1, np.int32)
        k = 0
        for m in range(1, n):
            while k > 0 and ph[m] != ph[k]:
                k = fail[k]
            if ph[m] == ph[k]:
                k += 1
            fail[m + 1] = k
        fail_full[p] = fail[n]
        for j, c in enumerate(ph):
            if 0 <= c < vocab_size and j_of[c, p] == max_len:
                j_of[c, p] = j
        # delta(m, c) for every state and every in-phrase token
        for m in range(n):
            for j, c in enumerate(ph):
                k = m
                while k > 0 and ph[k] != c:
                    k = fail[k]
                trans[p, m, j] = k + 1 if ph[k] == c else 0
    return {"j_of": j_of, "trans": trans, "plen": plen, "fail": fail_full}


def context_tensors(tables: dict, device) -> Dict[str, torch.Tensor]:
    """`build_context_tables`' arrays as int64 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(tables[k]), dtype=torch.int64, device=device)
            for k in ("j_of", "trans", "plen", "fail")}


def _ctx_transition(m, raw, plen, fail):
    """(new state, boost delta) of a raw KMP next state `raw` in state `m`;
    plen and fail broadcast to raw's phrase axis.  A completed match keeps
    its plen boost and carries fail[plen] over as the new partial."""
    complete = raw == plen
    new_m = torch.where(complete, fail, raw)
    delta = torch.where(complete, plen - m + fail, raw - m).to(torch.float32)
    return new_m, delta


def context_boost(ctx: Dict[str, torch.Tensor], cmatch: torch.Tensor) -> torch.Tensor:
    """The boost delta [..., V] (summed over phrases) of every next token
    from match states cmatch [..., P]."""
    trans, j_of = ctx["trans"], ctx["j_of"]
    n_phrases, lp1, _ = trans.shape
    lead = cmatch.shape[:-1]
    phrase = torch.arange(n_phrases, device=cmatch.device)
    trans_m = trans[phrase, cmatch.clamp(0, lp1 - 1)]              # [..., P, L+1]
    raw = trans_m.gather(-1, j_of.T.expand(*lead, *j_of.T.shape))  # [..., P, V]
    _, delta = _ctx_transition(cmatch[..., None], raw, ctx["plen"][:, None],
                               ctx["fail"][:, None])
    return delta.sum(dim=-2)


def context_advance(ctx: Dict[str, torch.Tensor], cmatch: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Match states [..., P] after `tokens` [...] from `cmatch` [..., P]."""
    trans, j_of = ctx["trans"], ctx["j_of"]
    n_phrases, lp1, _ = trans.shape
    phrase = torch.arange(n_phrases, device=cmatch.device)
    raw = trans[phrase, cmatch.clamp(0, lp1 - 1), j_of[tokens.clamp(min=0)]]
    new_m, _ = _ctx_transition(cmatch, raw, ctx["plen"], ctx["fail"])
    return new_m


# ------------------------------------------------------------ the search

def _frame_candidates(log_probs: torch.Tensor, blank: int, cutoff_top_n: int,
                      cutoff_logp: float) -> torch.Tensor:
    """[B, T, V] bool: exactly the top-n symbols of each frame (ties to the
    lowest index) at or above the log-prob floor, and blank always."""
    v = log_probs.shape[-1]
    top_n = min(cutoff_top_n, v)
    vals, idx = torch.sort(log_probs, dim=-1, descending=True, stable=True)
    cand = torch.zeros_like(log_probs, dtype=torch.bool)
    cand.scatter_(-1, idx[..., :top_n], vals[..., :top_n] >= cutoff_logp)
    cand[..., blank] = True
    return cand


def _rows_where(keep: torch.Tensor, old, new):
    """Per row, `old` where `keep` [R] else `new`, leaf by leaf over a nest
    of lists, tuples and dicts with leading dim R.  A leaf that is the same
    tensor in both (a cache the step wrote in place) is kept as it is."""
    if isinstance(old, dict):
        return {k: _rows_where(keep, old[k], new[k]) for k in old}
    if isinstance(old, (list, tuple)):
        return type(old)(_rows_where(keep, o, n) for o, n in zip(old, new))
    if old is new:
        return old
    return torch.where(keep.view((-1,) + (1,) * (old.dim() - 1)), old, new)


def _gather_rows(tree, idx: torch.Tensor):
    if isinstance(tree, dict):
        return {k: _gather_rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather_rows(v, idx) for v in tree)
    return tree[idx]


def _lm_advance(state: dict, parent: torch.Tensor, is_stay: torch.Tensor,
                ext_c: torch.Tensor, valid: torch.Tensor, lm_step_fn) -> dict:
    """The LM state after the frame: each new beam's parent state (its own
    where the frame is past the utterance), stepped with the appended
    token; stays keep the parent's state and log-probs."""
    b, n = parent.shape
    stay = is_stay | ~valid[:, None]
    parent = torch.where(valid[:, None], parent, torch.arange(n, device=parent.device))
    rows = (torch.arange(b, device=parent.device)[:, None] * n + parent).reshape(-1)
    parent_cache = _gather_rows(state["lm_cache"], rows)
    parent_logp = state["lm_logp"].reshape(b * n, -1)[rows]
    adv_logp, adv_cache = lm_step_fn(ext_c.clamp(min=0).reshape(-1), parent_cache)
    keep = stay.reshape(-1)
    return {"lm_cache": _rows_where(keep, parent_cache, adv_cache),
            "lm_logp": torch.where(keep[:, None], parent_logp,
                                   adv_logp.float()).reshape(b, n, -1)}


def _step(state: dict, frame: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
          *, blank: int, ctx: Optional[Dict[str, torch.Tensor]],
          ctx_weight: float, lm_step_fn=None, lm_weight: float = 0.0) -> dict:
    """One frame of the search for the whole batch.  state tensors are
    [B, N] (toks [B, N, T], cmatch [B, N, P], lm_logp [B, N, V_lm], the LM
    cache's leaves [B * N, ...]); frame and cand [B, V]; valid [B]: frames
    past an utterance's length leave its state as it was."""
    toks, lens, last = state["toks"], state["lens"], state["last"]
    h1, h2, pb, pnb = state["h1"], state["h2"], state["pb"], state["pnb"]
    b, n, t_cap = toks.shape
    v = frame.shape[-1]
    dev = frame.device
    vocab = torch.arange(v, device=dev)

    ptot = _logaddexp(pb, pnb)

    # stay candidates: blank after anything keeps the prefix; a repeat of
    # the last token adds to its non-blank mass
    stay_pb = ptot + frame[:, blank, None]
    last_c = last.clamp(0, v - 1)
    last_lp = torch.where((last >= 0) & cand.gather(1, last_c), frame.gather(1, last_c),
                          NEG_INF)
    stay_pnb = pnb + last_lp

    # extensions [B, N, V]: prefix + c (c != blank); c equal to the last
    # token extends only from the blank-terminated mass
    base = torch.where(vocab[None, None, :] == last[:, :, None], pb[:, :, None],
                       ptot[:, :, None])
    p_ext = base + frame[:, None, :]
    if lm_step_fn is not None:
        v_lm = min(v, state["lm_logp"].shape[-1])
        fuse = torch.full_like(p_ext, NEG_INF)
        fuse[..., :v_lm] = state["lm_logp"][..., :v_lm]
        p_ext = p_ext + lm_weight * fuse
    if ctx is not None:
        p_ext = p_ext + ctx_weight * context_boost(ctx, state["cmatch"])
    ext_ok = cand[:, None, :] & (vocab != blank)[None, None, :]
    p_ext = torch.where(ext_ok, p_ext, NEG_INF)
    h1_ext = hash_step(h1[:, :, None], HASH_MULT1, vocab)
    h2_ext = hash_step(h2[:, :, None], HASH_MULT2, vocab)

    # fold extensions that recreate a live beam's prefix into that beam's
    # stay; dead (sentinel) beams never absorb mass
    live = ptot > NEG_INF / 2
    match = ((h1_ext[..., None] == h1[:, None, None, :])
             & (h2_ext[..., None] == h2[:, None, None, :])
             & (p_ext[..., None] > NEG_INF / 2)
             & live[:, None, None, :])                              # [B, N, V, N]
    contrib = torch.where(match, p_ext[..., None], NEG_INF)
    merged = torch.logsumexp(contrib.reshape(b, n * v, n), dim=1)   # [B, N]
    stay_pnb = _logaddexp(stay_pnb, merged.clamp(min=NEG_INF))
    p_ext = torch.where(match.any(dim=-1), NEG_INF, p_ext)

    # prune: the best N of the N stays and N*V extensions
    totals = torch.cat([_logaddexp(stay_pb, stay_pnb), p_ext.reshape(b, n * v)], dim=1)
    sel = torch.sort(totals, dim=1, descending=True, stable=True)[1][:, :n]

    is_stay = sel < n
    parent = torch.where(is_stay, sel, (sel - n) // v)
    ext_c = torch.where(is_stay, -1, (sel - n) % v)
    ext_c0 = ext_c.clamp(min=0)

    def pick(x):
        return x.gather(1, parent)

    lens_p = pick(lens)
    new_toks = toks.gather(1, parent[:, :, None].expand(b, n, t_cap))
    append = ((torch.arange(t_cap, device=dev)[None, None, :] == lens_p[:, :, None])
              & ~is_stay[:, :, None])
    new = {
        "toks": torch.where(append, ext_c[:, :, None], new_toks),
        "lens": lens_p + (~is_stay).long(),
        "last": torch.where(is_stay, pick(last), ext_c),
        "h1": torch.where(is_stay, pick(h1), hash_step(pick(h1), HASH_MULT1, ext_c0)),
        "h2": torch.where(is_stay, pick(h2), hash_step(pick(h2), HASH_MULT2, ext_c0)),
        "pb": torch.where(is_stay, pick(stay_pb), NEG_INF),
        "pnb": torch.where(is_stay, pick(stay_pnb),
                           p_ext.reshape(b, n * v).gather(1, parent * v + ext_c0)),
    }
    if ctx is not None:
        pmatch = state["cmatch"].gather(
            1, parent[:, :, None].expand(-1, -1, state["cmatch"].shape[2]))
        new["cmatch"] = torch.where(is_stay[:, :, None], pmatch,
                                    context_advance(ctx, pmatch, ext_c0))
    else:
        new["cmatch"] = state["cmatch"]
    new = {k: torch.where(valid.view((b,) + (1,) * (x.dim() - 1)), x, state[k])
           for k, x in new.items()}
    if lm_step_fn is not None:
        new.update(_lm_advance(state, parent, is_stay, ext_c, valid, lm_step_fn))
    return new


def init_state(b: int, beam: int, t_max: int, n_phrases: int, device) -> dict:
    """The search's state before the first frame: beam 0 the empty prefix
    (log p_b 0), the other slots dead sentinels."""
    h1, h2 = init_hashes(beam, device)
    pb = torch.full((b, beam), NEG_INF, dtype=torch.float32, device=device)
    pb[:, 0] = 0.0
    return {
        "toks": torch.zeros((b, beam, t_max), dtype=torch.int64, device=device),
        "lens": torch.zeros((b, beam), dtype=torch.int64, device=device),
        "last": torch.full((b, beam), -1, dtype=torch.int64, device=device),
        "h1": h1.expand(b, beam).clone(),
        "h2": h2.expand(b, beam).clone(),
        "pb": pb,
        "pnb": torch.full((b, beam), NEG_INF, dtype=torch.float32, device=device),
        "cmatch": torch.zeros((b, beam, n_phrases), dtype=torch.int64, device=device),
    }


@torch.no_grad()
def beam_search_state(log_probs: torch.Tensor, lengths: torch.Tensor, blank: int,
                      beam: int = 10, cutoff_top_n: int = 40, cutoff_logp: float = -20.0,
                      ctx: Optional[Dict[str, torch.Tensor]] = None,
                      ctx_weight: float = 0.0, lm_step_fn=None, init_lm_cache=None,
                      lm_weight: float = 0.0, sos_id: int = 1) -> dict:
    """The search's state after the last frame, beams in slot order (the
    hash pairs included).  With `lm_step_fn` (tokens [B * beam], cache) ->
    (log-probs, cache), its `init_lm_cache` (leading dim B * beam) and
    `lm_weight`, the LM is fused, seeded with `sos_id`.  Nothing is
    differentiated: without autograd the LM steps keep no graph of the
    frames' caches."""
    log_probs = log_probs.float()
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    cand = _frame_candidates(log_probs, blank, cutoff_top_n, cutoff_logp)
    valid = torch.arange(t_max, device=dev)[None, :] < lengths.to(dev)[:, None]
    n_phrases = 0 if ctx is None else ctx["plen"].shape[0]
    state = init_state(b, beam, t_max, n_phrases, dev)
    if lm_step_fn is not None:
        sos = torch.full((b * beam,), sos_id, dtype=torch.long, device=dev)
        logp0, state["lm_cache"] = lm_step_fn(sos, init_lm_cache)
        state["lm_logp"] = logp0.float().reshape(b, beam, -1)
    for t in range(t_max):
        state = _step(state, log_probs[:, t], cand[:, t], valid[:, t], blank=blank,
                      ctx=ctx, ctx_weight=ctx_weight, lm_step_fn=lm_step_fn,
                      lm_weight=lm_weight)
    return state


def ctc_prefix_beam_device(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    blank: int,
    beam: int = 10,
    cutoff_top_n: int = 40,
    cutoff_logp: float = -20.0,
    lm_step_fn=None,
    init_lm_cache=None,
    lm_weight: float = 0.0,
    sos_id: int = 1,
    context_phrases=None,
    context_weight: float = 0.0,
    context_tables=None,
):
    """Batched prefix beam search on the device of `log_probs`, optionally
    with LM shallow fusion and Aho-Corasick hotword biasing.

    log_probs [B, T, V] (log-softmax over the vocabulary, computed in f32),
    lengths [B].  Returns (tokens [B, beam, T] int64, lengths [B, beam],
    scores [B, beam] = log(p_b + p_nb)), n-best ordered.  When fewer than
    `beam` prefixes live, the tail rows are sentinels scored about -1e30;
    keep rows with scores > -1e29, as the CLI does.

    Fusion: `lm_step_fn` (tokens [B * beam], cache) -> (log-probs
    [B * beam, V_lm], cache), scored from `sos_id`, with `init_lm_cache`
    (leading dim B * beam; models/lm.py:make_lm_step_spec, sized for T + 1
    tokens) and `lm_weight` (off at 0).  Every appended token pays
    lm_weight * log p_lm(c | prefix) once.

    Biasing: `context_phrases` [P, L] (token ids, -1 padding) or
    `context_tables` (`build_context_tables`) with `context_weight` w: a
    token that advances a phrase's match earns +w, a broken match rolls
    back only what its failure link cannot keep, a completed phrase keeps
    its boost.  It composes with fusion.
    """
    if lm_weight == 0.0:
        lm_step_fn = None
    ctx = None
    if context_weight != 0.0 and (context_phrases is not None or context_tables is not None):
        if context_tables is None:
            context_tables = build_context_tables(np.asarray(context_phrases),
                                                  int(log_probs.shape[-1]))
        ctx = context_tensors(context_tables, log_probs.device)
    state = beam_search_state(log_probs, lengths, int(blank), int(beam), int(cutoff_top_n),
                              float(cutoff_logp), ctx, float(context_weight), lm_step_fn,
                              init_lm_cache, float(lm_weight), int(sos_id))
    total = _logaddexp(state["pb"], state["pnb"])
    order = torch.argsort(-total, dim=1, stable=True)
    toks = state["toks"].gather(1, order[:, :, None].expand_as(state["toks"]))
    return toks, state["lens"].gather(1, order), total.gather(1, order)


# ------------------------------------------------------ streaming variant

@torch.no_grad()
def ctc_beam_stream_init(batch: int, beam: int, max_frames: int, lm_step_fn=None,
                         init_lm_cache=None, sos_id: int = 1, num_phrases: int = 0,
                         device=None) -> dict:
    """The prefix beam's state for chunkwise decoding (`ctc_beam_stream_step`;
    openasr_tpu/ops/ctc_beam_device.py:ctc_beam_stream_init): the state the
    one-shot search carries from frame to frame, its token buffer sized to
    the stream's `max_frames`, and `fed`, the valid frames fed so far a
    stream (each can append one token, so `fed` bounds the lengths).
    Chunk boundaries do not exist in the recursion: any chunking of the
    same frames gives the state of the one-shot search.

    With `lm_step_fn` and its `init_lm_cache` (leading dim batch * beam)
    the LM is seeded with `sos_id` here, as the one-shot search seeds it;
    `num_phrases` sizes the hotword match counters."""
    state = init_state(batch, beam, max_frames, num_phrases, device)
    state["fed"] = torch.zeros((batch,), dtype=torch.int64, device=device)
    if lm_step_fn is not None:
        sos = torch.full((batch * beam,), sos_id, dtype=torch.long, device=device)
        logp0, state["lm_cache"] = lm_step_fn(sos, init_lm_cache)
        state["lm_logp"] = logp0.float().reshape(batch, beam, -1)
    return state


@torch.no_grad()
def ctc_beam_stream_step(state: dict, log_probs: torch.Tensor, frame_valid, blank: int,
                         beam: int = 10, cutoff_top_n: int = 40, cutoff_logp: float = -20.0,
                         lm_step_fn=None, lm_weight: float = 0.0, context_tables=None,
                         context_weight: float = 0.0):
    """Advance the streaming prefix beam over one chunk
    (openasr_tpu/ops/ctc_beam_device.py:ctc_beam_stream_step).

    log_probs [B, ch, V] (log-softmax, f32) of the chunk's frames;
    frame_valid [B, ch] bool: the stream's warm-up and final-padding frames
    leave the state as it was.  Pass the `lm_step_fn` the state was seeded
    with and `lm_weight` to fuse the LM, `context_tables`
    (`build_context_tables`) with `context_weight` to bias (the state's
    counters sized by init's `num_phrases`).

    -> (new state, (tokens [B, beam, max_frames], lengths [B, beam],
    scores [B, beam])), the n-best after this chunk.  Any chunking of T
    frames equals `ctc_prefix_beam_device` over [B, T, V], with fusion and
    biasing too.  Raises before the token buffer could overflow."""
    valid = torch.as_tensor(frame_valid, device=log_probs.device).bool()
    check_token_capacity(state, valid)
    return ctc_beam_stream_body(state, log_probs, valid, blank, beam, cutoff_top_n, cutoff_logp,
                                lm_step_fn, lm_weight, context_tables, context_weight)


def check_token_capacity(state: dict, frame_valid: torch.Tensor) -> None:
    """Raise before a chunk of `frame_valid` [B, ch] could overflow the
    state's token buffer: each valid frame can append one token.  Reads
    the frames fed back to the host, so it stays outside the traceable
    `ctc_beam_stream_body`; serving.ExportedStreamBeam replays it (its
    max_frames is the export's)."""
    cap = state["toks"].shape[-1]
    fed_now = int(state["fed"].max())
    incoming = int(torch.as_tensor(frame_valid).bool().sum(dim=1).max())
    if fed_now + incoming > cap:
        raise ValueError(
            f"stream exceeds the beam token buffer: {fed_now} valid "
            f"frames fed + {incoming} incoming > max_frames={cap}; "
            f"re-init ctc_beam_stream_init with a larger max_frames"
        )


@torch.no_grad()
def ctc_beam_stream_body(state: dict, log_probs: torch.Tensor, valid: torch.Tensor,
                         blank: int, beam: int = 10, cutoff_top_n: int = 40,
                         cutoff_logp: float = -20.0, lm_step_fn=None, lm_weight: float = 0.0,
                         context_tables=None, context_weight: float = 0.0):
    """`ctc_beam_stream_step` without its capacity guard: no host read, so
    a program can trace it (serving.export_stream_beam).  valid [B, ch]
    bool on log_probs' device."""
    dev = log_probs.device
    ctx = None
    if context_tables is not None and context_weight != 0.0:
        n_phrases = int(np.shape(context_tables["plen"])[0])
        if state["cmatch"].shape[-1] != n_phrases:
            raise ValueError(
                f"state carries {state['cmatch'].shape[-1]} phrase "
                f"counters but context_tables has {n_phrases} phrases — init "
                f"the stream state with num_phrases matching the table"
            )
        ctx = context_tensors(context_tables, dev)
    if lm_weight == 0.0:
        lm_step_fn = None
    log_probs = log_probs.float()
    cand = _frame_candidates(log_probs, int(blank), int(cutoff_top_n), float(cutoff_logp))
    new = state
    for t in range(log_probs.shape[1]):
        new = _step(new, log_probs[:, t], cand[:, t], valid[:, t], blank=int(blank), ctx=ctx,
                    ctx_weight=float(context_weight), lm_step_fn=lm_step_fn,
                    lm_weight=float(lm_weight))
    # what the frames' steps do not carry: the frame count and, unfused,
    # the LM state as it was; in the input's key order, so that a traced
    # tick's state comes back in the layout it takes (serving.py)
    new = {k: new.get(k, v) for k, v in state.items()}
    new["fed"] = state["fed"] + valid.sum(dim=1)
    total = _logaddexp(new["pb"], new["pnb"])
    order = torch.argsort(-total, dim=1, stable=True)
    toks = new["toks"].gather(1, order[:, :, None].expand_as(new["toks"]))
    return new, (toks, new["lens"].gather(1, order), total.gather(1, order))
