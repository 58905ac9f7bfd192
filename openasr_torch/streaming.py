"""Streaming (chunk-incremental) inference for chunk-trained speech models.

Counterpart of openasr_tpu/streaming.py (`StreamingRecognizer`, :72).  A
conv-ctc, conv-transformer or conv-ctc-transformer trained with
`encoder.streaming: {chunk: N, left_chunks: L}` (the chunk mask of
ops/masks.py:chunk_bias, which the attention kernels apply in their chunk
mode) decodes chunk by chunk with bounded state, and computes the same
encoder states as the batch forward over the whole utterance:

  wave chunk [B, 4*ch*shift] --(fbank, 4*shift-sample cache)-->
  4*ch feature frames        --(x4 conv subsample, 4-frame cache)-->
  ch encoder frames          --(chunk attention, L*ch-frame KV cache/layer)-->
  ch encoder states          --(pointwise CTC head)--> ch logit frames

Every stage is VALID (snip-edges), so each is a pure function of a bounded
window.  The fbank window looks 2 frames ahead and the VALID conv one
encoder frame, so the first `phase` encoder slots of a stream (2 for waves,
1 for offline features) are warm-up slots: masked as keys, never emitted;
the training mask's phase puts every later chunk boundary at the same
place (models/speech.py:streaming_phase_of).

The state is a dict of fixed-shape tensors on the model's device (KV
caches [B, L*ch, H, Dh] a layer, the feature and wave caches, the frames
fed, and the chunk index, a 0-d int64 tensor as in the JAX package, so
that a traced tick (serving.py) takes it as an input).  `step` reads the
chunk index back for its positional-encoding capacity guard, which stays
on the host, outside the traceable `_step_impl`.  A tick is one call of `step`:
on the card the fbank kernel once (waves), the 2-D convolutions, the
LayerNorm kernel twice a layer and once for the final norm, and the
GEMMs; the chunk's attention against the cache is dense
(`TransformerEncoderLayer.attend_cached`), as in the JAX package, whose
chunk step runs outside any Pallas kernel: its key bias masks slots at
both ends of the window (start-up and past the length), which is no
key-padding pattern.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from openasr_torch.models.layers import _pe_on
from openasr_torch.models.speech import _f32_head
from openasr_torch.models.subsample import conv_out_len
from openasr_torch.ops.fbank import fbank, fbank_config_from_model_cfg
from openasr_torch.ops.masks import NEG_INF


def _enc_frames_of(n: torch.Tensor, window: int, shift: int, offline: bool) -> torch.Tensor:
    """True encoder frames of n input units (samples or feature frames):
    snip-edges framing, then two VALID (3, 2) conv layers, the batch
    subsampler's length rule."""
    f = n if offline else torch.where(n >= window, (n - window) // shift + 1,
                                      torch.zeros_like(n))
    t1 = conv_out_len(f, 3, 2).clamp(min=0)
    return conv_out_len(t1, 3, 2).clamp(min=0)


class StreamingRecognizer:
    """Incremental executor of one streaming-trained model over B parallel
    streams, on the model's device.

        rec = StreamingRecognizer(model)
        state = rec.init_state(batch_size)
        for chunk in chunks:                     # [B, chunk_samples] or
            state, out = rec.step(state, chunk)  # [B, 4 * chunk, D] feats
            # out["logits"] [B, ch, V], out["valid"] [B, ch], out["enc"]

    Pad the final short chunk with zeros and pass its true lengths as
    `chunk_lens`.  `decode_waves` drives the loop with greedy or
    prefix-beam partials.  `max_frames` is the positional encoding's
    capacity in encoder frames (the batch forward's 5000); `step` refuses a
    chunk past it rather than clamp the positions."""

    def __init__(self, model, max_frames: int = 5000):
        self.model = model
        self.max_frames = int(max_frames)
        cfgs = model.configs
        enc_cfg = cfgs.encoder or {}
        streaming = enc_cfg.get("streaming") or {}
        self.chunk = int(streaming.get("chunk", 0))
        self.left = int(streaming.get("left_chunks", -1))
        if self.chunk <= 0:
            raise ValueError(
                "model has no encoder.streaming config — train with "
                "encoder.streaming: {chunk: N, left_chunks: L} to stream"
            )
        if self.left < 0:
            raise ValueError(
                "encoder.streaming.left_chunks must be >= 0 to stream: "
                "unlimited left context cannot run with a bounded KV cache"
            )
        signal = cfgs.signal or {}
        self.offline = signal.get("feature_type") != "fbank"
        self.phase = 1 if self.offline else 2

        sub = enc_cfg.get("sub") or {}
        sub_type, layer_num = sub.get("type"), int(sub.get("layer_num", 2))
        if not (sub_type == "ConvV1" or (sub_type == "ConvV2" and layer_num == 2)):
            raise ValueError(
                "streaming needs an x4 time subsampler (sub.type ConvV1, "
                f"or ConvV2 with layer_num 2); got {sub_type!r} "
                f"layer_num={layer_num}"
            )
        self.encoder = model.module.encoder
        self.d_model = int(enc_cfg["d_model"])
        self.nhead = int(enc_cfg["nhead"])
        # the CTC head: ctc_fc (conv-ctc-transformer) or fc (conv-ctc);
        # attention-only models stream encoder states for the final pass
        self.head = next((getattr(model.module, n) for n in ("ctc_fc", "fc")
                          if isinstance(getattr(model.module, n, None), nn.Linear)), None)
        self.device = self.encoder.dtype_probe.device
        if self.offline:
            self.feat_dim = int(enc_cfg["input_dim"])
            self.chunk_feats = 4 * self.chunk
            self.fbank_cfg = None
            self.window = self.shift = 1
        else:
            cfg = fbank_config_from_model_cfg(signal)
            self.fbank_cfg = cfg
            self.window, self.shift = cfg.window_size, cfg.window_shift
            if self.window > 5 * self.shift:
                raise ValueError(
                    f"frame window {self.window} > 5x shift {self.shift}: "
                    "the 4-slot fbank lookahead cache cannot cover it"
                )
            self.feat_dim = cfg.feat_dim
            self.chunk_samples = 4 * self.chunk * self.shift

    @property
    def blank(self) -> Optional[int]:
        return None if self.head is None else self.head.out_features - 1

    # ------------------------------------------------------------- state

    def init_state(self, batch_size: int) -> dict:
        """Zero caches for `batch_size` streams on the model's device."""
        b, ch = batch_size, self.chunk
        kv_shape = (b, self.left * ch, self.nhead, self.d_model // self.nhead)
        dev, dtype = self.device, self.encoder.compute_dtype
        state = {
            "kv": {f"layer{i}": {"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
                                 "v": torch.zeros(kv_shape, dtype=dtype, device=dev)}
                   for i in range(len(self.encoder.layers))},
            "chunk_idx": torch.zeros((), dtype=torch.int64, device=dev),
            "fed": torch.zeros((b,), dtype=torch.int64, device=dev),  # samples or frames
            "feat_cache": torch.zeros((b, 4, self.feat_dim), dtype=torch.float32, device=dev),
        }
        if not self.offline:
            state["wave_cache"] = torch.zeros((b, 4 * self.shift), dtype=torch.float32,
                                              device=dev)
        return state

    # -------------------------------------------------------------- step

    def step(self, state: dict, chunk, chunk_lens=None):
        """One tick.  chunk: waves [B, chunk_samples] (fbank models) or
        features [B, 4 * chunk, D] (offline), NumPy or a tensor; chunk_lens
        [B]: the true lengths of a zero-padded final chunk (default: full).
        -> (new state, {"enc" [B, ch, d] f32, "valid" [B, ch] bool,
        "logits" [B, ch, V] f32 or None}), on the model's device."""
        chunk = torch.as_tensor(chunk, device=self.device)
        if chunk_lens is None:
            chunk_lens = torch.full((chunk.shape[0],), chunk.shape[1], dtype=torch.int64)
        chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int64, device=self.device)
        cur = int(state["chunk_idx"])
        if (cur + 1) * self.chunk - self.phase > self.max_frames:
            raise ValueError(
                f"stream exceeds positional-encoding capacity: chunk "
                f"{cur} would emit encoder frames past max_frames="
                f"{self.max_frames}; construct "
                f"StreamingRecognizer(model, max_frames=...) larger"
            )
        with torch.inference_mode():
            return self._step_impl(state, chunk, chunk_lens)

    def _step_impl(self, state, chunk, chunk_lens):
        ch, left, phase = self.chunk, self.left, self.phase
        b, dev = chunk.shape[0], self.device
        enc = self.encoder
        new_state = {}
        if self.offline:
            feats = chunk.float()
        else:
            # fbank over [4*shift cache ++ chunk]: frame j is true frame
            # chunk_idx * 4ch + j - 4; frames past 4ch are the next tick's
            # (their samples come again through the cache)
            waves = torch.cat([state["wave_cache"], chunk.float()], dim=1)
            lens = torch.full((b,), waves.shape[1], dtype=torch.int64, device=dev)
            feats = fbank(waves, lens, self.fbank_cfg)[0][:, : 4 * ch]
            new_state["wave_cache"] = waves[:, -4 * self.shift:]

        # x4 conv subsample over [4-frame cache ++ feats] -> exactly ch
        # frames; slot j is true frame chunk_idx * ch + j - phase
        conv_in = torch.cat([state["feat_cache"], feats], dim=1)
        x, _ = enc.sub(conv_in.to(enc.compute_dtype),
                       torch.full((b,), conv_in.shape[1], dtype=torch.int64, device=dev))
        new_state["feat_cache"] = conv_in[:, -4:]

        # positions: global true-frame indices (warm-up slots clamp to 0;
        # they are masked everywhere downstream)
        cur = state["chunk_idx"]
        arange = torch.arange((left + 1) * ch, device=dev)
        t_idx = cur * ch + arange[:ch] - phase
        pe = _pe_on(self.d_model, self.max_frames, dev)
        x = x * (self.d_model ** 0.5) + pe[t_idx.clamp(0, pe.shape[0] - 1)].to(x.dtype)[None]

        # validity: each stream's true frames after this chunk
        fed = state["fed"] + chunk_lens
        e_true = _enc_frames_of(fed, self.window, self.shift, self.offline)
        key_idx = (cur - left) * ch + arange - phase  # [cache ++ current]
        key_ok = (key_idx[None, :] >= 0) & (key_idx[None, :] < e_true[:, None])
        key_bias = torch.where(key_ok, 0.0, NEG_INF).float()[:, None, None, :]

        kv = {}
        for i, layer in enumerate(enc.layers):
            cache = state["kv"][f"layer{i}"]
            x, k_cur, v_cur = layer.chunk_step(x, cache["k"], cache["v"], key_bias)
            kv[f"layer{i}"] = {"k": torch.cat([cache["k"], k_cur], dim=1)[:, ch:],
                               "v": torch.cat([cache["v"], v_cur], dim=1)[:, ch:]}
        x = enc.final_norm(x)
        out = {
            "enc": x.float(),
            "valid": (t_idx[None, :] >= 0) & (t_idx[None, :] < e_true[:, None]),
            "logits": None if self.head is None else _f32_head(self.head, x),
        }
        new_state.update(kv=kv, chunk_idx=cur + 1, fed=fed)
        # in the input's key order: a traced tick's state comes back in the
        # layout it takes (serving.py)
        return {k: new_state[k] for k in state}, out

    # ------------------------------------------------------ host driving

    @torch.inference_mode()
    def decode_waves(self, inputs, lengths, on_partial=None, partial_beam: int = 0,
                     lm_fusion: Optional[dict] = None, context_tables=None,
                     context_weight: float = 0.0):
        """Drive a batch of utterances chunk by chunk and CTC-decode as it
        goes.  inputs: [B, N] waves (fbank models) or [B, T, D] features
        (offline), NumPy or a tensor; lengths [B].  -> (hyps: a list of id
        lists, enc [B, E, d] f32, enc_lens [B] int64), enc and its lengths
        on the model's device: the streamed encoder states for a final
        attention pass.  `on_partial(chunk_idx, hyps)` sees the partial
        hypotheses after each chunk.

        partial_beam 0: greedy partials.  partial_beam N > 0: prefix-beam
        partials, the device beam's state carried across chunks
        (`ctc_beam_stream_step`), so each tick's partial is the one-shot
        prefix beam over every frame so far and the last is its 1-best;
        with `lm_fusion` (`make_lm_step_spec(lm)` plus `weight` and
        optionally `sos_id`) and `context_tables` / `context_weight`
        (`build_context_tables`) the beam carries the LM's cache and the
        hotword counters too."""
        from openasr_torch.ops.ctc_beam_device import ctc_beam_stream_init, ctc_beam_stream_step

        dev = self.device
        inputs = torch.as_tensor(inputs, device=dev)
        lengths = np.asarray(torch.as_tensor(lengths).cpu(), np.int64)
        b = inputs.shape[0]
        unit = self.chunk_feats if self.offline else self.chunk_samples
        n_total = inputs.shape[1]
        n_chunks = max(1, math.ceil(n_total / unit))
        if n_chunks * self.chunk - self.phase > self.max_frames:
            raise ValueError(
                f"{n_chunks} chunks of {self.chunk} encoder frames exceed "
                f"positional-encoding capacity max_frames={self.max_frames}"
                "; construct StreamingRecognizer(model, max_frames=...) "
                "larger"
            )
        pad = n_chunks * unit - n_total
        if pad:
            inputs = torch.nn.functional.pad(inputs, [0, 0] * (inputs.dim() - 2) + [0, pad])

        blank = self.blank
        if partial_beam > 0 and blank is None:
            raise ValueError(
                "partial_beam needs a CTC head (conv-ctc / "
                "conv-ctc-transformer); attention-only models stream "
                "encoder states for the final pass instead"
            )
        beam_state, beam_kw = None, {}
        if partial_beam > 0:
            init_kw = {}
            if lm_fusion is not None and lm_fusion.get("weight", 0.0):
                init_kw = {"lm_step_fn": lm_fusion["step_fn"],
                           "init_lm_cache": lm_fusion["init_cache_fn"](
                               b * partial_beam, n_chunks * self.chunk + 1),
                           "sos_id": int(lm_fusion.get("sos_id", 1))}
                beam_kw.update(lm_step_fn=lm_fusion["step_fn"],
                               lm_weight=float(lm_fusion["weight"]))
            if context_tables is not None and context_weight != 0.0:
                init_kw["num_phrases"] = int(np.shape(context_tables["plen"])[0])
                beam_kw.update(context_tables=context_tables,
                               context_weight=float(context_weight))
            beam_state = ctc_beam_stream_init(b, partial_beam, n_chunks * self.chunk,
                                              device=dev, **init_kw)

        state = self.init_state(b)
        hyps = [[] for _ in range(b)]
        prev_id = np.full((b,), -1, np.int64)
        encs, valids = [], []
        for n in range(n_chunks):
            piece = inputs[:, n * unit:(n + 1) * unit]
            lens = np.clip(lengths - n * unit, 0, unit)
            state, out = self.step(state, piece, lens)
            encs.append(out["enc"])
            valids.append(out["valid"])
            if blank is None:
                continue
            if partial_beam > 0:
                log_probs = torch.log_softmax(out["logits"].float(), dim=-1)
                beam_state, (btoks, blens, _) = ctc_beam_stream_step(
                    beam_state, log_probs, out["valid"], blank=blank, beam=partial_beam,
                    **beam_kw)
                # only the 1-best row comes to the host
                toks, tlens = btoks[:, 0].cpu().numpy(), blens[:, 0].cpu().numpy()
                hyps = [[int(c) for c in toks[i, : tlens[i]]] for i in range(b)]
            else:
                ids = out["logits"].argmax(dim=-1).cpu().numpy()
                valid = out["valid"].cpu().numpy()
                for i in range(b):
                    for j in range(ids.shape[1]):
                        if not valid[i, j]:
                            continue
                        tid = int(ids[i, j])
                        if tid != blank and tid != prev_id[i]:
                            hyps[i].append(tid)
                        prev_id[i] = tid
            if on_partial is not None:
                on_partial(n, [list(h) for h in hyps])

        # the valid frames of each stream, packed from position 0
        enc_all, valid_all = torch.cat(encs, dim=1), torch.cat(valids, dim=1)
        enc_lens = valid_all.sum(dim=1)
        enc = enc_all.new_zeros((b, max(int(enc_lens.max()), 1), enc_all.shape[-1]))
        rows, slots = valid_all.nonzero(as_tuple=True)
        enc[rows, valid_all.cumsum(dim=1)[rows, slots] - 1] = enc_all[rows, slots]
        return hyps, enc, enc_lens
