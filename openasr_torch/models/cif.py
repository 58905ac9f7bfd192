"""CIF model families: CIF, ctc_cif, CIF_FC, CIF_MIX.

Counterpart of openasr_tpu/models/cif.py.  One body (`CIFModule`): the
encoder, the assigner's weights, the train-time quantity scaling (noise
U(-0.45, 0.45) a row from `rng.host`, the rank's rows of the global
batch's draw, in a training forward), the
integrate-and-fire closed form (ops/cif.py) and the heads of the family:
the CIF decoder (CIF, ctc_cif), a CTC head on the encoder (ctc_cif,
CIF_FC, CIF_MIX), a phone head on the CIF frames (CIF_FC, CIF_MIX) and a
Transformer char decoder over them (CIF_MIX, paired batches only).  The
fire capacity is the padded target length in training and
`max_decode_len` at decode.

The losses are sums, as the JAX package returns them: the quantity loss
(ops/losses.py:cal_qua_loss) against the target lengths, CE over the
decoder's or phone head's logits, and CTC over the encoder's.  Decoding
(CIF, ctc_cif) runs the beam for exactly `max_decode_len` steps with no
EOS finishing, each step a full forward of the CIF decoder, and gives
each utterance its CIF length round(sum(alphas)); CIF_FC decodes phones
greedily.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.assigner import assigner_from_config
from openasr_torch.models.decoder import cif_decoder_from_config, transformer_decoder_from_config
from openasr_torch.models.encoder import TransformerEncoder
from openasr_torch.models.layers import TrainRNG, any_empty
from openasr_torch.models.lm import make_lm_fusion
from openasr_torch.models.speech import (
    ConvTransformerModule,
    _f32_head,
    _with_moe_aux,
    splayer_from_config,
    target_lengths_of,
)
from openasr_torch.ops.beam_search import batch_beam_search, beam_expand
from openasr_torch.ops.cif import cif, cif_output_lengths, scale_alphas
from openasr_torch.ops.losses import cal_ce_loss, cal_ctc_loss, cal_qua_loss
from openasr_torch.ops.masks import sequence_mask


class CIFModule(nn.Module):
    def __init__(self, configs: Config, decoder: Optional[str] = None, vocab_size: int = 0,
                 use_ctc: bool = False, use_phone_fc: bool = False,
                 threshold: float = 0.95):
        """`decoder`: "cif" (the CIF decoder), "char" (CIF_MIX's
        Transformer decoder) or None; `vocab_size`: the CTC and phone
        heads' width."""
        super().__init__()
        self.threshold = threshold
        self.splayer = splayer_from_config(configs.signal)
        self.encoder = TransformerEncoder.from_config(configs.encoder)
        d_enc = int(configs.encoder["d_model"])
        self.assigner = assigner_from_config(configs.assigner, d_enc)
        self.decoder = self.char_decoder = None
        if decoder == "cif":
            self.decoder = cif_decoder_from_config(configs.decoder)
        elif decoder == "char":
            self.char_decoder = transformer_decoder_from_config(configs.decoder)
        self.ctc_fc = nn.Linear(d_enc, vocab_size, bias=False) if use_ctc else None
        self.phone_fc = nn.Linear(d_enc, vocab_size, bias=False) if use_phone_fc else None

    encoder_lengths = ConvTransformerModule.encoder_lengths
    encode = ConvTransformerModule.encode

    def forward(self, inputs, input_lengths, target_lengths, ids, char_ids=None,
                char_lengths=None, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None) -> dict:
        """-> {raw_num, and of this family's heads: ctc_logits and
        ctc_lengths, phone_logits, logits, char_logits}.  The fire
        capacity is ids.shape[1]; `empty_rows`: some encoder length <= 0
        (None: read it back).  The decoders' rows with a target length
        <= 0 are found by reading the lengths back."""
        empty_rows = any_empty(self.encoder_lengths(input_lengths), empty_rows)
        enc, elens = self.encode(inputs, input_lengths, rng, empty_rows)
        out = {}
        if self.ctc_fc is not None:
            out["ctc_logits"], out["ctc_lengths"] = _f32_head(self.ctc_fc, enc), elens
        alphas = self.assigner(enc, elens, rng)
        alphas, out["raw_num"] = scale_alphas(
            alphas, target_lengths,
            noise=rng.rand_rows(target_lengths.shape) if rng is not None else None)
        cif_out = cif(enc, alphas, ids.shape[1], self.threshold)
        if self.phone_fc is not None:
            out["phone_logits"] = _f32_head(self.phone_fc, cif_out)
        if self.decoder is not None:
            out["logits"] = self.decoder(cif_out, ids, target_lengths, rng)
        if self.char_decoder is not None and char_ids is not None:
            out["char_logits"] = self.char_decoder(cif_out, target_lengths, char_ids, rng)
        return out

    def get_encoded(self, inputs, input_lengths, capacity: int,
                    empty_rows: Optional[bool] = None):
        """Decode: the CIF frames [B, capacity, D] f32 of the unscaled
        weights, and the CIF lengths round(sum(alphas)) [B]."""
        enc, elens = self.encode(inputs, input_lengths, None, empty_rows)
        alphas = self.assigner(enc, elens)
        return cif(enc, alphas, capacity, self.threshold), cif_output_lengths(alphas)


def _counts(n_tokens: torch.Tensor, n_seqs: int, device) -> dict:
    return {"n_tokens": n_tokens,
            "n_seqs": torch.tensor(float(n_seqs), device=device)}


class _CIFFramework(Framework):
    moe_capable = True
    decoder: Optional[str] = None
    use_ctc = False
    use_phone_fc = False

    @classmethod
    def vocab_size_of(cls, configs: Config) -> int:
        return int(configs.decoder["vocab_size"])

    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        return CIFModule(configs, cls.decoder, cls.vocab_size_of(configs),
                         cls.use_ctc, cls.use_phone_fc)


@register_model("CIF")
class CIF(_CIFFramework):
    """ce + qua (+ ctc for ctc_cif) over token targets."""

    decoder = "cif"

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{qua_loss, ce_loss[, ctc_loss], n_tokens, n_seqs[, moe_aux_loss]};
        `rng` makes it the train forward; `empty_rows` is `has_empty_rows`
        of the batch."""
        inputs, lengths = self.batch_inputs(batch)
        tlen = target_lengths_of(batch["paddings"])
        out, moe_aux = self.forward_with_moe_aux(inputs, lengths, tlen, batch["ids"], rng=rng,
                                                 empty_rows=empty_rows)
        losses = {
            "qua_loss": cal_qua_loss(out["raw_num"], tlen, self.data_group),
            "ce_loss": cal_ce_loss(out["logits"], batch["labels"], batch["paddings"],
                                   label_smooth),
            **_counts((1.0 - batch["paddings"].float()).sum(), batch["ids"].shape[0],
                      batch["ids"].device),
        }
        if self.use_ctc:
            losses["ctc_loss"] = cal_ctc_loss(out["ctc_logits"], out["ctc_lengths"],
                                              batch["labels"], tlen)
        return _with_moe_aux(losses, moe_aux)

    @torch.inference_mode()
    def get_encoded(self, inputs, lengths, capacity: int, empty_rows: Optional[bool] = None):
        return self.module.get_encoded(inputs, lengths, capacity, empty_rows)

    @torch.inference_mode()
    def batch_beam_decode(self, inputs, lengths, beam_size=5, max_decode_len=100,
                          empty_rows: Optional[bool] = None, context_tables=None,
                          context_weight: float = 0.0, lm=None, lm_weight: float = 0.0):
        """-> (preds [B, beam, L], lengths [B, beam], scores [B, beam]): a
        beam over the CIF frames for exactly `max_decode_len` steps (no EOS
        finishing), each step the CIF decoder's full forward of the padded
        prefix; every hypothesis of an utterance has its CIF length, at
        most `max_decode_len`.  Hotword biasing applies at every emitted
        position, and an `lm` with `lm_weight` != 0 is fused at every one
        (shallow fusion, as in the attention beam).  Rows of CIF length 0
        are found once a batch, by reading the lengths back."""
        encoded, cif_lens = self.get_encoded(inputs, lengths, max_decode_len, empty_rows)
        b = encoded.shape[0]
        cif_lens = torch.clamp(cif_lens, max=max_decode_len)
        enc_bb = beam_expand(encoded, beam_size)
        lens_bb = beam_expand(cif_lens, beam_size)
        dec_empty = any_empty(cif_lens)
        decoder = self.module.decoder
        cache = {"prefix": torch.zeros((b * beam_size, max_decode_len), dtype=torch.long,
                                       device=encoded.device)}

        def step_fn(tokens, index, cache):
            # the cache is this step's own: the search reorders it by copy
            cache["prefix"][:, index] = tokens
            return decoder.step(enc_bb, lens_bb, cache["prefix"], index + 1, dec_empty), cache

        lm_step_fn, init_lm_cache = make_lm_fusion(
            lm if lm_weight != 0.0 else None, b * beam_size, max_len=max_decode_len + 1)
        preds, _, scores = batch_beam_search(
            step_fn, cache, b, beam_size, max_decode_len, decoder.vocab_size,
            device=encoded.device, use_eos=False,
            context_tables=context_tables, context_weight=context_weight,
            lm_step_fn=lm_step_fn, init_lm_cache=init_lm_cache, lm_weight=lm_weight,
        )
        return preds, cif_lens[:, None].expand(scores.shape).to(torch.int32), scores

    def fc_component_names(self):
        return ("decoder", "ctc_fc")


@register_model("ctc_cif")
class CTCCIF(CIF):
    use_ctc = True


@register_model("CIF_FC")
class CIFFC(_CIFFramework):
    """Phone-level CIF: ctc + qua + ce over a linear phone head.  Phone
    paddings come from the phone lengths."""

    use_ctc = True
    use_phone_fc = True

    def _phone_losses(self, batch: dict, out: dict, label_smooth: float, moe_aux) -> dict:
        phones, plen = batch["phones"], batch["phone_lengths"]
        paddings = 1.0 - sequence_mask(plen, phones.shape[1]).float()
        return _with_moe_aux({
            "ctc_loss": cal_ctc_loss(out["ctc_logits"], out["ctc_lengths"], phones, plen),
            "qua_loss": cal_qua_loss(out["raw_num"], plen, self.data_group),
            "ce_loss": cal_ce_loss(out["phone_logits"], phones, paddings, label_smooth),
            **_counts((1.0 - paddings).sum(), phones.shape[0], phones.device),
        }, moe_aux)

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{ctc_loss, qua_loss, ce_loss, n_tokens, n_seqs[, moe_aux_loss]}
        over the phones."""
        inputs, lengths = self.batch_inputs(batch)
        out, moe_aux = self.forward_with_moe_aux(inputs, lengths, batch["phone_lengths"],
                                                 batch["phones"], rng=rng,
                                                 empty_rows=empty_rows)
        return self._phone_losses(batch, out, label_smooth, moe_aux)

    @torch.inference_mode()
    def greedy_phone_decode(self, inputs, lengths, max_decode_len: int = 100,
                            empty_rows: Optional[bool] = None):
        """-> (argmax phone ids [B, max_decode_len], CIF lengths [B])."""
        cif_out, cif_lens = self.module.get_encoded(inputs, lengths, max_decode_len,
                                                    empty_rows)
        logits = _f32_head(self.module.phone_fc, cif_out)
        return logits.argmax(dim=-1), torch.clamp(cif_lens, max=max_decode_len)

    def fc_component_names(self):
        return ("ctc_fc", "phone_fc")


@register_model("CIF_MIX")
class CIFMIX(CIFFC):
    """CIF_FC plus a Transformer char decoder over the CIF frames.
    Acoustic batches carry features and phones; paired batches also char
    ids, labels and paddings, and add `ce_char_loss` and
    `n_char_tokens`.  The phone heads' width is `phone_size` (top level or
    in `assigner`), else the decoder's vocabulary."""

    decoder = "char"

    @classmethod
    def vocab_size_of(cls, configs: Config) -> int:
        return int(configs.get("phone_size") or configs.assigner.get("phone_size")
                   or configs.decoder["vocab_size"])

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        inputs, lengths = self.batch_inputs(batch)
        paired = "ids" in batch
        chars = {}
        if paired:
            chars = {"char_ids": batch["ids"],
                     "char_lengths": target_lengths_of(batch["paddings"])}
        out, moe_aux = self.forward_with_moe_aux(inputs, lengths, batch["phone_lengths"],
                                                 batch["phones"], rng=rng,
                                                 empty_rows=empty_rows, **chars)
        losses = self._phone_losses(batch, out, label_smooth, moe_aux)
        if paired:
            losses["ce_char_loss"] = cal_ce_loss(out["char_logits"], batch["labels"],
                                                 batch["paddings"], label_smooth)
            losses["n_char_tokens"] = (1.0 - batch["paddings"].float()).sum()
        return losses

    def fc_component_names(self):
        return ("ctc_fc", "phone_fc", "char_decoder")
