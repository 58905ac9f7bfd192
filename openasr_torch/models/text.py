"""Text models: phone->char translation (Embed_Decoder, Embed_Decoder_CTC).

Counterpart of openasr_tpu/models/text.py.  The input is phone ids
[B, P] (padded with <eos>) and their counts, not sound:

  Embed_Decoder      `emb` (phone embeddings, Xavier-uniform) as the
                     memory of the weight-tied `decoder` (causal
                     self-attention, cross-attention over the phone
                     lengths); CE loss with label smoothing, the KV-cached
                     attention beam over the decoder's vocabulary.
  Embed_Decoder_CTC  `emb` -> `encoder_block`, a TransformerEncoder built
                     from the **decoder** section (no subsampler;
                     input_dim defaults to encoder.d_model and a Dense
                     `affine` applies only when the widths differ) ->
                     `ctc_fc` (no bias, f32); CTC loss and greedy decode.

Every attention takes the phone lengths as key lengths, so the flash
kernels mask the padding.  A `TrainRNG` makes a forward the train-mode
one; no module reads the train()/eval() flag.  The frameworks reuse the
speech families' loss, beam and greedy code over `batch_inputs` (phones,
phone lengths), with encoder lengths equal to the phone lengths.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import register_model
from openasr_torch.models.decoder import transformer_decoder_from_config
from openasr_torch.models.encoder import TransformerEncoder
from openasr_torch.models.layers import Embedding, TrainRNG
from openasr_torch.models.speech import ConvCTC, ConvTransformer, _f32_head


def _phone_lengths(lengths):
    """The encoder frames of `lengths` phones: the phones themselves."""
    return lengths


class EmbedDecoderModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        self.emb = Embedding(int(configs.encoder["vocab_size"]),
                             int(configs.encoder["d_model"]))
        self.decoder = transformer_decoder_from_config(configs.decoder)

    encoder_lengths = staticmethod(_phone_lengths)

    def encode(self, phones, phone_lengths, rng: Optional[TrainRNG] = None,
               empty_rows: Optional[bool] = None):
        """-> (phone embeddings [B, P, D], phone_lengths): the memory."""
        del rng, empty_rows
        return self.emb(phones.long()), phone_lengths

    def forward(self, phones, phone_lengths, ids, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """Teacher-forced logits [B, U, V]."""
        memory, lens = self.encode(phones, phone_lengths)
        return self.decoder(memory, lens, ids, rng, empty_rows)


class EmbedDecoderCTCModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        d_emb = int(configs.encoder["d_model"])
        enc_cfg = Config(configs.decoder)
        if not enc_cfg.get("input_dim"):
            enc_cfg["input_dim"] = d_emb
        self.emb = Embedding(int(configs.encoder["vocab_size"]), d_emb)
        self.encoder_block = TransformerEncoder.from_config(enc_cfg)
        self.ctc_fc = nn.Linear(int(enc_cfg["d_model"]), int(configs.decoder["vocab_size"]),
                                bias=False)

    encoder_lengths = staticmethod(_phone_lengths)

    def forward(self, phones, phone_lengths, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """-> (logits [B, P, V] f32, phone_lengths)."""
        x = self.emb(phones.long())
        enc, lens = self.encoder_block(x, phone_lengths, rng, empty_rows)
        return _f32_head(self.ctc_fc, enc), lens


def _phone_inputs(batch: dict):
    return batch["phones"], batch["phone_lengths"]


@register_model("Embed_Decoder")
class EmbedDecoder(ConvTransformer):
    """loss {ce_loss, n_tokens, n_seqs} and `batch_beam_decode(phones,
    phone_lengths, beam_size, max_decode_len)` -> (preds [B, beam, L],
    lengths, scores)."""

    module_cls = EmbedDecoderModule
    moe_capable = False

    def batch_inputs(self, batch: dict):
        return _phone_inputs(batch)


@register_model("Embed_Decoder_CTC")
class EmbedDecoderCTC(ConvCTC):
    """loss {ctc_loss, n_tokens, n_seqs[, moe_aux_loss]}, `get_logits` and
    `greedy_decode` over (phones, phone_lengths).  Its stack is configured
    by the `decoder` section, and so is its MoE (`decoder.moe`)."""

    module_cls = EmbedDecoderCTCModule
    moe_section = "decoder"

    def batch_inputs(self, batch: dict):
        return _phone_inputs(batch)

    def fc_component_names(self) -> tuple:
        return ("ctc_fc",)
