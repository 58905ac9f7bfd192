"""Speech model families: conv-transformer and conv-ctc-transformer.

Counterpart of ConvTransformer / ConvCTCTransformer in
openasr_tpu/models/speech.py, for decoding: the attention beam over the
KV-cached decoder.  conv-ctc-transformer also carries `ctc_fc`, the CTC
head that training and the CTC decoders read (the attention beam does
not).  Losses and the other families follow in later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.decoder import transformer_decoder_from_config
from openasr_torch.models.encoder import TransformerEncoder
from openasr_torch.models.frontend import SPLayer
from openasr_torch.ops.beam_search import batch_beam_search, beam_expand
from openasr_torch.ops.masks import padding_bias


class ConvTransformerModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        self.splayer = SPLayer((configs.signal or {}).get("feature_type", "offline"))
        self.encoder = TransformerEncoder.from_config(configs.encoder)
        self.decoder = transformer_decoder_from_config(configs.decoder)

    def encode(self, inputs, input_lengths):
        x, lens = self.splayer(inputs, input_lengths)
        return self.encoder(x, lens)

    def forward(self, inputs, input_lengths, ids):
        enc, elens = self.encode(inputs, input_lengths)
        return self.decoder(enc, elens, ids)


class ConvCTCTransformerModule(ConvTransformerModule):
    def __init__(self, configs: Config):
        super().__init__(configs)
        self.ctc_fc = nn.Linear(
            int(configs.encoder["d_model"]), int(configs.decoder["vocab_size"]),
            bias=False,
        )

    def forward(self, inputs, input_lengths, ids):
        """-> (ctc_logits [B, T', V], encoder lengths [B], ce_logits [B, U, V])."""
        enc, elens = self.encode(inputs, input_lengths)
        return self.ctc_fc(enc), elens, self.decoder(enc, elens, ids)


@register_model("conv-transformer")
class ConvTransformer(Framework):
    module_cls = ConvTransformerModule

    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        return cls.module_cls(configs)

    def encode(self, inputs: torch.Tensor, lengths: torch.Tensor):
        return self.module.encode(inputs, lengths)

    @torch.inference_mode()
    def batch_beam_decode(self, inputs, lengths, beam_size=5, max_decode_len=100):
        """-> (preds [B, beam, L], lengths [B, beam], scores [B, beam])."""
        encoded, elens = self.encode(inputs, lengths)
        return self.beam_decode_encoded(encoded, elens, beam_size, max_decode_len)

    @torch.inference_mode()
    def beam_decode_encoded(self, encoded, elens, beam_size=5, max_decode_len=100):
        """Beam search over precomputed encoder states."""
        b = encoded.shape[0]
        enc_bb = beam_expand(encoded, beam_size)
        lens_bb = beam_expand(elens, beam_size)
        memory_bias = padding_bias(lens_bb, enc_bb.shape[1])
        decoder = self.module.decoder
        cache = decoder.init_cache(enc_bb, max_decode_len)

        def step_fn(tokens, index, cache):
            logits = decoder.step(tokens, index, cache, memory_bias, max_decode_len)
            return logits, cache

        return batch_beam_search(
            step_fn, cache, b, beam_size, max_decode_len,
            decoder.vocab_size, device=encoded.device,
        )


@register_model("conv-ctc-transformer")
class ConvCTCTransformer(ConvTransformer):
    module_cls = ConvCTCTransformerModule
