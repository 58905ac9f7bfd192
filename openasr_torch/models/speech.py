"""Speech model families: conv-transformer, conv-ctc-transformer, conv-ctc,
gru_ctc.

Counterpart of ConvTransformer / ConvCTCTransformer / ConvCTC in
openasr_tpu/models/speech.py: the training losses (`loss`, raw sums plus
token and sequence counts, as the JAX package returns them); for the
attention families, the attention beam over the KV-cached decoder (with
optional LM shallow fusion and hotword biasing); for conv-ctc, its logits and greedy decode
(the CLI drives the CTC prefix beams over those logits).
conv-ctc-transformer also carries `ctc_fc`, the CTC head.  gru_ctc
(GRUCTC) is WavConv (x160) -> GRU -> `fc` (no bias) -> CTC on raw waves;
`load_splayer` warm-starts its WavConv, weights and running statistics,
from a CPC package and freezes it (`frozen_components`).  The CTC heads
run in f32 also under bf16 autocast: flax's Dense without a dtype
promotes the bf16 encoder output and the f32 kernel to f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.decoder import transformer_decoder_from_config
from openasr_torch.models.encoder import GRUEncoder, TransformerEncoder
from openasr_torch.models.frontend import SPLayer, WavConv
from openasr_torch.models.layers import TrainRNG, any_empty, autocast_off
from openasr_torch.models.lm import make_lm_fusion
from openasr_torch.ops.beam_search import batch_beam_search, beam_expand
from openasr_torch.ops.ctc_decode import ctc_greedy_decode
from openasr_torch.ops.fbank import fbank_config_from_model_cfg
from openasr_torch.ops.losses import cal_ce_loss, cal_ctc_loss
from openasr_torch.ops.masks import padding_bias


def target_lengths_of(paddings: torch.Tensor) -> torch.Tensor:
    """sum(1 - paddings) as int32."""
    return (1.0 - paddings.float()).sum(dim=-1).to(torch.int32)


def splayer_from_config(signal_cfg) -> SPLayer:
    """The frontend of `model.signal`: its feature type, the fbank config
    of an online model, SpecAugment, and dither (off unless
    `signal.dither` is set, though FbankConfig's own default is 1.0)."""
    signal_cfg = signal_cfg or {}
    feature_type = signal_cfg.get("feature_type", "offline")
    return SPLayer(
        feature_type,
        fbank_config_from_model_cfg(signal_cfg) if feature_type == "fbank" else None,
        signal_cfg.get("spec_aug"),
        apply_dither=bool(signal_cfg.get("dither", False)),
    )


def streaming_phase_of(signal_cfg) -> int:
    """The chunk mask's phase for a streaming encoder (ops/masks.py:
    chunk_bias): 2 when the model takes raw waves through the fbank
    frontend (the streaming executor's fbank stage adds one x4 feature slot
    of delay to the subsampler's one conv slot), 1 for offline features."""
    return 2 if (signal_cfg or {}).get("feature_type") == "fbank" else 1


def _f32_head(head: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The head at least in f32 (its weight's dtype, f32 but for a float64
    reference model)."""
    with autocast_off(x.device.type):
        return head(x.to(torch.promote_types(x.dtype, head.weight.dtype)))


def _counts(batch: dict) -> dict:
    return {
        "n_tokens": (1.0 - batch["paddings"].float()).sum(),
        "n_seqs": torch.tensor(float(batch["ids"].shape[0]), device=batch["ids"].device),
    }


class ConvTransformerModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        self.splayer = splayer_from_config(configs.signal)
        self.encoder = TransformerEncoder.from_config(
            configs.encoder, streaming_phase_of(configs.signal))
        self.decoder = transformer_decoder_from_config(configs.decoder)

    def encoder_lengths(self, input_lengths):
        """Encoder frames of the inputs' lengths (samples for an fbank
        frontend, feature frames offline)."""
        return self.encoder.output_lengths(self.splayer.output_lengths(input_lengths))

    def encode(self, inputs, input_lengths, rng: Optional[TrainRNG] = None,
               empty_rows: Optional[bool] = None):
        x, lens = self.splayer(inputs, input_lengths, rng)
        return self.encoder(x, lens, rng, empty_rows)

    def forward(self, inputs, input_lengths, ids, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """`empty_rows` (some encoder length <= 0) is decided once, for the
        encoder and the decoder's cross-attention."""
        empty_rows = any_empty(self.encoder_lengths(input_lengths), empty_rows)
        enc, elens = self.encode(inputs, input_lengths, rng, empty_rows)
        return self.decoder(enc, elens, ids, rng, empty_rows)


class ConvCTCTransformerModule(ConvTransformerModule):
    def __init__(self, configs: Config):
        super().__init__(configs)
        self.ctc_fc = nn.Linear(
            int(configs.encoder["d_model"]), int(configs.decoder["vocab_size"]),
            bias=False,
        )

    def forward(self, inputs, input_lengths, ids, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """-> (ctc_logits [B, T', V] f32, encoder lengths [B], ce_logits [B, U, V])."""
        empty_rows = any_empty(self.encoder_lengths(input_lengths), empty_rows)
        enc, elens = self.encode(inputs, input_lengths, rng, empty_rows)
        return (_f32_head(self.ctc_fc, enc), elens,
                self.decoder(enc, elens, ids, rng, empty_rows))


class ConvCTCModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        self.splayer = splayer_from_config(configs.signal)
        self.encoder = TransformerEncoder.from_config(
            configs.encoder, streaming_phase_of(configs.signal))
        self.fc = nn.Linear(
            int(configs.encoder["d_model"]), int(configs.decoder["vocab_size"]),
            bias=False,
        )

    encoder_lengths = ConvTransformerModule.encoder_lengths

    def forward(self, inputs, input_lengths, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """-> (logits [B, T', V] f32, lengths [B])."""
        x, lens = self.splayer(inputs, input_lengths, rng)
        enc, elens = self.encoder(x, lens, rng, empty_rows)
        return _f32_head(self.fc, enc), elens


class _SpeechFramework(Framework):
    module_cls = nn.Module

    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        return cls.module_cls(configs)


def _with_moe_aux(losses: dict, moe_aux) -> dict:
    """`losses` with `moe_aux_loss` when the model has MoE layers."""
    if moe_aux is not None:
        losses["moe_aux_loss"] = moe_aux
    return losses


@register_model("conv-ctc")
class ConvCTC(_SpeechFramework):
    module_cls = ConvCTCModule
    moe_capable = True

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{ctc_loss, n_tokens, n_seqs[, moe_aux_loss]}; `rng` makes it the
        train forward; `empty_rows` is `has_empty_rows` of the batch (None:
        read back)."""
        del label_smooth
        inputs, lengths = self.batch_inputs(batch)
        (logits, len_logits), moe_aux = self.forward_with_moe_aux(inputs, lengths, rng,
                                                                  empty_rows)
        tlen = target_lengths_of(batch["paddings"])
        ctc = cal_ctc_loss(logits, len_logits, batch["labels"], tlen)
        return _with_moe_aux({"ctc_loss": ctc, **_counts(batch)}, moe_aux)

    @torch.inference_mode()
    def get_logits(self, inputs, lengths, empty_rows: Optional[bool] = None):
        """-> (logits [B, T', V] f32, encoder lengths [B])."""
        return self.module(inputs, lengths, None, empty_rows)

    @torch.inference_mode()
    def greedy_decode(self, inputs, lengths, empty_rows: Optional[bool] = None):
        """-> (collapsed ids [B, T'], their counts [B])."""
        return ctc_greedy_decode(*self.get_logits(inputs, lengths, empty_rows))


@register_model("conv-transformer")
class ConvTransformer(_SpeechFramework):
    module_cls = ConvTransformerModule
    moe_capable = True

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{ce_loss, n_tokens, n_seqs[, moe_aux_loss]}; `rng` makes it the
        train forward; `empty_rows` is `has_empty_rows` of the batch (None:
        read back)."""
        inputs, lengths = self.batch_inputs(batch)
        logits, moe_aux = self.forward_with_moe_aux(inputs, lengths, batch["ids"], rng,
                                                    empty_rows)
        ce = cal_ce_loss(logits, batch["labels"], batch["paddings"], label_smooth)
        return _with_moe_aux({"ce_loss": ce, **_counts(batch)}, moe_aux)

    def encode(self, inputs: torch.Tensor, lengths: torch.Tensor,
               empty_rows: Optional[bool] = None):
        return self.module.encode(inputs, lengths, None, empty_rows)

    @torch.inference_mode()
    def batch_beam_decode(self, inputs, lengths, beam_size=5, max_decode_len=100,
                          empty_rows: Optional[bool] = None, context_tables=None,
                          context_weight: float = 0.0, lm=None, lm_weight: float = 0.0,
                          stop_when_finished: bool = True):
        """-> (preds [B, beam, L], lengths [B, beam], scores [B, beam]);
        `context_tables` (ops.ctc_beam_device.build_context_tables) and
        `context_weight` bias the beam toward hotwords; an `lm` (an LM
        framework of models/lm.py) with `lm_weight` != 0 fuses its
        log-probs (shallow fusion); `stop_when_finished=False` runs every
        step with no host read (ops/beam_search.py), for an export."""
        encoded, elens = self.encode(inputs, lengths, empty_rows)
        return self.beam_decode_encoded(encoded, elens, beam_size, max_decode_len,
                                        context_tables, context_weight, lm, lm_weight,
                                        stop_when_finished)

    @torch.inference_mode()
    def beam_decode_encoded(self, encoded, elens, beam_size=5, max_decode_len=100,
                            context_tables=None, context_weight: float = 0.0,
                            lm=None, lm_weight: float = 0.0,
                            stop_when_finished: bool = True):
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

        lm_step_fn, init_lm_cache = make_lm_fusion(
            lm if lm_weight != 0.0 else None, b * beam_size, max_len=max_decode_len + 1)
        return batch_beam_search(
            step_fn, cache, b, beam_size, max_decode_len,
            decoder.vocab_size, device=encoded.device,
            context_tables=context_tables, context_weight=context_weight,
            lm_step_fn=lm_step_fn, init_lm_cache=init_lm_cache, lm_weight=lm_weight,
            stop_when_finished=stop_when_finished,
        )


@register_model("conv-ctc-transformer")
class ConvCTCTransformer(ConvTransformer):
    module_cls = ConvCTCTransformerModule

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{ctc_loss, ce_loss, n_tokens, n_seqs[, moe_aux_loss]}.  The CTC
        targets exclude the trailing EOS: target lengths - 1, as the JAX
        package (and the reference) count them."""
        inputs, lengths = self.batch_inputs(batch)
        (ctc_logits, len_ctc, ce_logits), moe_aux = self.forward_with_moe_aux(
            inputs, lengths, batch["ids"], rng, empty_rows)
        tlen = target_lengths_of(batch["paddings"])
        ctc = cal_ctc_loss(ctc_logits, len_ctc, batch["labels"], tlen - 1)
        ce = cal_ce_loss(ce_logits, batch["labels"], batch["paddings"], label_smooth)
        return _with_moe_aux({"ctc_loss": ctc, "ce_loss": ce, **_counts(batch)}, moe_aux)


class GRUCTCModule(nn.Module):
    def __init__(self, configs: Config):
        super().__init__()
        self.splayer = WavConv(int(configs.signal["d_model"]))
        self.encoder = GRUEncoder.from_config(configs.encoder)
        self.fc = nn.Linear(int(configs.encoder["d_model"]),
                            int(configs.decoder["vocab_size"]), bias=False)

    @staticmethod
    def encoder_lengths(input_lengths):
        return WavConv.output_lengths(input_lengths)

    def forward(self, waves, wave_lengths, rng: Optional[TrainRNG] = None,
                empty_rows: Optional[bool] = None):
        """-> (logits [B, T', V] f32, lengths [B]); with `rng` the train
        forward (BatchNorm on the batch's statistics, dropout)."""
        del empty_rows
        x, lens = self.splayer(waves, wave_lengths, train=rng is not None)
        x, lens = self.encoder(x, lens, rng)
        return _f32_head(self.fc, x), lens


def load_component(module: nn.Module, prefix: str, pkg: dict, name: str) -> None:
    """Load component `name` of a JAX-layout package (either package's),
    with its `batch_stats` where it has them, into the submodule at
    `prefix` of `module`."""
    from openasr_torch.convert import subtree_to_state_dict

    state = subtree_to_state_dict(pkg["components"][name])
    if pkg.get("batch_stats") is not None and name in pkg["batch_stats"]:
        state.update(subtree_to_state_dict(pkg["batch_stats"][name]))
    sub = module.get_submodule(prefix)
    sub.load_state_dict({**sub.state_dict(), **state}, strict=True)


@register_model("gru_ctc")
class GRUCTC(ConvCTC):
    module_cls = GRUCTCModule
    moe_capable = False

    def __init__(self, module: nn.Module, configs: Config):
        super().__init__(module, configs)
        self.frozen_components = ()

    def load_splayer(self, pkg: dict) -> None:
        """Warm-start the WavConv from a CPC package (its `splayer`
        weights and running statistics) and freeze it."""
        load_component(self.module, "splayer", pkg, "splayer")
        self.frozen_components = ("splayer",)

    def fc_component_names(self) -> tuple:
        return ("fc",)
