"""Config system: attribute-accessible nested dicts loaded from YAML.

Counterpart of openasr_tpu/config.py with the identical YAML schema
(`data / training / model`, model subsections `signal / encoder / decoder`),
its key-surface validation (`validate_config`, the same table of known
keys), the MoE checks it runs at load time (`validate_moe`, the same
messages) and `parse_range`.
"""

from __future__ import annotations

import copy
import difflib
import logging
import warnings
from typing import Any, Mapping, Sequence

import yaml


class Config(dict):
    """A dict with attribute access and recursive wrapping.

    Missing attribute access returns ``None`` (configs rely on optional
    keys being falsy when absent).
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        merged: dict = {}
        for a in args:
            if a is None:
                continue
            merged.update(a)
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            return None

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        """Plain nested dict (for serialization)."""
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(
                    x.to_dict() if isinstance(x, Config) else x for x in v
                )
            else:
                out[k] = v
        return out

    def override(self, other: Mapping | None) -> "Config":
        """Recursive update (infer-time config overrides)."""
        if not other:
            return self
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), Config):
                self[k].override(v)
            else:
                self[k] = v
        return self


# --------------------------------------------------------------- validation
#
# Unknown keys warn with a did-you-mean hint (a typo would otherwise train
# with a default silently); missing required keys raise at load time.

_KNOWN_KEYS: dict = {
    "": {"data", "model", "training"},
    "data": {
        "trainset", "devset", "vocab_path", "vocab_phone", "vocab_char",
        "feat_range", "label_range", "fetchworker_num", "acousticset",
        "unpaired_phone", "unpaired_text",
    },
    "training": {
        "label_type", "batch_frames", "batch_time", "batch_phones",
        "batch_size", "unpaired_batch_size", "exp_dir", "print_inteval",
        "num_epoch", "accumulate_grad_batch", "init_lr", "optimtype",
        "grad_max_norm", "label_smooth", "num_last_ckpt_keep",
        "lambda_ctc", "lambda_qua", "lambda_gp", "lr_scheduler",
        "compute_dtype", "adam_mu_dtype", "adam_nu_dtype", "fused_adam",
        "skip_nonfinite_grads", "zero1", "sequence_parallel",
        "pipeline_microbatch",
        "pretrained_model", "load_splayer", "G_path", "maxlen", "multi",
        "tensorboard", "profile",
    },
    "training.lr_scheduler": {
        "type", "warmup_step", "d_model", "x0", "y0", "x1", "y1",
        "decay_coef", "tolerate",
    },
    "model": {
        "type", "add_eos", "add_blk", "phone_size", "signal", "encoder",
        "decoder", "assigner", "cpc", "G", "D",
        # train_cpc's `sp` alias for `signal`; LM configs are flat at the
        # model level (bin/train_lm.py)
        "sp", "vocab_size", "d_model", "n_layers", "num_layers", "nhead",
        "dim_feedforward", "activation", "dropout_rate",
    },
    "model.signal": {
        "feature_type", "sample_rate", "num_mel_bins", "use_energy",
        "dither", "spec_aug", "d_model",
    },
    "model.signal.spec_aug": {
        "freq_mask_num", "freq_mask_width", "time_mask_num",
        "time_mask_width",
    },
    "model.encoder": {
        "type", "sub", "input_dim", "d_input", "d_model", "nhead",
        "dim_feedforward", "activation", "num_layers", "n_layers",
        "dropout_rate", "dropout", "remat", "pipeline", "vocab_size",
        "conv_dim", "freeze_finetune_updates", "subsample", "context_width",
        "streaming", "moe",
    },
    "model.encoder.sub": {"type", "layer_num"},
    "model.encoder.streaming": {"chunk", "left_chunks"},
    "model.encoder.moe": {
        "num_experts", "top_k", "capacity_factor", "every", "aux_weight",
        "router",
    },
    "model.decoder": {
        "type", "vocab_size", "d_model", "nhead", "num_layers",
        "encoder_dim", "dim_feedforward", "activation", "dropout_rate",
        "remat",
        # Embed_Decoder_CTC's 'decoder' section IS an encoder stack
        # (reference naming, Text_Models.py:117-124) and may carry moe;
        # validate_moe rejects it for every other model type
        "moe", "input_dim", "sub",
    },
    "model.assigner": {"type", "d_model", "n_layers", "w_context", "dropout"},
    "model.cpc": {"d_input", "d_coding", "n_layers", "n_steps"},
}
# the Embed_Decoder_CTC stack lives under 'decoder' and may carry moe;
# give the nested block the same schema so typos warn there too
_KNOWN_KEYS["model.decoder.moe"] = _KNOWN_KEYS["model.encoder.moe"]
# G/D reuse the encoder/decoder schemas
_KNOWN_KEYS["model.G"] = {"encoder", "decoder"}
_KNOWN_KEYS["model.D"] = {"encoder"}
_KNOWN_KEYS["model.G.encoder"] = _KNOWN_KEYS["model.encoder"]
_KNOWN_KEYS["model.G.decoder"] = _KNOWN_KEYS["model.decoder"]
_KNOWN_KEYS["model.G.encoder.moe"] = _KNOWN_KEYS["model.encoder.moe"]
_KNOWN_KEYS["model.G.decoder.moe"] = _KNOWN_KEYS["model.encoder.moe"]
# the discriminator front is a strided-conv stack, not a transformer
_KNOWN_KEYS["model.D.encoder"] = {"d_input", "d_model", "layer_num"}


def validate_moe(model_cfg: Mapping) -> None:
    """Load-time checks of every `moe` block (encoder, decoder, G.encoder,
    G.decoder), raising ValueError: the model type must collect the
    routers' auxiliary from that section (`Framework.moe_capable` and
    `moe_section`); num_experts present (0 runs dense, with a warning);
    1 <= every <= num_layers (else no layer would be MoE); top_k >= 1;
    capacity_factor > 0; the activation and the router ones
    models/moe.py implements."""
    from openasr_torch.models.moe import MoEFeedForward

    model_cfg = model_cfg or {}
    sections = (
        ("encoder", model_cfg.get("encoder")),
        ("decoder", model_cfg.get("decoder")),
        ("G.encoder", (model_cfg.get("G") or {}).get("encoder")),
        # the GAN generator's 'decoder' section builds its encoder stack
        ("G.decoder", (model_cfg.get("G") or {}).get("decoder")),
    )
    for section, enc in sections:
        enc = enc if isinstance(enc, Mapping) else {}
        moe = enc.get("moe") or {}
        if not moe:
            continue
        prefix = f"model.{section}"
        path = f"{prefix}.moe"
        num = int(moe.get("num_experts", 0) or 0)
        if num < 1:
            if "num_experts" in moe:
                warnings.warn(
                    f"config: {path}.num_experts="
                    f"{moe.get('num_experts')!r} disables MoE — the "
                    f"model runs dense FFNs; remove the moe section to "
                    f"silence this"
                )
                continue
            raise ValueError(
                f"config: {path} is missing num_experts (>= 1 enables "
                f"MoE, 0 runs dense); got keys {sorted(moe)}"
            )
        mtype = model_cfg.get("type")
        if mtype is not None:
            from openasr_torch.models import get_model_class

            cls = get_model_class(str(mtype))
            capable = (getattr(cls, "moe_capable", False)
                       and getattr(cls, "moe_section", "encoder") == section)
            if not capable:
                options = sorted(_moe_capable_types())
                raise ValueError(
                    f"config: {path} is not supported for model type "
                    f"{mtype!r}: this family would never collect the MoE "
                    f"router's load-balance auxiliary from that section, "
                    f"so the router would silently train unbalanced "
                    f"(expert collapse with no error). MoE-capable "
                    f"(type, section) pairs: {options}"
                )
        every = int(moe.get("every", 2) or 0)
        if every < 1:
            raise ValueError(f"config: {path}.every must be >= 1 (got {moe.get('every')!r})")
        num_layers = enc.get("num_layers")
        if num_layers is not None and every > int(num_layers):
            raise ValueError(
                f"config: {path}.every={every} exceeds "
                f"{prefix}.num_layers={num_layers}: no layer index i "
                f"satisfies i % every == every - 1, so the model would "
                f"have ZERO MoE layers while the config claims MoE is on"
            )
        if int(moe.get("top_k", 2) or 0) < 1:
            raise ValueError(f"config: {path}.top_k must be >= 1 (got {moe.get('top_k')!r})")
        if float(moe.get("capacity_factor", 1.25) or 0.0) <= 0.0:
            raise ValueError(f"config: {path}.capacity_factor must be > 0 "
                             f"(got {moe.get('capacity_factor')!r})")
        act = enc.get("activation", "relu")
        if act not in MoEFeedForward.SUPPORTED_ACTIVATIONS:
            supported = "/".join(MoEFeedForward.SUPPORTED_ACTIVATIONS)
            raise ValueError(
                f"config: {prefix}.activation={act!r} has no MoE expert "
                f"implementation (MoEFeedForward supports {supported})"
            )
        router = moe.get("router", "topk")
        if router not in MoEFeedForward.SUPPORTED_ROUTERS:
            raise ValueError(
                f"config: {path}.router={router!r} unknown "
                f"(supported: {MoEFeedForward.SUPPORTED_ROUTERS})"
            )


def _moe_capable_types() -> list:
    """(type, section) pairs whose losses collect the MoE auxiliary."""
    from openasr_torch.models import MODEL_REGISTRY, get_model_class

    get_model_class("conv-ctc")  # fills the registry
    return [(name, getattr(cls, "moe_section", "encoder"))
            for name, cls in MODEL_REGISTRY.items() if getattr(cls, "moe_capable", False)]


def validate_config(config: Mapping, required: Sequence[str] = ()) -> list:
    """Warn on keys outside the known surface (returned as dotted paths);
    run `validate_moe` on the model section; raise ValueError naming the
    first missing `required` dotted path."""
    unknown = []

    def walk(section: Mapping, path: str) -> None:
        known = _KNOWN_KEYS.get(path)
        if known is None:
            return
        for k, v in section.items():
            full = f"{path}.{k}" if path else str(k)
            if k not in known:
                hint = difflib.get_close_matches(str(k), known, n=1)
                msg = f"config: unrecognized key '{full}'"
                if hint:
                    msg += f" — did you mean '{hint[0]}'?"
                logging.warning(msg)
                unknown.append(full)
            elif isinstance(v, Mapping):
                walk(v, full)

    walk(config, "")
    validate_moe(config.get("model") or {})
    for path in required:
        node: Any = config
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                raise ValueError(
                    f"config: required key '{path}' is missing (stuck at '{part}')"
                )
            node = node[part]
    return unknown


def parse_range(value: Any) -> tuple | None:
    """Parse ranges such as feat_range: "1,1000" (or a 2-list)."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        lo, hi = value
        return int(lo), int(hi)
    parts = str(value).split(",")
    return int(parts[0]), int(parts[1])


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Config(raw or {})
