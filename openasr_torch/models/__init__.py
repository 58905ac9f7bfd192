"""Model frameworks: an nn.Module + its configs + packaging.

Counterpart of openasr_tpu/models/__init__.py.  A Framework owns the
module, builds it from the YAML config sections (`create_model`) and
reads/writes checkpoint packages in the JAX package's layout
(`restore` / `package`, through openasr_torch/convert.py), so one package
file serves both implementations.
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from openasr_torch.config import Config
from openasr_torch.parallel.mesh import DataGroup

# Config keys tolerated to differ between a checkpoint and the current model.
VOLATILE_CONFIG_KEYS = {"dropout_rate", "spec_aug", "dither", "dropout"}

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(name: str):
    def wrap(cls):
        cls.model_type = name
        MODEL_REGISTRY[name] = cls
        return cls

    return wrap


def _normalize(name: str) -> str:
    return name.lower().replace("-", "_")


# other spellings of a model type
_MODEL_ALIASES = {"cpc_model": "encoder_cpc"}


def get_model_class(name: str) -> type:
    """Resolve a model type, case-insensitive over '-'/'_'."""
    import openasr_torch.models.cif  # noqa: F401  (fills the registry)
    import openasr_torch.models.cpc  # noqa: F401
    import openasr_torch.models.gan  # noqa: F401
    import openasr_torch.models.lm  # noqa: F401
    import openasr_torch.models.speech  # noqa: F401
    import openasr_torch.models.text  # noqa: F401
    import openasr_torch.models.wav2vec  # noqa: F401

    by_norm = {_normalize(k): k for k in MODEL_REGISTRY}
    norm = _MODEL_ALIASES.get(_normalize(name), _normalize(name))
    if norm in by_norm:
        return MODEL_REGISTRY[by_norm[norm]]
    raise ValueError(
        f"Unknown model type {name!r}; the port has {sorted(MODEL_REGISTRY)}, "
        "every type of the JAX package"
    )


def _check_config_compat(name: str, current: dict, saved: dict) -> None:
    for key, value in (current or {}).items():
        if key in VOLATILE_CONFIG_KEYS:
            continue
        if isinstance(value, dict):
            _check_config_compat(f"{name}.{key}", value, (saved or {}).get(key) or {})
            continue
        if saved is None or saved.get(key) != value:
            raise ValueError(
                f"{name} config mismatch on {key!r}: "
                f"current={value!r} saved={(saved or {}).get(key)!r}"
            )


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], by the inverse CDF."""
    lo, hi = ((1.0 + math.erf(z / math.sqrt(2.0))) / 2.0 for z in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float32) * (hi - lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator` (a CPU generator; no global
    RNG) with the JAX package's initializers: LayerNorm and BatchNorm
    scales 1, biases 0 (and BatchNorm's running mean 0 and variance 1),
    convolution kernels and layers marked `kernel_init = "lecun_normal"`
    flax's default lecun_normal (a normal truncated at two standard
    deviations, variance 1 / fan_in), `"kaiming_normal"` the same at
    variance 2 / fan_in, layers marked `"xavier_normal"` the
    same truncated normal at variance 2 / (fan_in + fan_out), layers
    marked `"orthogonal"` flax's orthogonal init (the Q of a normal
    matrix's QR, its columns' signs fixed by R's diagonal), and
    `"orthogonal_gates"` that per block of a gate-stacked weight,
    `"xavier_uniform_stacked"` flax's Xavier-uniform over a stack of
    matrices [S, in, out] (fans in * S and out * S: the MoE expert tables),
    `"zeros"` zero, other weights Xavier-uniform.  A module's
    `param_inits` marks its own parameters by name."""
    from openasr_torch.models.frontend import BatchNorm
    from openasr_torch.models.layers import LayerNorm

    norms = {id(m.weight) for m in module.modules() if isinstance(m, (LayerNorm, BatchNorm))}
    inits = {id(m.weight): "lecun_normal" for m in module.modules()
             if isinstance(m, (nn.Conv1d, nn.Conv2d))}
    inits.update({id(m.weight): m.kernel_init for m in module.modules()
                  if getattr(m, "kernel_init", None)})
    for m in module.modules():
        inits.update({id(getattr(m, n)): kind for n, kind in getattr(m, "param_inits", {}).items()})

    def orthogonal(rows, cols):
        normal = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
        q, r = torch.linalg.qr(normal)
        q = q * torch.sign(torch.diagonal(r))
        return q if rows >= cols else q.T

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.reset_running_stats()
        for name, p in module.named_parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif name.endswith("bias") or p.dim() < 2 or inits.get(id(p)) == "zeros":
                p.zero_()
            elif inits.get(id(p)) == "orthogonal":
                p.copy_(orthogonal(*p.shape))
            elif inits.get(id(p)) == "orthogonal_gates":
                rows, cols = p.shape[0] // 3, p.shape[1]
                p.copy_(torch.cat([orthogonal(rows, cols) for _ in range(3)]))
            elif inits.get(id(p)) == "xavier_uniform_stacked":
                stack = math.prod(p.shape[:-2])
                bound = (6.0 / (stack * (p.shape[-2] + p.shape[-1]))) ** 0.5
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_(u * (2 * bound) - bound)
            elif id(p) in inits:
                fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
                var = {"lecun_normal": 1.0 / fan_in, "kaiming_normal": 2.0 / fan_in}.get(
                    inits[id(p)], 2.0 / (fan_in + fan_out))
                # flax divides by the truncated normal's standard deviation
                std = math.sqrt(var) / 0.87962566103423978
                p.copy_(_truncated_normal(p.shape, generator) * std)
            else:
                fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(p)
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_(u * (2 * bound) - bound)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the module to `dtype` for inference, keeping in f32 the LayerNorm
    and BatchNorm parameters and running statistics (the norms compute
    their statistics in f32 either way), the decoders' and LMs'
    `out_bias` (added to f32 logits), the CTC and phone heads and the MoE
    routers (f32 as in the JAX package).  Training keeps every weight
    f32 and runs bf16 under autocast instead."""
    from openasr_torch.models.frontend import BatchNorm
    from openasr_torch.models.layers import LayerNorm

    module.to(dtype)
    for name, m in module.named_modules():
        if (isinstance(m, (LayerNorm, BatchNorm)) or name in ("ctc_fc", "fc", "phone_fc")
                or name.endswith("moe_ffn.router")):
            m.float()
    for name, p in module.named_parameters():
        if name.split(".")[-1] == "out_bias":
            p.data = p.data.float()
    return module


class Framework:
    """Base: owns module + configs.

    `moe_capable` families add the MoE routers' load-balance auxiliary to
    their losses (`forward_with_moe_aux`); every other family refuses a
    `moe` section at construction, since a router whose balance loss is
    dropped trains toward expert collapse with no diagnostic.
    `moe_section` names the config section the family's MoE encoder is
    built from ("decoder" for Embed_Decoder_CTC)."""

    model_type: str = "base"
    moe_capable: bool = False
    moe_section: str = "encoder"

    def __init__(self, module: nn.Module, configs: Config):
        self.module = module
        self.configs = configs if isinstance(configs, Config) else Config(configs)
        expected = type(self).moe_section if type(self).moe_capable else None
        stray = [s for s in self._moe_sections_present() if s != expected]
        if stray:
            raise ValueError(
                f"moe is not supported in config section(s) {stray} for "
                f"model type {self.model_type!r}: "
                + (
                    f"this family reads its MoE config from {expected!r} only."
                    if expected
                    else "its loss path does not collect the MoE "
                    "router's load-balance auxiliary (the router would "
                    "silently train unbalanced). Remove the moe section "
                    "or use an MoE-capable model type."
                )
            )

    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        raise NotImplementedError

    @classmethod
    def create_model(cls, configs, device="cuda", dtype=torch.float32,
                     generator: Optional[torch.Generator] = None):
        """Build the module on `device` in `dtype`, parameters drawn from
        `generator` (default: a CPU generator seeded 0), in eval mode."""
        configs = Config(configs)
        with torch.device("meta"):
            module = cls.build_module(configs)
        module = module.to_empty(device=device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(module, generator)
        set_compute_dtype(module, dtype)
        return cls(module.eval(), configs)

    # ------------------------------------------------------------ data axis

    data_group = DataGroup.single()  # the data axis (openasr_torch/parallel) it trains over
    tp = None  # the model axis's TensorParallel (parallel/tensor_parallel.py), when above 1
    tp_specs: dict = {}

    def set_model_group(self, group, sequence_parallel: bool = True) -> dict:
        """Train over the model axis of `group` (tensor parallelism, with
        sequence parallelism when `sequence_parallel`): the rule table's
        parameters cut to this rank's shards.  Returns their specs by name
        (none at a model size of 1)."""
        if group.world == 1:
            return {}
        from openasr_torch.parallel.tensor_parallel import TensorParallel, shard_module

        self.tp = TensorParallel(group, sequence_parallel)
        self.tp_specs = shard_module(self.module, self.tp)
        return self.tp_specs

    def full_tables(self):
        """A context within which every model-sharded parameter is whole
        (gathered over the model group; a collective)."""
        import contextlib

        if self.tp is None:
            return contextlib.nullcontext()
        from openasr_torch.parallel.tensor_parallel import full_tables

        return full_tables(self.module, self.tp_specs, self.tp.group)

    def set_pipe_group(self, group) -> frozenset:
        """Train over the pipe axis of `group` (GPipe): every stacked
        encoder (`encoder.pipeline`) keeps only this rank's stage of its
        layers.  Returns the names of the stage's parameters (none at a
        pipe size of 1)."""
        if group.world == 1:
            return frozenset()
        from openasr_torch.models.encoder import PipelinedEncoderStack

        stacks = {n: m for n, m in self.module.named_modules()
                  if isinstance(m, PipelinedEncoderStack)}
        if not stacks:
            raise ValueError(
                f"a pipe group of {group.world} stages needs the stacked layer layout: set "
                "encoder.pipeline: true in the model config")
        for stack in stacks.values():
            stack.set_stage(group.rank, group.world)
        self.pipe_group = group
        return frozenset(f"{n}.{p}" for n, m in stacks.items()
                         for p, _ in m.named_parameters())

    pipe_group = None  # the pipe axis's DataGroup, when above 1

    def full_stacks(self):
        """A context within which every stacked encoder holds all its
        layers (every stage's gathered over the pipe group, after the model
        group's `full_tables`; a collective)."""
        import contextlib

        if self.pipe_group is None:
            return contextlib.nullcontext()
        from openasr_torch.parallel.pipeline import full_stacks

        return full_stacks(self.module, self.pipe_group)

    def set_data_group(self, group) -> frozenset:
        """Train over the data axis of `group`: BatchNorm statistics, the MoE
        auxiliary and CPC's draws over the global batch, and, where the
        world size divides a layer's num_experts, expert parallelism.
        Returns the names of the parameters that became this rank's expert
        tables."""
        from openasr_torch.models.frontend import BatchNorm
        from openasr_torch.models.moe import MoEFeedForward

        self.data_group = group
        experts = []
        for name, m in self.module.named_modules():
            if isinstance(m, BatchNorm):
                m.group = group
            elif isinstance(m, MoEFeedForward):
                m.group = group
                if group.world > 1 and m.num_experts % group.world == 0:
                    experts += [f"{name}.{t}" for t in m.shard_experts(group)]
        return frozenset(experts)

    # ------------------------------------------------------------ MoE

    def _moe_sections_present(self) -> list:
        """The config sections with a configured moe block (num_experts >
        0), scanned in full: encoder, decoder, G.encoder and G.decoder
        (the GAN generator's stack)."""
        cfg = self.configs.to_dict()
        found = []
        for name, sub in (
            ("encoder", cfg.get("encoder")),
            ("decoder", cfg.get("decoder")),
            ("G.encoder", (cfg.get("G") or {}).get("encoder")),
            ("G.decoder", (cfg.get("G") or {}).get("decoder")),
        ):
            moe = ((sub or {}) if isinstance(sub, dict) else {}).get("moe") or {}
            if int(moe.get("num_experts", 0) or 0) > 0:
                found.append(name)
        return found

    def moe_config(self) -> Optional[dict]:
        """The family's moe section (from `moe_section`) when MoE layers
        are configured, else None."""
        enc = self.configs.to_dict().get(type(self).moe_section) or {}
        moe = (enc.get("moe") or {}) if isinstance(enc, dict) else {}
        return moe if int(moe.get("num_experts", 0) or 0) > 0 else None

    def forward_with_moe_aux(self, *args, **kwargs):
        """self.module(*args, **kwargs) -> (outputs, weighted auxiliary):
        None without MoE layers, else `moe.aux_weight` (default 0.01) times
        the mean of the MoE layers' auxiliaries (0 when no layer gives one:
        expert_choice), for the solver to add to its objective.  The layers
        write into a list of this call (their `aux_sink`), reset after it."""
        from openasr_torch.models.moe import MoEFeedForward

        moe = self.moe_config()
        if moe is None:
            return self.module(*args, **kwargs), None
        layers = [m for m in self.module.modules() if isinstance(m, MoEFeedForward)]
        sink: list = []
        for m in layers:
            m.aux_sink = sink
        try:
            out = self.module(*args, **kwargs)
        finally:
            for m in layers:
                m.aux_sink = None
        aux = (sum(sink) / len(sink) if sink
               else torch.zeros((), device=next(self.module.parameters()).device))
        return out, float(moe.get("aux_weight", 0.01)) * aux

    # ------------------------------------------------------------ packaging

    def package(self) -> dict:
        """Checkpoint package in the JAX layout: model type + configs +
        per-component states as f32 NumPy, and for a model with BatchNorm
        its running statistics as `batch_stats`."""
        from openasr_torch.convert import is_batch_stat, state_dict_to_jax_components

        state = self.module.state_dict()
        pkg = {
            "model_type": self.model_type,
            "configs": self.configs.to_dict(),
            "components": state_dict_to_jax_components(
                self.model_type, {k: v for k, v in state.items() if not is_batch_stat(k)},
                self.configs),
        }
        stats = {k: v for k, v in state.items() if is_batch_stat(k)}
        if stats:
            pkg["batch_stats"] = state_dict_to_jax_components(self.model_type, stats,
                                                               self.configs)
        return pkg

    def restore(self, pkg: dict, without_fc: bool = False) -> None:
        """Load a JAX-layout package after validating config compatibility.
        `without_fc` keeps the current output layers
        (`fc_component_names`) for transfer learning.  The package's
        `batch_stats`, where it has them, replace the running statistics."""
        from openasr_torch.convert import is_batch_stat, jax_components_to_state_dict

        saved_cfg = pkg.get("configs", {})
        for section, cfg in self.configs.to_dict().items():
            if isinstance(cfg, dict):
                _check_config_compat(section, cfg, saved_cfg.get(section))
        components = {
            k: v for k, v in pkg["components"].items()
            if not (without_fc and k in self.fc_component_names())
        }
        state = jax_components_to_state_dict(self.model_type, components,
                                             partial=without_fc, configs=self.configs)
        if pkg.get("batch_stats") is not None:
            state.update(jax_components_to_state_dict(
                self.model_type, pkg["batch_stats"], partial=True, configs=self.configs))
        current = self.module.state_dict()
        state = {**{k: v for k, v in current.items() if without_fc or is_batch_stat(k)},
                 **state}
        self.module.load_state_dict(state, strict=True)

    def fc_component_names(self) -> tuple:
        """The output layers that `restore(without_fc=True)` keeps fresh."""
        return ("decoder", "fc", "ctc_fc")

    def batch_inputs(self, batch: dict):
        """The model's inputs of a collated batch: waves and sample counts
        for an fbank frontend, else features and frame counts."""
        if self.configs.signal and self.configs.signal.get("feature_type") == "fbank":
            return batch["waves"], batch["wave_lengths"]
        if "feats" in batch:
            return batch["feats"], batch["feat_lengths"]
        return batch["waves"], batch["wave_lengths"]

    @torch.inference_mode()
    def attention_maps(self, batch: dict, average_heads: bool = False) -> dict:
        """Attention distributions of a deterministic forward of `batch`
        (tensors on the model's device), as {module_path: [B, H, Tq, Tk]
        f32}, or [B, Tq, Tk] averaged over heads with `average_heads`,
        under the JAX package's module paths (`encoder/layer0/self_attn`;
        a module called k > 1 times gets `#0` ... `#k-1`).

        The forward runs as always, through the flash kernel on the card,
        which never materialises the probabilities.  So, as the JAX package
        does, each attention's probabilities are computed on the plain
        path from its inputs: softmax(q k^T / sqrt(d) + padding and
        causal biases) in f32.  Not on the train or decode path."""
        from openasr_torch.models.layers import MultiHeadAttention
        from openasr_torch.ops.masks import causal_bias, combine_bias, padding_bias

        calls: Dict[str, list] = {}

        def capture(path):
            def hook(module, args, kwargs, _out):
                bound = inspect.signature(module.forward).bind(*args, **kwargs)
                bound.apply_defaults()
                a = bound.arguments
                q = module._heads(module.q(a["inputs_q"]))
                k, _ = module.project_kv(a["inputs_kv"])
                lengths = a["kv_lengths"]
                bias = combine_bias(
                    padding_bias(lengths, k.shape[1]) if lengths is not None else None,
                    causal_bias(q.shape[1], q.device) if a["causal"] else None,
                )
                scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                scores = scores / math.sqrt(q.shape[-1])
                if bias is not None:
                    scores = scores + bias
                probs = torch.softmax(scores, dim=-1)
                calls.setdefault(path, []).append(probs.mean(dim=1) if average_heads else probs)
            return hook

        handles = [
            m.register_forward_hook(capture(name.replace(".", "/")), with_kwargs=True)
            for name, m in self.module.named_modules() if isinstance(m, MultiHeadAttention)
        ]
        try:
            inputs, lengths = self.batch_inputs(batch)
            if hasattr(self.module, "decoder"):
                self.module(inputs, lengths, batch["ids"])
            else:
                self.module(inputs, lengths)
        finally:
            for h in handles:
                h.remove()
        maps = {}
        for path, found in calls.items():
            for i, probs in enumerate(found):
                maps[path if len(found) == 1 else f"{path}#{i}"] = probs
        return maps

    def has_empty_rows(self, input_lengths) -> bool:
        """Whether an utterance of the host's (NumPy) `input_lengths` (as
        `batch_inputs` gives them: samples for an fbank frontend, frames
        offline) subsamples to no encoder frame: the `empty_rows` the
        forwards take, so that they read nothing back from the card for
        it."""
        lengths = self.module.encoder_lengths(np.asarray(input_lengths))
        return bool((lengths <= 0).any())
