"""Language models: the LSTM LM and the Transformer LM, for training and
for shallow fusion in the beams.

Counterpart of openasr_tpu/models/lm.py.  Both LMs tie the output affine
to the embedding (logits = x E^T + out_bias) and keep the flax parameter
tree's names (`emb`, `cells_{i}` or `layer{i}`, and a bare `out_bias`),
so that openasr_torch/convert.py maps a JAX-written LM package onto them.

- `LSTMLMModule`: embedding -> n LSTM layers -> tied output, with dropout
  after the embedding, between layers and after the stack.  Each layer
  holds flax `OptimizedLSTMCell`'s parameters exactly: input kernels
  `ii/if/ig/io` without a bias, hidden kernels `hi/hf/hg/ho` with one
  (no second bias, as torch's nn.LSTM would add), carry (c, h).  A layer
  runs one input product over all steps, then one hidden product a step.
- `TransformerLMModule`: the causal post-LN encoder stack.  The embedding
  is scaled by sqrt(d) twice, once here and once in `positional_encoding`,
  as in the JAX package; the training loss passes no lengths (the padded
  tail is masked only in the loss).  On the card each layer's attention
  and LayerNorms go through the flash and LayerNorm kernels.

`step` is one token of a beam: the LSTM's carries, or the Transformer's
KV cache with a position per row (each row its own positional encoding,
key mask and write slot: the device CTC beam mixes rows at different
positions in one call).  The Transformer's step writes each layer's K/V
into the cache in place and returns the cache with the positions
advanced; its cache has one slot more than `max_len`, where a row at
`max_len` writes the K/V it attends to and that nothing reads again (the
JAX step drops that write).  `make_lm_step_spec` and `make_lm_fusion`
build the step and the cache for any beam.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.config import Config
from openasr_torch.models import Framework, register_model
from openasr_torch.models.layers import (
    TrainRNG,
    TransformerEncoderLayer,
    _pe_on,
    dropout,
    positional_encoding,
)
from openasr_torch.ops.losses import cal_ce_loss

LM_TYPES = ("lstm_lm", "transformer_lm")
PE_ROWS = 5000


def lm_hparams(model_type: str, configs) -> dict:
    """The LM's hyper-parameters from its config (the model section, or a
    whole config holding one), with `create_model`'s defaults."""
    m = configs.get("model") or configs
    d = int(m["d_model"])
    if model_type == "lstm_lm":
        return {"vocab_size": int(m["vocab_size"]), "d_model": d,
                "n_layers": int(m.get("n_layers", 2)),
                "dropout_rate": float(m.get("dropout_rate", 0.0))}
    return {"vocab_size": int(m["vocab_size"]), "d_model": d,
            "nhead": int(m.get("nhead", 8)), "num_layers": int(m.get("num_layers", 6)),
            "dim_feedforward": int(m.get("dim_feedforward", 4 * d)),
            "dropout_rate": float(m.get("dropout_rate", 0.1)),
            "activation": m.get("activation", "relu")}


def lm_components(model_type: str, configs) -> tuple:
    """The package components of an LM, which depend on its depth."""
    h = lm_hparams(model_type, configs)
    if model_type == "lstm_lm":
        layers = tuple(f"cells_{i}" for i in range(h["n_layers"]))
    else:
        layers = tuple(f"layer{i}" for i in range(h["num_layers"]))
    return ("emb",) + layers + ("out_bias",)


class _TiedOutput(nn.Module):
    """The embedding and the tied output affine of both LMs."""

    def _init_tied(self, vocab_size: int, d_model: int) -> None:
        self.emb = nn.Embedding(vocab_size, d_model)
        self.emb.kernel_init = "xavier_normal"
        self.out_bias = nn.Parameter(torch.zeros(vocab_size))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x E^T + out_bias, in f32."""
        return (x @ self.emb.weight.t()).float() + self.out_bias


class LSTMCell(nn.Module):
    """flax OptimizedLSTMCell's parameters and math: gates i, f, g, o =
    x W_i* + h W_h* + b_h*; c' = sig(f) c + sig(i) tanh(g); h' = sig(o)
    tanh(c')."""

    def __init__(self, d: int):
        super().__init__()
        for gate in "ifgo":
            inp, hid = nn.Linear(d, d, bias=False), nn.Linear(d, d)
            inp.kernel_init, hid.kernel_init = "lecun_normal", "orthogonal"
            self.add_module(f"i{gate}", inp)
            self.add_module(f"h{gate}", hid)

    def _stacked(self, prefix: str) -> torch.Tensor:
        return torch.cat([getattr(self, prefix + g).weight for g in "ifgo"])

    def input_product(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., D] -> its four input gates' products [..., 4D]."""
        return F.linear(x, self._stacked("i"))

    def hidden_affine(self):
        """The four hidden kernels [4D, D] and biases [4D], stacked."""
        return self._stacked("h"), torch.cat([getattr(self, "h" + g).bias for g in "ifgo"])

    def cell(self, xi: torch.Tensor, carry, hidden):
        """One step from the input products xi [B, 4D], the carry (c, h)
        and `hidden_affine()`."""
        c, h = carry
        gates = F.linear(h, *hidden) + xi
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The layer over a sequence x [B, T, D] from zero carries."""
        xi, hidden = self.input_product(x), self.hidden_affine()
        zeros = x.new_zeros(x.shape[0], x.shape[-1])
        carry, outs = (zeros, zeros), []
        for t in range(x.shape[1]):
            carry, h = self.cell(xi[:, t], carry, hidden)
            outs.append(h)
        return torch.stack(outs, dim=1)


class LSTMLMModule(_TiedOutput):
    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self._init_tied(vocab_size, d_model)
        for i in range(n_layers):
            self.add_module(f"cells_{i}", LSTMCell(d_model))
        self.n_layers = n_layers

    @property
    def cells(self):
        return [getattr(self, f"cells_{i}") for i in range(self.n_layers)]

    def forward(self, ids: torch.Tensor, rng: Optional[TrainRNG] = None) -> torch.Tensor:
        rate = self.dropout_rate
        x = dropout(self.emb(ids.long()), rate, rng)
        for i, cell in enumerate(self.cells):
            x = cell(x)
            if i < self.n_layers - 1:
                x = dropout(x, rate, rng)
        return self.logits(dropout(x, rate, rng))

    def step(self, tokens: torch.Tensor, carries):
        """tokens [B] + per-layer carries -> (log-probs [B, V] f32, carries)."""
        x = self.emb(tokens.long())
        new = []
        for cell, carry in zip(self.cells, carries):
            carry, x = cell.cell(cell.input_product(x), carry, cell.hidden_affine())
            new.append(carry)
        return torch.log_softmax(self.logits(x), dim=-1), new

    def init_carries(self, batch: int):
        w = self.emb.weight
        zeros = torch.zeros((batch, self.d_model), dtype=w.dtype, device=w.device)
        return [(zeros, zeros) for _ in range(self.n_layers)]


class TransformerLMModule(_TiedOutput):
    def __init__(self, vocab_size: int, d_model: int, nhead: int, num_layers: int,
                 dim_feedforward: int, dropout_rate: float = 0.1, activation: str = "relu"):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self._init_tied(vocab_size, d_model)
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, activation, dropout_rate))

    @property
    def layers(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, ids: torch.Tensor, rng: Optional[TrainRNG] = None) -> torch.Tensor:
        """ids [B, T] -> logits [B, T, V] f32, causal, no key lengths."""
        x = positional_encoding(self.emb(ids.long()) * math.sqrt(self.d_model))
        x = dropout(x, self.dropout_rate, rng)
        for layer in self.layers:
            x = layer(x, None, causal=True, rng=rng)
        return self.logits(x)

    def init_step_cache(self, batch: int, max_len: int = 512) -> dict:
        """Per-layer K/V [B, max_len + 1, H, Dh] and each row's position
        `idx` [B], for `step`."""
        if max_len > PE_ROWS:
            raise ValueError(
                f"TransformerLM.init_step_cache: max_len={max_len} exceeds the "
                f"{PE_ROWS}-row positional-encoding table; decode in windows below it "
                "(the batch forward has the same bound)")
        w = self.emb.weight
        shape = (batch, max_len + 1, self.nhead, self.d_model // self.nhead)
        return {
            "idx": torch.zeros((batch,), dtype=torch.long, device=w.device),
            "layers": [{"k": torch.zeros(shape, dtype=w.dtype, device=w.device),
                        "v": torch.zeros(shape, dtype=w.dtype, device=w.device)}
                       for _ in range(self.num_layers)],
        }

    def step(self, tokens: torch.Tensor, cache: dict):
        """tokens [B] + cache -> (log-probs [B, V] f32, cache with idx + 1).
        Row b's token takes position idx[b] (its positional encoding), writes
        its K/V into slot min(idx[b], max_len) in place and attends to the
        slots up to that one: the causal batch forward's row idx[b]."""
        idx = cache["idx"]
        n_slots = cache["layers"][0]["k"].shape[1]
        d = self.d_model
        x = self.emb(tokens.long())[:, None, :] * math.sqrt(d)
        pe = _pe_on(d, PE_ROWS, x.device)[idx.clamp(0, PE_ROWS - 1)].to(x.dtype)
        x = x * (d ** 0.5) + pe[:, None, :]
        slot = idx.clamp(max=n_slots - 1)
        visible = torch.arange(n_slots, device=x.device)[None, :] <= slot[:, None]
        key_bias = torch.where(visible, 0.0, -1e9)[:, None, None, :]
        rows = torch.arange(x.shape[0], device=x.device)
        for layer, lc in zip(self.layers, cache["layers"]):
            k_cur, v_cur = layer.self_attn.project_kv(x)
            lc["k"][rows, slot] = k_cur[:, 0].to(lc["k"].dtype)
            lc["v"][rows, slot] = v_cur[:, 0].to(lc["v"].dtype)
            x = layer.attend_cached(x, lc["k"], lc["v"], key_bias)
        log_probs = torch.log_softmax(self.logits(x[:, 0]), dim=-1)
        return log_probs, {"idx": idx + 1, "layers": cache["layers"]}


class _LMFramework(Framework):
    """The LMs' loss over text batches (ids, labels, paddings) and
    perplexity.  Their config is the model section itself (or a config
    holding one)."""

    @classmethod
    def build_module(cls, configs: Config) -> nn.Module:
        h = lm_hparams(cls.model_type, configs)
        if cls.model_type == "lstm_lm":
            return LSTMLMModule(**h)
        return TransformerLMModule(**h)

    def loss(self, batch: dict, rng: Optional[TrainRNG] = None,
             label_smooth: float = 0.0, empty_rows: Optional[bool] = None) -> dict:
        """{ce_loss, n_tokens, n_seqs}; `rng` makes it the train forward."""
        del empty_rows
        logits = self.module(batch["ids"], rng)
        return {
            "ce_loss": cal_ce_loss(logits, batch["labels"], batch["paddings"], label_smooth),
            "n_tokens": (1.0 - batch["paddings"].float()).sum(),
            "n_seqs": torch.tensor(float(batch["ids"].shape[0]), device=batch["ids"].device),
        }

    @torch.no_grad()
    def perplexity(self, batch: dict) -> float:
        losses = self.loss(batch)
        return float(torch.exp(losses["ce_loss"] / losses["n_tokens"].clamp(min=1.0)))

    def batch_inputs(self, batch: dict):
        """A text batch's inputs: its ids, and no lengths."""
        return batch["ids"], None

    def has_empty_rows(self, input_lengths) -> bool:
        return False


@register_model("lstm_lm")
class LSTMLM(_LMFramework):
    pass


@register_model("transformer_lm")
class TransformerLM(_LMFramework):
    pass


def make_lm_step_spec(lm) -> dict:
    """{step_fn (tokens [BB], cache) -> (log-probs [BB, V], cache),
    init_cache_fn (bb, max_tokens) -> cache}: the LM's step, and its cache
    for bb beam rows and up to max_tokens steps (the Transformer's K/V
    budget; the LSTM's carries take no size).  Build it once per LM."""
    module = lm.module if hasattr(lm, "module") else lm
    if isinstance(module, TransformerLMModule):
        return {"step_fn": module.step,
                "init_cache_fn": lambda bb, max_tokens: module.init_step_cache(
                    int(bb), int(max_tokens))}
    return {"step_fn": module.step,
            "init_cache_fn": lambda bb, max_tokens: module.init_carries(int(bb))}


def make_lm_fusion(lm, bb: int, max_len: int = 512):
    """(lm_step_fn, init_lm_cache) for shallow fusion over bb beam rows, or
    (None, None) without an LM; the cache holds `max_len` positions."""
    if lm is None:
        return None, None
    spec = make_lm_step_spec(lm)
    return spec["step_fn"], spec["init_cache_fn"](bb, max_len)
