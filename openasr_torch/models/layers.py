"""Transformer building blocks, post-LN, with a KV-cached decode step.

Counterpart of openasr_tpu/models/layers.py.  Parameters live in PyTorch's
layouts (nn.Linear weight [out, in]); module and parameter names mirror
the flax tree (`self_attn.q`, `ffn.linear1`, `norm1`, ...) so that
openasr_torch/convert.py maps one onto the other leaf by leaf.

Positional encoding keeps the JAX package's double scaling:
`positional_encoding` multiplies its input by sqrt(d_model) and the
decoder pre-scales its embeddings by sqrt(d_model) too.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openasr_torch.kernels.flash_attention import flash_attention
from openasr_torch.kernels.layer_norm import fused_layer_norm


class LayerNorm(nn.Module):
    """f32 statistics with var = E[x^2] - E[x]^2, eps 1e-6, output in the
    input's dtype (not nn.LayerNorm: eps 1e-5, two-pass variance).
    `weight`/`bias` stay f32 whatever the model's compute dtype.  Every row
    count goes through `fused_layer_norm` (the kernel on the card)."""

    def __init__(self, d: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _, _ = fused_layer_norm(x, self.weight, self.bias, self.epsilon)
        return y


@lru_cache(maxsize=8)
def _pe_table(d_model: int, max_len: int) -> np.ndarray:
    """Sin/cos table [max_len, d_model]."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32)
        * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@lru_cache(maxsize=8)
def _pe_on(d_model: int, max_len: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_pe_table(d_model, max_len)).to(device)


def positional_encoding(
    x: torch.Tensor, max_len: int = 5000, offset: int = 0
) -> torch.Tensor:
    """x * sqrt(d) + PE[offset : offset + T]."""
    d_model = x.shape[-1]
    t = x.shape[-2]
    pe = _pe_on(d_model, max_len, x.device)[offset: offset + t]
    return x * (d_model ** 0.5) + pe.to(x.dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Dense attention for the decode step: q [B,Tq,H,D], k/v [B,Tk,H,D],
    bias [B|1, 1|H, Tq, Tk] -> [B,Tq,H,D].  Scores and softmax in f32
    whatever q's dtype; P.V in q's dtype."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(depth)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections.  The structured call (`kv_lengths`
    and/or `causal`) goes through the flash-attention wrapper; the decode
    step's `attend_step` attends densely against cached K/V."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H*D] -> [B, T, H, D] (a view)."""
        return x.view(*x.shape[:-1], self.nhead, self.head_dim)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x.reshape(*x.shape[:-2], -1))

    def forward(
        self,
        inputs_q: torch.Tensor,
        inputs_kv: torch.Tensor,
        kv_lengths: Optional[torch.Tensor] = None,
        causal: bool = False,
    ) -> torch.Tensor:
        q = self._heads(self.q(inputs_q))
        k, v = self.project_kv(inputs_kv)
        out, _ = flash_attention(q, k, v, kv_lengths=kv_lengths, causal=causal)
        return self._merge(out)

    def project_kv(self, inputs_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V [B, T, H, D] (the cross-attention cache for decoding)."""
        return self._heads(self.k(inputs_kv)), self._heads(self.v(inputs_kv))

    def attend_step(
        self,
        x_t: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Single-query attention against precomputed K/V.
        x_t [B, 1, D_in]; k/v [B, Tk, H, D]."""
        q = self._heads(self.q(x_t))
        return self._merge(dot_product_attention(q, k, v, bias))

    def append_kv(self, x_t: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, index: int) -> None:
        """Write this step's K/V into the caches at `index`, IN PLACE (the
        JAX package returns updated copies; here the caches are owned by
        the decode loop, so writing in place saves a cache copy a step)."""
        k_t, v_t = self.project_kv(x_t)
        cache_k[:, index: index + 1] = k_t
        cache_v[:, index: index + 1] = v_t


class FeedForward(nn.Module):
    """Position-wise FFN with relu / gelu (exact) / glu (glu doubles
    linear1's width and gates with a sigmoid)."""

    def __init__(self, d_model: int, dim_feedforward: int, activation: str = "relu"):
        super().__init__()
        if activation not in ("relu", "gelu", "glu"):
            raise ValueError(f"Unknown activation {activation}")
        self.activation = activation
        width = 2 * dim_feedforward if activation == "glu" else dim_feedforward
        self.linear1 = nn.Linear(d_model, width)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear1(x)
        if self.activation == "relu":
            h = F.relu(h)
        elif self.activation == "gelu":
            h = F.gelu(h)
        else:
            a, b = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
        return self.linear2(h)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = norm1(x + attn(x)); norm2(x + ffn(x))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, dim_feedforward, activation)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                kv_lengths: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, x, kv_lengths, causal))
        return self.norm2(x + self.ffn(x))


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer with self + cross attention, plus a KV-cached
    `step` for one-token-at-a-time decoding."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu"):
        super().__init__()
        self.nhead = nhead
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, dim_feedforward, activation)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_lengths: Optional[torch.Tensor] = None,
                tgt_causal: bool = True) -> torch.Tensor:
        x = self.norm1(tgt + self.self_attn(tgt, tgt, causal=tgt_causal))
        x = self.norm2(x + self.cross_attn(x, memory, kv_lengths=memory_lengths))
        return self.norm3(x + self.ffn(x))

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor) -> dict:
        """Growing self-attn K/V (zeros) plus precomputed cross-attn K/V."""
        mem_k, mem_v = self.cross_attn.project_kv(memory)
        shape = (batch, max_len, self.nhead, mem_k.shape[-1])
        return {
            "k": memory.new_zeros(shape),
            "v": memory.new_zeros(shape),
            "mem_k": mem_k,
            "mem_v": mem_v,
        }

    def step(self, x_t: torch.Tensor, cache: dict, index: int,
             self_bias_t: Optional[torch.Tensor] = None,
             memory_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step: x_t [B, 1, D] -> [B, 1, D]; writes this step's
        K/V into `cache` in place."""
        self.self_attn.append_kv(x_t, cache["k"], cache["v"], index)
        sa = self.self_attn.attend_step(x_t, cache["k"], cache["v"], self_bias_t)
        x = self.norm1(x_t + sa)
        ca = self.cross_attn.attend_step(x, cache["mem_k"], cache["mem_v"], memory_bias)
        x = self.norm2(x + ca)
        return self.norm3(x + self.ffn(x))
