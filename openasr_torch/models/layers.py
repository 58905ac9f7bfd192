"""Transformer building blocks, post-LN, with a KV-cached decode step.

Counterpart of openasr_tpu/models/layers.py.  Parameters live in PyTorch's
layouts (nn.Linear weight [out, in]); module and parameter names mirror
the flax tree (`self_attn.q`, `ffn.linear1`, `norm1`, ...) so that
openasr_torch/convert.py maps one onto the other leaf by leaf.

Positional encoding keeps the JAX package's double scaling:
`positional_encoding` multiplies its input by sqrt(d_model) and the
decoder pre-scales its embeddings by sqrt(d_model) too.

Training mode is the `rng` argument (a `TrainRNG`), as `deterministic=False`
plus the `dropout` rng are in the JAX package: with it, residual, FFN and
embedding dropouts draw their masks from `rng.device` and the attention
dropout its hash seed from `rng.host` (`TrainRNG.attention_seed`);
without it every layer is deterministic.  The modules' train()/eval()
flag plays no part.

Tensor parallelism (parallel/tensor_parallel.py): a module's `tp` is None
on one rank, else the model group's `TensorParallel`, set by
`shard_module` with the parameters cut to this rank's shards.  The
attention then holds H / M local heads (the flash kernels run on
[B, T, H / M, Dh]) and the FFN F / M columns; each gathers its input
(`tp.enter`) and reduces its row-parallel product (`tp.leave`).  A layer
called with `sharded` (its stack's `time_shards`) holds T / M rows of
the residual stream: its residual adds, dropouts and LayerNorms run on
them (the LayerNorm's backward in the kernel's dx-only mode, its scale's
and bias's gradients partial over the model group), the JAX package's
`shard_time` sites.  Element-wise dropout draws its mask at the global
shape from a generator that the model group shares and keeps this
rank's rows or columns, so that it does not depend on M.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from openasr_torch.kernels.flash_attention import (
    attention_dropout_mask,
    draw_dropout_seed,
    flash_attention,
)
from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_bwd
from openasr_torch.ops.masks import (
    ChunkMask,
    causal_bias,
    chunk_bias,
    combine_bias,
    padding_bias,
)
from openasr_torch.parallel.mesh import SHARD_SEED_MULT, partition_seed, rand_rows, shard_id
from openasr_torch.parallel.tensor_parallel import (
    reduce_from_model,
    time_shards,
    to_shards,
    to_whole,
)


class TrainRNG:
    """The random streams of one training forward: `host`, a CPU generator
    (attention-dropout seeds, and the per-row draws: SpecAugment, CIF's
    quantity noise, the GAN's penalty alpha, CPC's anchor), and `device`, a
    generator on the compute device (dropout masks, dither).  `reseed`
    restarts both, so a step's randomness depends on its seed alone (the
    JAX solver folds the step into its key the same way).

    Rank `rank` of `world` data-parallel ranks (the grid's data index and
    size) draws the per-row values for the global batch and keeps its rows
    (`rand_rows`), so they are the one-process run's; its element-wise
    device draws are its data shard's (the same on every rank of its model
    group), its attention dropout seed its (data, model) shard's
    (`partition_seed(seed, shard_id(rank, model_rank, model_world))`, as
    the JAX kernels'), rank 0's unchanged."""

    def __init__(self, seed: int, device, rank: int = 0, world: int = 1,
                 model_rank: int = 0, model_world: int = 1) -> None:
        self.host = torch.Generator()
        self.device = torch.Generator(device=torch.device(device))
        self.rank, self.world = rank, world
        self.model_rank, self.model_world = model_rank, model_world
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        self.host.manual_seed(int(seed))
        self.device.manual_seed(((int(seed) ^ 0x5DEECE66D) + self.rank * SHARD_SEED_MULT)
                                & 0xFFFFFFFFFFFFFFFF)

    def rand_rows(self, shape, dim: int = 0) -> torch.Tensor:
        """Host uniforms of `shape`, this rank's rows (at `dim`) of one draw
        for the global batch."""
        return rand_rows(self.host, shape, dim, self.rank, self.world)

    def attention_seed(self) -> int:
        """One dropping attention call's hash seed, this rank's shard's."""
        return partition_seed(draw_dropout_seed(self.host),
                              shard_id(self.rank, self.model_rank, self.model_world))

    def fork(self) -> "TrainRNG":
        """A new pair of generators at this one's shard coordinates (to be
        reseeded)."""
        return TrainRNG(0, self.device.device, self.rank, self.world, self.model_rank,
                        self.model_world)


def rematerialized(fn, rng: Optional[TrainRNG], /, *args, **kwargs):
    """fn(*args, **kwargs) under `torch.utils.checkpoint`: its activations
    are recomputed in the backward.  `preserve_rng_state` restores only
    torch's default generators, so the recompute replays `rng`'s (the
    host's and the device's states at the call), and the forward's masks
    and attention seeds come back; the generators are left as the forward
    left them."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if rng is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
    at_call = (rng.host.get_state(), rng.device.get_state())
    runs = []

    def replay(*a, **k):
        if not runs:
            runs.append(1)
            return fn(*a, **k)
        now = (rng.host.get_state(), rng.device.get_state())
        rng.host.set_state(at_call[0])
        rng.device.set_state(at_call[1])
        try:
            return fn(*a, **k)
        finally:
            rng.host.set_state(now[0])
            rng.device.set_state(now[1])

    return checkpoint(replay, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def run_layers(layers, x: torch.Tensor, *args, final_norm=None, remat: bool = False,
               **kwargs) -> torch.Tensor:
    """x through a stack of encoder or decoder layers (then `final_norm`),
    each called as layer(x, *args, **kwargs), with `remat` each under
    `rematerialized` (the JAX package's per-layer `nn.remat`).  Under
    tensor parallelism (the layers' `tp`) the stack holds this rank's
    T-shard of x where `time_shards` allows, and returns the whole
    output."""
    tp = layers[0].tp if layers else None

    def call(layer, x, **extra):
        if remat:
            return rematerialized(layer, kwargs.get("rng"), x, *args, **kwargs, **extra)
        return layer(x, *args, **kwargs, **extra)

    if tp is None:
        for layer in layers:
            x = call(layer, x)
        return x if final_norm is None else final_norm(x)
    sharded = time_shards(x, tp)
    x = to_shards(x, tp, sharded)
    for layer in layers:
        x = call(layer, x, sharded=sharded)
    if final_norm is not None:
        x = final_norm(x, sharded)
    return to_whole(x, tp, sharded)


def _time_shard(tp, sharded: bool) -> Optional[tuple]:
    """`dropout`'s shard of a T-sharded residual stream (dim 1), or None."""
    return (1, tp.group.rank, tp.size) if sharded else None


def any_empty(lengths, empty_rows: Optional[bool] = None) -> bool:
    """`empty_rows` when the caller knows it from the host's lengths, else
    whether some entry of `lengths` is <= 0, read back from its device."""
    if empty_rows is not None:
        return empty_rows
    return bool((lengths <= 0).any())


def dropout(x: torch.Tensor, rate: float, rng: Optional[TrainRNG],
            shard: Optional[tuple] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate and scale the kept
    values by 1 / (1 - rate); the identity without `rng` or at rate 0.
    `shard` = (dim, rank, size): x is shard `rank` of `size` equal ones
    along `dim` of the tensor whose mask is drawn."""
    if rng is None or rate <= 0.0:
        return x
    if shard is None:
        keep = torch.rand(x.shape, generator=rng.device, device=x.device)
    else:
        dim, rank, size = shard
        whole = list(x.shape)
        k = whole[dim]
        whole[dim] = k * size
        keep = torch.rand(whole, generator=rng.device, device=x.device).narrow(dim, rank * k, k)
    keep = keep >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def activation_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype activations run in: autocast's when it is on for x's
    device (bf16 training keeps f32 weights), else x's own."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def autocast_off(device_type: str):
    """A context with autocast off for `device_type`, entered only where
    autocast is on: a traced program (serving.py) then holds no empty
    autocast region."""
    if torch.is_autocast_enabled(device_type):
        return torch.autocast(device_type, enabled=False)
    return contextlib.nullcontext()


class _LayerNormRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = torch.ops.openasr.layer_norm_fwd(x, scale, bias, float(eps))
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx, _, _ = layer_norm_bwd(x, dy, scale, mean, rstd, dgamma_dbeta=False)
        d = x.shape[-1]
        dyf = dy.float().reshape(-1, d)
        xhat = (x.float().reshape(-1, d) - mean.reshape(-1, 1)) * rstd.reshape(-1, 1)
        return dx, (dyf * xhat).sum(0), dyf.sum(0), None


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """`fused_layer_norm`'s y on rows that are one shard of a
    sequence-parallel site: the forward operator, and a backward in the
    backward operator's dx-only mode (the JAX package's `_bwd_dx_kernel`,
    its SPMD path) with dgamma and dbeta as f32 column sums of dy * xhat
    and dy over these rows alone, outside the kernel, as the JAX package
    computes them (openasr_tpu/kernels/layer_norm.py:196-199); the caller
    sums them over the model group."""
    return _LayerNormRows.apply(x, scale, bias, eps)


class LayerNorm(nn.Module):
    """f32 statistics with var = E[x^2] - E[x]^2, eps 1e-6, output in the
    input's dtype (not nn.LayerNorm: eps 1e-5, two-pass variance).
    `weight`/`bias` stay f32 whatever the model's compute dtype.  Every row
    count goes through `fused_layer_norm` (the kernel on the card); with
    `sharded` (this rank's T-shard of a sequence-parallel site) through
    `layer_norm_rows`, whose scale and bias gradients are partial over the
    model group."""

    tp = None

    def __init__(self, d: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor, sharded: bool = False) -> torch.Tensor:
        if sharded:
            return layer_norm_rows(x, self.tp.partial(self.weight), self.tp.partial(self.bias),
                                   self.epsilon)
        y, _, _ = fused_layer_norm(x, self.weight, self.bias, self.epsilon)
        return y


class Embedding(nn.Embedding):
    """nn.Embedding, vocab-parallel under tensor parallelism: this rank's
    rows [lo, lo + k) of the table (lo = rank * ceil(V / M)), a masked
    lookup and an all-reduce over the model group."""

    tp = None

    def vocab_start(self) -> int:
        return 0 if self.tp is None else self.tp.group.rank * -(-self.num_embeddings
                                                                // self.tp.size)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return super().forward(ids)
        lo, k = self.vocab_start(), self.weight.shape[0]
        local = ids - lo
        inside = (local >= 0) & (local < k)
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        return reduce_from_model(rows * inside[..., None].to(rows.dtype), self.tp.group)


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
    keep: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Dense attention: q [B,Tq,H,D], k/v [B,Tk,H,D], bias [B|1, 1|H, Tq, Tk]
    -> [B,Tq,H,D].  Scores and softmax in f32 whatever q's dtype; P.V in
    q's dtype.  `keep` [B, H, Tq, Tk] drops weights as dropout does."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(depth)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _empty_rows_dense(out, q, k, v, kv_lengths, causal, dropout_rate, seed,
                      chunk_mask=None):
    """Batch rows with no valid key (kv_length <= 0) take the JAX package's
    dense-path value, which the flash kernel (O = 0 there) does not give:
    softmax(scores + NEG_INF) in f32, which is the mean of V over all Tk
    keys where |scores| < 32 and is skewed toward the largest scores where
    the f32 sum rounds them to different multiples of 64.  The dense
    attention runs on those rows only, with the hash dropout mask of the
    flash call, and autograd carries its gradient into q, k and v as JAX's
    autodiff of the dense path does.  Finding the rows reads them back to
    the host, so callers run this only for a batch known to hold one.
    Under a streaming encoder's `chunk_mask` the bias adds the chunk mask,
    as the JAX package's combined bias does."""
    idx = (kv_lengths <= 0).nonzero()[:, 0].to(out.device)
    bias = combine_bias(
        padding_bias(kv_lengths[idx].to(out.device), k.shape[1]),
        causal_bias(q.shape[1], out.device) if causal else None,
        None if chunk_mask is None else chunk_bias(q.shape[1], *chunk_mask,
                                                   device=out.device),
    )
    keep = None
    if dropout_rate > 0.0:
        b, tq, h, _ = q.shape
        keep = attention_dropout_mask(seed, b, h, tq, k.shape[1], dropout_rate,
                                      out.device)[idx]
    dense = dot_product_attention(q[idx], k[idx], v[idx], bias, keep, dropout_rate)
    return out.index_put((idx,), dense.to(out.dtype))


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections.  The structured call (`kv_lengths`
    and/or `causal`, or a streaming encoder's `chunk_mask`) goes through
    the flash-attention wrapper, with
    attention dropout when given an rng; the decode step's `attend_step`
    attends densely against cached K/V.

    `empty_rows` says that some kv_length may be <= 0.  The caller decides
    it once per forward (see `any_empty`), so a batch without such a row
    reads nothing back from the card.  With it, the empty rows take the
    JAX dense path's value at every length: the JAX package attends densely
    on the CPU, and on a TPU below its 384-frame flash crossover, while its
    TPU flash route gives O = 0 from 384 up; the port keeps no TPU length
    routing.

    Under tensor parallelism (`tp`) the call holds this rank's heads; it
    gathers `inputs_q` (`tp.enter`, T-shards where `sharded`), attends,
    and returns the `out` product reduced to T-shards or to the whole
    activation.  `inputs_kv`, where it is not `inputs_q` (the decoder's
    memory), is whole and entered by the caller (`copy_to_model`)."""

    tp = None

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by nhead {nhead}")
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.head_dim = d_model // nhead
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H*D] -> [B, T, H, D] (a view; H this rank's heads)."""
        return x.view(*x.shape[:-1], x.shape[-1] // self.head_dim, self.head_dim)

    def _merge(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x.reshape(*x.shape[:-2], -1))

    def forward(
        self,
        inputs_q: torch.Tensor,
        inputs_kv: torch.Tensor,
        kv_lengths: Optional[torch.Tensor] = None,
        causal: bool = False,
        rng: Optional[TrainRNG] = None,
        empty_rows: bool = False,
        chunk_mask: Optional[ChunkMask] = None,
        sharded: bool = False,
    ) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            same = inputs_kv is inputs_q
            inputs_q = tp.enter(inputs_q, sharded)
            inputs_kv = inputs_q if same else inputs_kv
        q = self._heads(self.q(inputs_q))
        k, v = self.project_kv(inputs_kv)
        rate = self.dropout_rate if rng is not None and self.dropout_rate > 0.0 else 0.0
        seed = rng.attention_seed() if rate else 0
        out, _ = flash_attention(q, k, v, kv_lengths=kv_lengths, causal=causal,
                                 dropout_rate=rate, dropout_seed=seed, chunk_mask=chunk_mask)
        if empty_rows and kv_lengths is not None:
            out = _empty_rows_dense(out, q, k, v, kv_lengths, causal, rate, seed, chunk_mask)
        if tp is None:
            return self._merge(out)
        y = F.linear(out.reshape(*out.shape[:-2], -1), self.out.weight)
        return tp.leave(y, self.out.bias, sharded)

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
    linear1's width and gates with a sigmoid).  Under tensor parallelism
    (`tp`) this rank holds F / M columns (of each GLU half) and reduces
    `linear2`'s partial product as the attention reduces `out`."""

    tp = None

    def __init__(self, d_model: int, dim_feedforward: int, activation: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        if activation not in ("relu", "gelu", "glu"):
            raise ValueError(f"Unknown activation {activation}")
        self.activation = activation
        self.dropout_rate = dropout_rate
        width = 2 * dim_feedforward if activation == "glu" else dim_feedforward
        self.linear1 = nn.Linear(d_model, width)
        self.linear2 = nn.Linear(dim_feedforward, d_model)

    def forward(self, x: torch.Tensor, rng: Optional[TrainRNG] = None,
                sharded: bool = False) -> torch.Tensor:
        tp = self.tp
        if tp is not None:
            x = tp.enter(x, sharded)
        h = self.linear1(x)
        if self.activation == "relu":
            h = F.relu(h)
        elif self.activation == "gelu":
            h = F.gelu(h)
        else:
            a, b = h.chunk(2, dim=-1)
            h = a * torch.sigmoid(b)
        if tp is None:
            return self.linear2(dropout(h, self.dropout_rate, rng))
        h = dropout(h, self.dropout_rate, rng, (h.dim() - 1, tp.group.rank, tp.size))
        return tp.leave(F.linear(h, self.linear2.weight), self.linear2.bias, sharded)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = norm1(x + drop(attn(x)));
    norm2(x + drop(ffn(x))).  With `moe_experts` > 0 the FFN is a routed
    mixture of experts (models/moe.py), `moe_ffn`, which takes the valid
    frames (arange(T) < kv_lengths) as its padding mask when the layer
    has key lengths; its auxiliary goes to the loss through the module's
    `aux_sink` (models/__init__.py:Framework.forward_with_moe_aux).
    `sharded`: x is this rank's T-shard (see the module docstring)."""

    tp = None

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 moe_experts: int = 0, moe_top_k: int = 2, moe_capacity: float = 1.25,
                 moe_router: str = "topk"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout_rate)
        self.moe_ffn = self.ffn = None
        if moe_experts > 0:
            from openasr_torch.models.moe import MoEFeedForward

            self.moe_ffn = MoEFeedForward(d_model, dim_feedforward, moe_experts, moe_top_k,
                                          moe_capacity, activation, dropout_rate, moe_router)
        else:
            self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout_rate)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def _ffn(self, x: torch.Tensor, kv_lengths: Optional[torch.Tensor] = None,
             rng: Optional[TrainRNG] = None, sharded: bool = False) -> torch.Tensor:
        if self.moe_ffn is None:
            return self.ffn(x, rng, sharded)
        pad = None
        if kv_lengths is not None:
            t = x.shape[1] * (self.tp.size if sharded else 1)
            pad = (torch.arange(t, device=x.device)[None, :]
                   < kv_lengths.to(x.device)[:, None])
        return self.moe_ffn(x, rng, pad, sharded)

    def forward(self, x: torch.Tensor,
                kv_lengths: Optional[torch.Tensor] = None,
                causal: bool = False,
                rng: Optional[TrainRNG] = None,
                empty_rows: bool = False,
                chunk_mask: Optional[ChunkMask] = None,
                sharded: bool = False) -> torch.Tensor:
        shard = _time_shard(self.tp, sharded)
        attn = self.self_attn(x, x, kv_lengths, causal, rng, empty_rows, chunk_mask, sharded)
        x = self.norm1(x + dropout(attn, self.dropout_rate, rng, shard), sharded)
        ff = self._ffn(x, kv_lengths, rng, sharded)
        return self.norm2(x + dropout(ff, self.dropout_rate, rng, shard), sharded)

    def attend_cached(self, x: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                      key_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The deterministic layer on queries x [B, T, D] against keys and
        values k_all / v_all [B, Tk, H, Dh] that already hold x's own, under
        key_bias [B, 1, 1, Tk]: dense attention (`attend_step`), norm1, the
        FFN and norm2."""
        x = self.norm1(x + self.self_attn.attend_step(x, k_all, v_all, key_bias))
        return self.norm2(x + self._ffn(x))

    def chunk_step(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                   key_bias: Optional[torch.Tensor]):
        """One chunk through the layer, deterministic: x [B, ch, D] attends
        to [cache_k/v ++ its own K/V] ([B, L, H, Dh] then [B, ch, H, Dh])
        under key_bias [B, 1, 1, L + ch], which masks the invalid cache
        slots.  -> (out [B, ch, D], k_cur, v_cur [B, ch, H, Dh]); the caller
        keeps the cache."""
        k_cur, v_cur = self.self_attn.project_kv(x)
        out = self.attend_cached(x, torch.cat([cache_k, k_cur], dim=1),
                                 torch.cat([cache_v, v_cur], dim=1), key_bias)
        return out, k_cur, v_cur


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer with self + cross attention, plus a KV-cached
    `step` for one-token-at-a-time decoding.  Under tensor parallelism the
    memory is whole and entered by the decoder (`copy_to_model`), and
    `sharded` puts the residual stream on T-shards as in the encoder
    layer."""

    tp = None

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "relu", dropout_rate: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout_rate)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout_rate)
        self.ffn = FeedForward(d_model, dim_feedforward, activation, dropout_rate)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_lengths: Optional[torch.Tensor] = None,
                tgt_causal: bool = True,
                rng: Optional[TrainRNG] = None,
                empty_rows: bool = False, sharded: bool = False) -> torch.Tensor:
        """`empty_rows`: some memory length may be <= 0."""
        rate = self.dropout_rate
        shard = _time_shard(self.tp, sharded)
        sa = self.self_attn(tgt, tgt, causal=tgt_causal, rng=rng, sharded=sharded)
        x = self.norm1(tgt + dropout(sa, rate, rng, shard), sharded)
        ca = self.cross_attn(x, memory, kv_lengths=memory_lengths, rng=rng,
                             empty_rows=empty_rows, sharded=sharded)
        x = self.norm2(x + dropout(ca, rate, rng, shard), sharded)
        return self.norm3(x + dropout(self.ffn(x, rng, sharded), rate, rng, shard), sharded)

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
