"""Microbenchmark: the flash attention kernels against SDPA, across (B, T).

Counterpart of tools/bench_flash.py, importing nothing of the JAX package:

    python -m openasr_torch.bin.bench_flash [--device cuda|cpu]

The same shapes (bench_flash.py:137-138), H 8, Dh 64, bf16, causal with
key lengths drawn in [T / 2, T], and `BENCH_FLASH_DROPOUT` as there.  Each
timed function is a chain of 32 attention calls, each output fed into the
next query (bench_flash.py:66-90), forward alone and forward + backward.
The yardstick in place of XLA's dense attention is the library call of
PERF.md's kernel table: `scaled_dot_product_attention` with a bool mask of
causal and key < length (built once a chain).

Time is device time: the summed device-lane spans of 4 chains under
`torch.profiler` (utils/trace.py), divided by the attention calls; with no
wall-clock fallback.  Before a row is printed, the kernel chain's output
(and, for forward + backward, its gradient) must lie within `TOL` (bf16)
of the same function's: SDPA's chain, or with dropout, which SDPA draws
at random, the plain version's with the kernel's hash mask.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from openasr_torch.bin.infer import resolve_device
from openasr_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from openasr_torch.utils import trace

H, DH = 8, 64
DTYPE = torch.bfloat16
CHAIN = 32  # attention calls a chain
CHAINS = 4  # chains a timing
SEED = 12345  # the dropout hash seed
TOL = 2e-2
SHAPES = [(8, 128), (8, 256), (64, 128), (64, 256), (64, 512), (16, 2048)]


def dropout_rate() -> float:
    return float(os.environ.get("BENCH_FLASH_DROPOUT", "0"))


class Attention(NamedTuple):
    """`prepare(q, lens)` once a chain, then `call(acc, prepared, rate)`."""

    prepare: Callable
    call: Callable


def _flash(acc, lens, rate):
    return flash_attention(acc, acc, acc, kv_lengths=lens, causal=True, dropout_rate=rate,
                           dropout_seed=SEED if rate > 0 else None)[0]


def _plain(acc, lens, rate):
    return flash_attention_reference(acc, acc, acc, kv_lengths=lens, causal=True,
                                     dropout_rate=rate, dropout_seed=SEED)[0]


def sdpa_mask(q, lens):
    """[B, 1, T, T] bool: key <= query and key < length."""
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    return ((pos[None, :] <= pos[:, None])[None, None]
            & (pos[None, None, None, :] < lens.to(q.device)[:, None, None, None]))


def _sdpa(acc, mask, rate):
    x = acc.transpose(1, 2)
    return F.scaled_dot_product_attention(x, x, x, attn_mask=mask, dropout_p=rate).transpose(1, 2)


FLASH = Attention(lambda q, lens: lens, _flash)
PLAIN = Attention(lambda q, lens: lens, _plain)
SDPA = Attention(sdpa_mask, _sdpa)


def _chain(attn: Attention, q, lens, rate):
    prepared = attn.prepare(q, lens)
    acc = q
    for _ in range(CHAIN):
        out = attn.call(acc, prepared, rate)
        # keep magnitudes bounded so the chain doesn't overflow
        acc = (acc + out.to(acc.dtype)) * 0.5
    return acc


def chained(attn: Attention, rate: float = 0.0) -> Callable:
    """(q, lens) -> the chain's output."""
    @torch.no_grad()
    def run(q, lens):
        return _chain(attn, q, lens, rate)
    return run


def chained_grad(attn: Attention, rate: float = 0.0) -> Callable:
    """(q, lens) -> the gradient of the chain's summed output in q."""
    def run(q, lens):
        x = q.detach().requires_grad_(True)
        _chain(attn, x, lens, rate).float().sum().backward()
        return x.grad
    return run


def device_us(fn, args, device: torch.device) -> float:
    """Device us an attention call of `fn(*args)`, from the device lane of
    CHAINS calls after the profiler's warm-up call (utils/trace.py)."""
    lane = trace.collect_device_events(lambda: fn(*args), "bench_flash_trace_", device.type,
                                       steps=CHAINS)
    return trace.sum_span_us(trace.dedupe(lane)) / (CHAINS * CHAIN)


def scaled_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def bench_shape(b: int, t: int, device: torch.device, rng: np.random.RandomState,
                rate: float) -> dict:
    """One row: the chains checked, then timed."""
    q = torch.from_numpy(rng.randn(b, t, H, DH) * 0.1).to(device, DTYPE)
    lens = torch.from_numpy(rng.randint(t // 2, t + 1, b).astype(np.int32)).to(device)
    args = (q, lens)
    same = SDPA if rate == 0 else PLAIN
    err_fwd = scaled_err(chained(FLASH, rate)(*args), chained(same, rate)(*args))
    err_grad = scaled_err(chained_grad(FLASH, rate)(*args), chained_grad(same, rate)(*args))
    if not (err_fwd <= TOL and err_grad <= TOL):
        raise RuntimeError(f"B {b} T {t}: the kernel chain is {err_fwd:.3g} (forward) / "
                           f"{err_grad:.3g} (gradient) off the "
                           f"{'SDPA' if rate == 0 else 'plain'} chain, over {TOL}")
    return {"b": b, "t": t, "err_fwd": err_fwd, "err_grad": err_grad,
            "flash_fwd": device_us(chained(FLASH, rate), args, device),
            "sdpa_fwd": device_us(chained(SDPA, rate), args, device),
            "flash_fb": device_us(chained_grad(FLASH, rate), args, device),
            "sdpa_fb": device_us(chained_grad(SDPA, rate), args, device)}


def run(shapes, device: torch.device) -> list:
    """The table over `shapes`, printed row by row; -> its rows."""
    rate = dropout_rate()
    rng = np.random.RandomState(0)
    print(f"{'B':>4} {'T':>6} | {'flash fwd':>10} {'sdpa fwd':>10} "
          f"{'ratio':>6} | {'flash f+b':>10} {'sdpa f+b':>10} {'ratio':>6}", flush=True)
    rows = []
    for b, t in shapes:
        r = bench_shape(b, t, device, rng, rate)
        print(f"{b:>4} {t:>6} | {r['flash_fwd']:>9.1f}u {r['sdpa_fwd']:>9.1f}u "
              f"{r['sdpa_fwd'] / r['flash_fwd']:>6.2f} | {r['flash_fb']:>9.1f}u "
              f"{r['sdpa_fb']:>9.1f}u {r['sdpa_fb'] / r['flash_fb']:>6.2f}", flush=True)
        rows.append(r)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(SHAPES, resolve_device(args.device))


if __name__ == "__main__":
    main()
