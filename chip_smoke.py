#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
`openasr_torch/kernels/csrc/`, holds each kernel against its plain PyTorch
version on the card (LayerNorm forward and backward, also at D 1536, the
backward's dgamma and dbeta bit-identical over two runs; flash attention
forward and backward, with and without attention dropout, also at head
dims 16 and 48, which the wrappers zero-pad, with the hash mask's dropped
pairs kept; the fused fbank from strided waves and from dithered frames,
also at 32 kHz, nfft 400, VTLN 0.9 and 40 bins, each log-mel case also
against a float64 evaluation), trains two steps of
egs/aishell1/configs/conv-ctc-transformer-test.yaml (head dim 16), then
drives the port's main paths at the full width
of the flagship conv-ctc-transformer (egs/aishell1/configs/
conv-ctc-transformer.yaml: ConvV2, d512, 6+6 post-LN layers, 8 heads, GLU
2048, vocab 4233) with random weights from a fixed seed, in float32 and in
bfloat16:

- offline decoding: 8 random-feature utterances through
  `openasr_torch.bin.infer --offline`;
- offline training: one epoch plus the dev pass through
  `openasr_torch.bin.train` on 128 random-feature utterances of 400-512
  frames, with the flagship YAML's model and training sections as they are
  (dropout 0.1, SpecAugment, batch_frames 36000, clip 50, label smoothing
  0.1, lambda_ctc 1.0, Noam);
- online decoding: 8 random-tone 16 kHz wav files of 10.0-13.6 s through
  `openasr_torch.bin.infer` without `--offline` (the fbank frontend);
- online training: one epoch plus the dev pass on 128 wav files of
  4.0-5.2 s, with egs/aishell1/configs/conv-ctc-transformer-online.yaml
  (the flagship's sections with the fbank signal, batch_time 5760000).

Each path runs with the kernels' launch counters set to 0 just before it
and read just after.  The f32 decoder logits, one f32 training step's
gradients and the f32 fbank features are also checked against the same
inputs on the CPU.

It prints the card's name and power limit, a `{"kernels": [...]}` line
with each kernel's error, launches, times and bound (the attention
backward at each of the training step's three shapes: encoder
self-attention, decoder causal self-attention and cross-attention, and a
`[time]` line with their total a step), and last
`{"ok": true, "device": {...}}`.  Without a CUDA card it exits non-zero
and prints no result; every phase that fails ends the run the same way.
Scratch files go to `build/chip_smoke/` under the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
FLAGSHIP_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer.yaml")
ONLINE_YAML = os.path.join(ROOT, "egs", "aishell1", "configs",
                           "conv-ctc-transformer-online.yaml")
TEST_YAML = os.path.join(ROOT, "egs", "aishell1", "configs", "conv-ctc-transformer-test.yaml")
SEED = 1234

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit).
# Bounds take the rate of the type a function reads and writes; the fbank
# kernel computes in float64 (34 TFLOP/s), its own choice, reported apart
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.float64: 34e12}
# the attention kernels, forward and backward, compute f32 products on the
# tensor cores as 3xTF32, three TF32 products each (TF32: 495 TFLOP/s dense)
MMA_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
TOL_LN = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# backward: max abs error over max(1, largest plain magnitude).  f32 sums
# (dgamma over thousands of rows, dk/dv over queries) in other orders; in
# bf16 the outputs round to 8 bits and O, hence delta, differ by an ulp
TOL_LN_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_FLASH_BWD = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# log-mel, max abs.  The kernel computes the FFT in float64, the plain
# version the folded f32 products.  So the kernel is held against a
# float64 evaluation of the same function (`fbank_float64`), to TOL_FBANK_F64
# (a few f32 ulps at the features' magnitude of 16-32: 1.9e-6 measured on
# an H100) and no farther from it than the plain version, case by case.
# Kernel against plain is then held, case by case, to the plain version's
# own error against float64 plus TOL_FBANK_F64 (the triangle inequality's
# limit): the plain error reached 2.3e-3 on bins far below a frame's
# loudest (near silence, beside tones) on the VTLN training batch.  Card
# against CPU (the plain version on both): the CPU's GEMMs block the
# 400-term sums otherwise (8.2e-4 measured)
TOL_FBANK_F64 = 1e-5
TOL_FBANK_CPU = 2e-3
# where nfft is not a power of two the kernel sums the plain version's own
# folded f32 products, in other orders (1.9e-6 measured)
TOL_FBANK_FOLDED = 1e-4
# mel energies without the log (use_log_fbank false), max abs over the
# largest energy: 1e-4 on the log is 1e-4 relative on every energy
TOL_FBANK_REL = 1e-5
RATE = 16000
DROPOUT = 0.1
DROPOUT_SEED = 987654321
DTYPES = (torch.float32, torch.bfloat16)
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

FLAGSHIP = {
    "type": "conv-ctc-transformer",
    "add_eos": True,
    "add_blk": True,
    "signal": {"feature_type": "offline"},
    "encoder": {"type": "Transformer", "sub": {"type": "ConvV2", "layer_num": 2},
                "input_dim": 80, "d_model": 512, "nhead": 8,
                "dim_feedforward": 2048, "activation": "glu", "num_layers": 6,
                "dropout_rate": 0.1},
    "decoder": {"type": "TransformerDecoder", "vocab_size": 4233,
                "d_model": 512, "nhead": 8, "num_layers": 6, "encoder_dim": 512,
                "dim_feedforward": 2048, "activation": "glu", "dropout_rate": 0.1},
}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max abs difference, with +inf entries required to match exactly."""
    a, b = a.float(), b.float()
    inf_a, inf_b = torch.isinf(a), torch.isinf(b)
    if not torch.equal(inf_a, inf_b) or not torch.equal(a[inf_a], b[inf_b]):
        return float("inf")
    if bool(torch.isnan(a).any() or torch.isnan(b).any()):
        return float("nan")
    fin = ~inf_a
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def scaled_err(got: torch.Tensor, want: torch.Tensor):
    """-> (max abs error, max(1, largest magnitude of `want`))."""
    return max_err(got, want), max(1.0, float(want.float().abs().max()))


def note_err(errs, key, abs_err, scaled) -> None:
    """Keep a backward kernel's largest abs error and largest scaled one."""
    a, r = errs.get(key, (0.0, 0.0))
    errs[key] = (max(a, abs_err), max(r, scaled))


def device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call: `calls` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events, so no host work is timed.
    Inputs stay resident in the 50 MB L2 between calls (warm cache)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip()


def reset_counters():
    from openasr_torch.kernels.fbank import fused_fbank
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_bwd

    torch.cuda.synchronize()
    for fn, attr in ((fused_layer_norm, "launches"), (layer_norm_bwd, "launches"),
                     (layer_norm_bwd, "dx_launches"),
                     (flash_attention, "launches"), (flash_attention, "dropout_launches"),
                     (flash_attention_bwd_dkv, "launches"),
                     (flash_attention_bwd_dq, "launches"), (fused_fbank, "launches")):
        setattr(fn, attr, 0)


def read_counters() -> dict:
    from openasr_torch.kernels.fbank import fused_fbank
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_bwd

    torch.cuda.synchronize()
    return {
        "layer_norm_fwd": fused_layer_norm.launches,
        "layer_norm_bwd": layer_norm_bwd.launches,
        "layer_norm_bwd_dx": layer_norm_bwd.dx_launches,
        "flash_attention_fwd": flash_attention.launches,
        "flash_attention_fwd_dropout": flash_attention.dropout_launches,
        "flash_attention_bwd_dkv": flash_attention_bwd_dkv.launches,
        "flash_attention_bwd_dq": flash_attention_bwd_dq.launches,
        "fbank": fused_fbank.launches,
    }


# --------------------------------------------------------------- phase 1

def attention_ptxas(log: str) -> list:
    """(kernel, registers, spill bytes) of each instantiation of the
    attention kernels, forward and backward, from nvcc's -Xptxas -v output
    in a build log; spill bytes count stores and loads."""
    import re

    out = []
    for source in ("flash_attention.cu", "flash_attention_bwd.cu"):
        sec = log[log.index(f"== nvcc {source}"):]
        end = sec.find("== nvcc", 1)
        name, spill = None, 0
        for line in (sec if end < 0 else sec[:end]).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                d, drop = re.search(r"Li(\d+)ELb(\d)", fn).groups()
                kind = "fwd" if "_fwd_" in fn else "dkv" if "_dkv_" in fn else "dq"
                name = (f"{kind} {'bf16' if 'Bf16Ops' in fn else 'f32'} D{d}"
                        + (" dropout" if drop == "1" else ""))
            elif "spill stores" in line:
                spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
            elif "Used" in line and name:
                out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)),
                            spill))
                name = None
    return out


def ptxas_report(log: str, source: str) -> list:
    """(kernel, registers, spill bytes) of every entry function that nvcc's
    -Xptxas -v output lists for one source in a build log."""
    import re

    sec = log[log.index(f"== nvcc {source}"):]
    end = sec.find("== nvcc", 1)
    out, name, spill = [], None, 0
    for line in (sec if end < 0 else sec[:end]).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and name:
            out.append((name, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            name = None
    return out


def phase_build():
    from openasr_torch import kernels

    t0 = time.time()
    so = kernels.build_library()
    kernels.library()
    secs = time.time() - t0
    print(f"[build] {so.name} in {secs:.1f}s (sm_90a)")
    print(nvidia_smi())
    log = so.parent / so.name.replace("libopenasr_kernels-", "build-").replace(".so", ".log")
    report = attention_ptxas(log.read_text())
    print("[ptxas] attention registers (spill bytes): " + ", ".join(
        f"{n} {r} ({sp})" for n, r, sp in report))
    require(len(report) == 36, f"{len(report)} attention kernels in the build log, not 36")
    require(all(sp == 0 for _, _, sp in report), "an attention kernel spills registers")
    text = log.read_text()
    for source, keys in (("fbank.cu", ("fbank_fft", "fbank_folded")),
                         ("layer_norm.cu", ("layer_norm_bwd", "column_sum"))):
        rows = [(short_name(n), r, sp) for n, r, sp in ptxas_report(text, source)
                if any(k in n for k in keys)]
        print(f"[ptxas] {source} registers (spill bytes): " + ", ".join(
            f"{n} {r} ({sp})" for n, r, sp in rows))
        require(rows, f"no kernel of {source} in the build log")


def short_name(mangled: str) -> str:
    """kernel<template arguments> of a mangled kernel name: bf16 or f32,
    then its integer and bool arguments (VEC, NV, partials; R)."""
    import re

    name = re.search(r"(?<=\d)((?:layer_norm|fbank|column)_[a-z0-9_]*?kernel)(?=[IE])",
                     mangled).group(1)
    args = (["bf16"] if "nv_bfloat16" in mangled else ["f32"] if "IfL" in mangled else [])
    args += re.findall(r"L[ib](\d+)E", mangled)
    return name + (f"<{','.join(args)}>" if args else "")


# --------------------------------------------------------------- phase 2

def ln_inputs(n, d, dtype, rng):
    x = torch.from_numpy((rng.randn(n, d) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.randn(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(d)).astype(np.float32))
    return x.to("cuda", dtype), g.cuda(), b.cuda()


def phase_layer_norm(errs):
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

    rng = np.random.RandomState(SEED)
    for dtype in DTYPES:
        for n, d in ((2400, 512), (40, 512), (300, 1536)):
            x, g, b = ln_inputs(n, d, dtype, rng)
            y, mu, rs = fused_layer_norm(x, g, b)
            torch.cuda.synchronize()
            y_r, mu_r, rs_r = layer_norm_reference(x, g, b)
            e = max_err(y, y_r)
            e_stats = max(max_err(mu, mu_r), max_err(rs, rs_r))
            tol = TOL_LN[dtype]
            print(f"[layer_norm] [{n}, {d}] {DTYPE_NAME[dtype]}: y err {e:.3g}, "
                  f"stats err {e_stats:.3g} (tol {tol})")
            require(e <= tol and e_stats <= 1e-5,
                    f"layer_norm [{n}, {d}] {DTYPE_NAME[dtype]} disagrees")
            errs[("layer_norm_fwd", dtype)] = max(errs.get(("layer_norm_fwd", dtype), 0.0), e)


def phase_layer_norm_bwd(errs, rows_main):
    """dx, dgamma, dbeta through torch.autograd.grad of the kernel against
    the plain backward on the same inputs, both modes of the kernel."""
    from openasr_torch.kernels.layer_norm import (
        fused_layer_norm,
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    rng = np.random.RandomState(SEED + 3)
    for dtype in DTYPES:
        tol = TOL_LN_BWD[dtype]
        for n, d in ((rows_main, 512), (40, 512), (37, 64), (1, 1000), (1, 512), (5, 512),
                     (1027, 512), (300, 1536)):
            x, g, b = ln_inputs(n, d, dtype, rng)
            dy = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to("cuda", dtype)
            xr, gr, br = (t.clone().requires_grad_() for t in (x, g, b))
            y, _, _ = fused_layer_norm(xr, gr, br)
            got = torch.autograd.grad(y, (xr, gr, br), dy)
            _, mean, rstd = layer_norm_reference(x, g, b)
            want = layer_norm_bwd_reference(x, dy, g, mean, rstd)
            dx_only, none_g, none_b = layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)
            torch.cuda.synchronize()
            require(none_g is None and none_b is None, "dx-only mode returned partials")
            worst = 0.0
            for name, t, w in zip(("dx", "dgamma", "dbeta", "dx(dx-only)"),
                                  (*got, dx_only), (*want, want[0])):
                e, scale = scaled_err(t, w)
                require(e <= tol * scale,
                        f"layer_norm_bwd [{n}, {d}] {DTYPE_NAME[dtype]} {name}: "
                        f"err {e:.3g} > {tol} x {scale:.3g}")
                worst = max(worst, e / scale)
                key = "layer_norm_bwd_dx" if name == "dx(dx-only)" else "layer_norm_bwd"
                note_err(errs, (key, dtype), e, e / scale)
            print(f"[layer_norm_bwd] [{n}, {d}] {DTYPE_NAME[dtype]}: worst err "
                  f"{worst:.3g} of max(1, |grad|) (tol {tol})")
            if n in (rows_main, 300):
                again = layer_norm_bwd(x, dy, g, mean, rstd)
                first = layer_norm_bwd(x, dy, g, mean, rstd)
                torch.cuda.synchronize()
                require(all(torch.equal(a, c) for a, c in zip(first, again)),
                        f"layer_norm_bwd [{n}, {d}] {DTYPE_NAME[dtype]}: two runs differ")
                print(f"[layer_norm_bwd] [{n}, {d}] {DTYPE_NAME[dtype]}: dx, dgamma, dbeta "
                      f"bit-identical over two runs")


# --------------------------------------------------------------- phase 3

def flash_case(b, h, d, tq, tk, dtype, rng):
    """q/k/v as strided [B, T, H, D] views of one packed projection."""
    qkv = torch.from_numpy(rng.randn(b, tq, 3, h, d).astype(np.float32)).to("cuda", dtype)
    q = qkv[:, :, 0]
    if tq == tk:
        k, v = qkv[:, :, 1], qkv[:, :, 2]
    else:
        kv = torch.from_numpy(rng.randn(b, tk, 2, h, d).astype(np.float32)).to("cuda", dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    lens = rng.randint(1, tk + 1, size=b)
    lens[0], lens[-1] = tk, 0  # a full row and a fully masked one
    return q, k, v, torch.from_numpy(lens.astype(np.int32)).cuda()


def phase_flash(errs):
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    rng = np.random.RandomState(SEED + 1)
    cases = [(8, 8, 64, t, t, c) for t in (1, 37, 304, 1024) for c in (False, True)]
    cases += [(8, 8, 64, 37, 304, False), (4, 8, 32, 304, 304, False),
              (4, 4, 128, 304, 304, True)]
    # head dims the wrappers zero-pad (16 -> 32, 48 -> 64), causal and padded
    cases += [(4, 4, d, t, t, c) for d in (16, 48) for t in (37, 139) for c in (False, True)]
    for dtype in DTYPES:
        for rate in (0.0, DROPOUT):
            seed = DROPOUT_SEED if rate else None
            for b, h, d, tq, tk, causal in cases:
                q, k, v, lens = flash_case(b, h, d, tq, tk, dtype, rng)
                out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal,
                                           dropout_rate=rate, dropout_seed=seed)
                torch.cuda.synchronize()
                out_r, lse_r = flash_attention_reference(q, k, v, lens, causal, None, rate,
                                                         seed or 0)
                e = max_err(out, out_r)
                e_lse = max_err(lse, lse_r)
                tol = TOL_FLASH[dtype]
                zero_row = float(out[-1].float().abs().max())
                print(f"[flash] B{b} H{h} D{d} Tq{tq} Tk{tk} causal={causal} "
                      f"dropout={rate} {DTYPE_NAME[dtype]}: out err {e:.3g}, lse err "
                      f"{e_lse:.3g} (tol {tol}, lse 1e-3)")
                require(e <= tol and e_lse <= 1e-3 and zero_row == 0.0,
                        f"flash {tq}x{tk} causal={causal} dropout={rate} "
                        f"{DTYPE_NAME[dtype]} disagrees")
                if d == 64:
                    key = ("flash_attention_fwd_dropout" if rate else "flash_attention_fwd",
                           dtype)
                    errs[key] = max(errs.get(key, 0.0), e)
        dropped_pairs(dtype)


def dropped_pairs(dtype):
    """At D = 16 (padded to 32) with dropout 0.1 and v[b, key, h] = e_key,
    O[b, q, h, key] is the kept weight of (q, key): its zeros must be the
    hash mask's dropped (and the causal mask's) pairs, as in the plain
    version with the same seed."""
    from openasr_torch.kernels.flash_attention import (
        attention_dropout_mask,
        flash_attention,
        flash_attention_reference,
    )

    b, h, d, tq, tk = 2, 2, 16, 37, 16
    gen = torch.Generator().manual_seed(SEED)
    for causal in (False, True):
        q = torch.randn(b, tq, h, d, generator=gen).to("cuda", dtype)
        k = torch.randn(b, tk, h, d, generator=gen).to("cuda", dtype)
        v = torch.eye(tk)[None, :, None, :].expand(b, tk, h, d).to("cuda", dtype).contiguous()
        out, _ = flash_attention(q, k, v, causal=causal, dropout_rate=DROPOUT,
                                 dropout_seed=DROPOUT_SEED)
        out_r, _ = flash_attention_reference(q, k, v, None, causal, None, DROPOUT,
                                             DROPOUT_SEED)
        torch.cuda.synchronize()
        keep = attention_dropout_mask(DROPOUT_SEED, b, h, tq, tk, DROPOUT, "cuda")
        if causal:
            keep = keep & (torch.arange(tk, device="cuda")[None, :]
                           <= torch.arange(tq, device="cuda")[:, None])
        same = [torch.equal(o.permute(0, 2, 1, 3) != 0, keep) for o in (out, out_r)]
        print(f"[flash] D16 dropout={DROPOUT} causal={causal} {DTYPE_NAME[dtype]}: "
              f"{int((~keep).sum())} dropped or masked pairs of {keep.numel()}; the kernel's "
              f"zeros are the hash mask's: {same[0]}, the plain version's: {same[1]}")
        require(all(same), "the padded kernel's dropped pairs differ from the mask")


def flash_train_case(b, h, d, tq, tk, dtype, rng, lens):
    """Leaf q/k/v (strided views of packed projections, requiring grad) and
    a dO whose layout is not contiguous (unit stride along D only)."""
    packed = torch.from_numpy(rng.randn(b, tq, 3, h, d).astype(np.float32)).to("cuda", dtype)
    packed.requires_grad_()
    q = packed[:, :, 0]
    if tq == tk:
        k, v = packed[:, :, 1], packed[:, :, 2]
    else:
        kv = torch.from_numpy(rng.randn(b, tk, 2, h, d).astype(np.float32)).to("cuda", dtype)
        kv.requires_grad_()
        k, v = kv[:, :, 0], kv[:, :, 1]
    dout = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(
        "cuda", dtype).transpose(1, 2)
    if lens is not None:
        lens = torch.as_tensor(np.asarray(lens, np.int32)).cuda()
    return q, k, v, dout, lens


def phase_flash_bwd(errs, shapes):
    """Forward (with and without dropout) and dq / dk / dv through
    torch.autograd.grad of the kernels against the plain forward and
    backward on the same inputs and dropout seed."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    rng = np.random.RandomState(SEED + 4)
    b, t, u, lens = shapes["b"], shapes["t"], shapes["u"], shapes["enc_lens"]

    def ragged(n, tk):
        x = rng.randint(1, tk + 1, size=n)
        x[0], x[-1] = tk, 0   # a full row and an empty one
        return x

    cases = [  # b, h, d, tq, tk, causal, kv lengths
        (4, 4, 32, 37, 37, False, ragged(4, 37)),
        (4, 4, 32, 37, 37, True, ragged(4, 37)),
        (4, 8, 64, 130, 130, True, None),
        (4, 8, 64, 25, 127, False, ragged(4, 127)),
        (2, 4, 128, 130, 130, False, ragged(2, 130)),
        (2, 4, 128, 64, 200, False, ragged(2, 200)),
        # head dims the wrappers zero-pad
        (4, 2, 16, 37, 37, True, None),
        (4, 2, 16, 25, 127, False, ragged(4, 127)),
        (4, 2, 48, 130, 130, True, ragged(4, 130)),
        (4, 2, 48, 25, 127, False, ragged(4, 127)),
        # the training path's own shapes: encoder self-attention, decoder
        # causal self-attention, cross-attention (Tq != Tk)
        (b, 8, 64, t, t, False, lens),
        (b, 8, 64, u, u, True, None),
        (b, 8, 64, u, t, False, lens),
    ]
    for dtype in DTYPES:
        tol = TOL_FLASH_BWD[dtype]
        for rate in (0.0, DROPOUT):
            seed = DROPOUT_SEED if rate else None
            for cb, h, d, tq, tk, causal, kvl in cases:
                q, k, v, dout, kv = flash_train_case(cb, h, d, tq, tk, dtype, rng, kvl)
                out, lse = flash_attention(q, k, v, kv_lengths=kv, causal=causal,
                                           dropout_rate=rate, dropout_seed=seed)
                got = torch.autograd.grad(out, (q, k, v), dout)
                torch.cuda.synchronize()
                qd, kd, vd = q.detach(), k.detach(), v.detach()
                out_r, lse_r = flash_attention_reference(qd, kd, vd, kv, causal, None,
                                                         rate, seed or 0)
                want = flash_attention_bwd_reference(qd, kd, vd, out_r, lse_r, dout, kv,
                                                     causal, None, rate, seed or 0)
                e_out = max_err(out, out_r)
                require(e_out <= TOL_FLASH[dtype],
                        f"flash fwd dropout={rate} {DTYPE_NAME[dtype]} B{cb} Tq{tq} "
                        f"Tk{tk}: out err {e_out:.3g}")
                worst = 0.0
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    e, scale = scaled_err(g, w)
                    require(e <= tol * scale,
                            f"flash bwd dropout={rate} {DTYPE_NAME[dtype]} B{cb} H{h} "
                            f"D{d} Tq{tq} Tk{tk} causal={causal}: {name} err {e:.3g} "
                            f"> {tol} x {scale:.3g}")
                    worst = max(worst, e / scale)
                    if d == 64:
                        kernel = "dq" if name == "dq" else "dkv"
                        note_err(errs, (f"flash_attention_bwd_{kernel}", dtype), e, e / scale)
                print(f"[flash_bwd] B{cb} H{h} D{d} Tq{tq} Tk{tk} causal={causal} "
                      f"dropout={rate} {DTYPE_NAME[dtype]}: out err {e_out:.3g}, "
                      f"worst grad err {worst:.3g} of max(1, |grad|) (tol {tol})")
                if d == 64 and rate:
                    key = ("flash_attention_fwd_dropout", dtype)
                    errs[key] = max(errs.get(key, 0.0), e_out)


def fbank_batch(waves, utts, n=None):
    """Waves of `utts` padded to n samples (by default the collate's ladder
    over the longest), and their sample counts."""
    from openasr_torch.data.collate import quantize

    lens = np.array([len(waves[u]) for u in utts], np.int32)
    x = np.zeros((len(utts), n or quantize(int(lens.max()))), np.float32)
    for i, u in enumerate(utts):
        x[i, : lens[i]] = waves[u]
    return x, lens


def fbank_inputs(x, lens, cfg, dither):
    """Frames on the card: a strided view of the waves, or (dither) the
    materialized frames plus unit noise; and the frame counts."""
    from openasr_torch.ops.fbank import frame_signal, num_frames_of

    frames = frame_signal(torch.from_numpy(x).cuda(), cfg)
    if dither:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        frames = frames + torch.randn(frames.shape, generator=gen, device="cuda")
    return frames, num_frames_of(torch.from_numpy(lens).cuda(), cfg)


def phase_fbank(errs, train_batch, test_waves):
    """The fused fbank kernel against its plain version on the card, f32,
    TF32 off: the training and decode paths' batches, an odd T that is not
    a multiple of the kernels' 16- or 32-frame tiles, 80 and 40 bins, frames read from the
    strided waves or materialized with dither, utterances of 399 (0 frames)
    and 400 samples (1 frame), mel energies without the log (held by the
    error over the largest energy), and the training batch's waves at
    32 kHz (nfft 1024, 512 bins), with nfft 400 (not a power of two: the
    folded kernel), with VTLN warp 0.9 and with 40 bins; the decode batch's
    waves read at 8 kHz (nfft 256; with 16 ms frames, nfft 128), with 100
    ms frames (nfft 2048) and at 48 kHz with 50 ms frames (nfft 4096, the
    shared-memory FFT kernel).  Each log-mel case is also held, kernel and
    plain version alike, against `fbank_float64` (the same function in
    float64 on the card)."""
    from openasr_torch.kernels.fbank import (
        fbank_float64,
        fbank_reference,
        fused_fbank,
        is_power_of_two,
    )
    from openasr_torch.ops.fbank import FbankConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED + 7)
    short = {f"s{i}": (rng.randn(n) * 2000).astype(np.float32)
             for i, n in enumerate((6160, 5000, 399, 400))}
    train = (train_batch["waves"], train_batch["utts"], None)
    decode = (test_waves, sorted(test_waves), None)
    cases = [  # name, (waves, utterances, padded samples), config, dither
        ("training batch", train, {}, False),
        ("training batch, dithered frames", train, {}, True),
        ("decode batch", decode, {}, False),
        ("odd T, 40 bins", (short, sorted(short), 6160), {"num_mel_bins": 40}, False),
        ("odd T, dithered frames", (short, sorted(short), 6160), {}, True),
        ("one frame", (short, ["s2", "s3"], 400), {}, False),
        ("mel energies, no log", (short, sorted(short), 6160), {"use_log_fbank": False},
         False),
        ("training batch at 32 kHz, nfft 1024", train, {"sample_rate": 32000.0}, False),
        ("training batch, nfft 400 (folded kernel)", train, {"round_to_power_of_two": False},
         False),
        ("training batch, VTLN warp 0.9", train, {"vtln_warp": 0.9}, False),
        ("training batch, 40 bins", train, {"num_mel_bins": 40}, False),
        ("decode batch at 8 kHz, nfft 256", decode, {"sample_rate": 8000.0}, False),
        ("decode batch at 8 kHz, 16 ms, nfft 128, 23 bins", decode,
         {"sample_rate": 8000.0, "frame_length_ms": 16.0, "num_mel_bins": 23}, False),
        ("decode batch, 100 ms, nfft 2048", decode, {"frame_length_ms": 100.0}, False),
        ("decode batch at 48 kHz, 50 ms, nfft 4096", decode,
         {"sample_rate": 48000.0, "frame_length_ms": 50.0}, False),
    ]
    worst = worst_64 = worst_plain_64 = worst_margin = 0.0
    for name, (waves, utts, n), kw, dither in cases:
        cfg = FbankConfig(**kw)
        x, lens = fbank_batch(waves, utts, n)
        frames, feat_lens = fbank_inputs(x, lens, cfg, dither)
        before = fused_fbank.launches
        got = fused_fbank(frames, feat_lens, cfg)
        torch.cuda.synchronize()
        require(fused_fbank.launches == before + 1, f"fbank {name}: the kernel did not launch")
        want = fbank_reference(frames, feat_lens, cfg)
        e = max_err(got, want)
        b, t, _ = frames.shape
        valid = torch.arange(t, device="cuda")[None, :] < feat_lens[:, None]
        pad_max = float(got[~valid].abs().max()) if bool((~valid).any()) else 0.0
        head = (f"[fbank] {name}: B{b} T{t} M{cfg.num_mel_bins} nfft "
                f"{cfg.padded_window_size}, frame stride {frames.stride(1)}, frames "
                f"{feat_lens.tolist() if b <= 4 else int(feat_lens.sum())}: ")
        ok = pad_max == 0.0 and bool(torch.isfinite(got).all())
        if cfg.use_log_fbank:
            f64 = fbank_float64(frames, feat_lens, cfg)
            e64, e_plain64 = max_err(got.double(), f64), max_err(want.double(), f64)
            tol = (e_plain64 + TOL_FBANK_F64 if is_power_of_two(cfg.padded_window_size)
                   else TOL_FBANK_FOLDED)
            print(head + f"err {e:.3g} (tol {tol:.3g}); against float64: kernel "
                  f"{e64:.3g} (tol {TOL_FBANK_F64}, and at most the plain version's), "
                  f"plain {e_plain64:.3g}, padding max {pad_max}")
            if is_power_of_two(cfg.padded_window_size):
                ok = ok and e <= tol and e64 <= min(TOL_FBANK_F64, e_plain64)
                worst, worst_64 = max(worst, e), max(worst_64, e64)
                worst_plain_64 = max(worst_plain_64, e_plain64)
                worst_margin = max(worst_margin, e / tol)
            else:
                ok = ok and e <= TOL_FBANK_FOLDED
                errs["fbank_folded"] = e
        else:
            scale = max(1.0, float(want.abs().max()))
            print(head + f"err {e:.3g} = {e / scale:.3g} of the largest energy {scale:.4g} "
                  f"(tol {TOL_FBANK_REL}), padding max {pad_max}")
            ok = ok and e <= TOL_FBANK_REL * scale
            errs["fbank_mel_rel"] = e / scale
        require(ok, f"fbank {name} disagrees")
    errs["fbank"], errs["fbank_vs_f64"], errs["fbank_plain_vs_f64"] = (
        worst, worst_64, worst_plain_64)
    errs["fbank_of_tol"] = worst_margin


def check_features_against_cpu(test_waves):
    """The f32 features of 2 utterances through `ops.fbank.fbank` on the
    card (the kernel) and on the CPU (the plain version)."""
    from openasr_torch.ops.fbank import FbankConfig, fbank

    x, lens = fbank_batch(test_waves, sorted(test_waves)[:2])
    cfg = FbankConfig()
    got, got_lens = fbank(torch.from_numpy(x).cuda(), torch.from_numpy(lens).cuda(), cfg)
    want, want_lens = fbank(torch.from_numpy(x), torch.from_numpy(lens), cfg)
    e = max_err(got.cpu(), want)
    print(f"[check] f32 fbank features, card vs CPU, 2 utts {tuple(want.shape)}: "
          f"err {e:.3g} (tol {TOL_FBANK_CPU})")
    require(torch.equal(got_lens.cpu(), want_lens) and e <= TOL_FBANK_CPU,
            "fbank features differ between card and CPU")


# --------------------------------------------------------------- corpora

def write_vocab():
    chars = [chr(0x4E00 + i) for i in range(4229)]
    vocab = os.path.join(WORK, "chars.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("".join(c + "\n" for c in chars))
    return vocab, chars


def write_corpus(name, rng, chars, n_utts, frames, tokens, dim=80):
    """`n_utts` utterances of `frames` (lo, hi) random `dim`-dim frames with
    `tokens` (lo, hi) random characters each, as ark/scp + json."""
    from openasr_torch.data.kaldi_io import write_ark_scp

    feats = {
        f"{name}{i:03d}": rng.randn(int(rng.randint(frames[0], frames[1] + 1)), dim)
        .astype(np.float32)
        for i in range(n_utts)
    }
    write_ark_scp(os.path.join(WORK, name), feats.items())
    rows = []
    with open(os.path.join(WORK, f"{name}.scp")) as f:
        for line in f:
            utt, path = line.split()
            n_tok = int(rng.randint(tokens[0], tokens[1] + 1))
            rows.append({"uttid": utt, "feat": path, "feat_length": feats[utt].shape[0],
                         "tokens": " ".join(rng.choice(chars, size=n_tok)),
                         "token_length": n_tok})
    manifest = os.path.join(WORK, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return manifest, feats


def write_wave_corpus(name, rng, chars, n_utts, samples, tokens):
    """`n_utts` 16 kHz PCM16 wav files of `samples` (lo, hi) samples -- three
    random tones over noise, with a near-silent stretch -- and `tokens`
    (lo, hi) random characters each, as a wave manifest."""
    from openasr_torch.data.audio import write_wav

    os.makedirs(os.path.join(WORK, name))
    rows, waves = [], {}
    for i in range(n_utts):
        n = int(rng.randint(samples[0], samples[1] + 1))
        t = np.arange(n) / RATE
        w = 100.0 * rng.randn(n)
        for f0 in rng.uniform(100.0, 4000.0, size=3):
            w += 3000.0 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        quiet = int(rng.randint(0, n // 2))
        w[quiet: quiet + n // 4] *= 0.01
        utt = f"{name}{i:03d}"
        path = os.path.join(WORK, name, f"{utt}.wav")
        write_wav(path, RATE, w)
        waves[utt] = np.clip(np.rint(w), -32768, 32767).astype(np.float32)
        n_tok = int(rng.randint(tokens[0], tokens[1] + 1))
        rows.append({"uttid": utt, "feat": path, "feat_length": n,
                     "tokens": " ".join(rng.choice(chars, size=n_tok)),
                     "token_length": n_tok})
    manifest = os.path.join(WORK, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return manifest, waves


def online_model() -> dict:
    """The model section of the online flagship YAML (the flagship with the
    fbank signal), at the flagship's vocabulary."""
    import yaml

    with open(ONLINE_YAML) as f:
        model = yaml.safe_load(f)["model"]
    model["decoder"]["vocab_size"] = FLAGSHIP["decoder"]["vocab_size"]
    return model


def save_flagship_package(path, solver_state=None, model_cfg=FLAGSHIP):
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import save_package

    model = get_model_class("conv-ctc-transformer").create_model(
        model_cfg, device="cuda", generator=torch.Generator().manual_seed(SEED)
    )
    pkg = model.package()
    if solver_state is not None:
        pkg = {"model": pkg, "solver_state": solver_state, "optim_state": None}
    save_package(pkg, path)
    return pkg


# --------------------------------------------------------------- phase 4

def phase_decode(pkg, vocab, manifest, launches, online=False):
    """Decode through the CLI in both dtypes, from features (--offline,
    36000 frames a batch) or from waves (5760000 samples a batch); counters
    reset just before each run and read just after.  The flash kernel runs
    once per encoder layer of a batch and the fbank kernel once per online
    batch."""
    from openasr_torch.bin import infer
    from openasr_torch.data.manifest import ArkDataset, SpeechDataset
    from openasr_torch.data.sampler import FrameBasedSampler, TimeBasedSampler

    dataset, sampler, budget = ((SpeechDataset, TimeBasedSampler, 5760000) if online
                                else (ArkDataset, FrameBasedSampler, 36000))
    n_batches = len(sampler(dataset(manifest, feat_range=(1, 10**9), label_range=(0, 10**9),
                                    rate_in_out=(0, 10**9)), budget))
    n_utts = len(json.load(open(manifest)))
    tag = "online decode" if online else "decode"
    for dtype in DTYPES:
        hyp = os.path.join(WORK, f"hyp_{tag.replace(' ', '_')}_{DTYPE_NAME[dtype]}.txt")
        argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                "--vocab_path", vocab, "--json_file", manifest, "--output", hyp,
                "--add_blk", "--nbest", "5", "--maxlen", "40",
                "--batch_frames", str(budget), "--dtype", DTYPE_NAME[dtype],
                "--device", "cuda"] + ([] if online else ["--offline"])
        reset_counters()
        t0 = time.time()
        infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        n_flash, n_ln = n["flash_attention_fwd"], n["layer_norm_fwd"]
        launches[(tag, dtype)] = n
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[{tag} path] {DTYPE_NAME[dtype]}: {len(lines)} hyps in {wall:.2f}s wall, "
              f"{n_batches} batch(es); launches: flash_attention {n_flash}, "
              f"layer_norm {n_ln}, fbank {n['fbank']}")
        require(len(lines) == n_utts, f"{len(lines)} hyp lines for {n_utts} utterances")
        require(n_flash == 6 * n_batches, f"flash launched {n_flash} times")
        require(n_ln >= 13 * n_batches, f"layer_norm launched {n_ln} times")
        require(n["fbank"] == (n_batches if online else 0), f"fbank launched {n['fbank']} times")


def padded_batch(feats, utts, rng):
    from openasr_torch.data.collate import gen_causal_targets, quantize

    lengths = np.array([feats[u].shape[0] for u in utts], np.int32)
    x = np.zeros((len(utts), quantize(int(lengths.max())), 80), np.float32)
    for i, u in enumerate(utts):
        x[i, : lengths[i]] = feats[u]
    toks = [list(rng.randint(3, 4232, size=n)) for n in (22, 20)[: len(utts)]]
    ids, labels, paddings = gen_causal_targets(toks, add_eos=True)
    return {"feats": x, "feat_lengths": lengths, "ids": ids.astype(np.int64),
            "labels": labels, "paddings": paddings}


def check_logits_against_cpu(pkg, feats):
    """The card's f32 encoder and teacher-forced decoder (kernels) against
    the same package on the CPU (plain versions), on two utterances."""
    from openasr_torch.config import Config
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg)
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED))
    outs = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(
            Config(pkg["configs"]), device=device
        )
        model.restore(pkg)
        with torch.inference_mode():
            ctc, elens, ce = model.module(
                *(torch.from_numpy(batch[k]).to(device)
                  for k in ("feats", "feat_lengths", "ids"))
            )
        outs[device] = (ctc.cpu(), elens.cpu(), ce.cpu())
    (ctc_g, el_g, ce_g), (ctc_c, el_c, ce_c) = outs["cuda"], outs["cpu"]
    require(torch.equal(el_g, el_c), "encoder lengths differ between card and CPU")
    require(bool(torch.isfinite(ctc_g).all() and torch.isfinite(ce_g).all()),
            "non-finite logits on the card")
    e_ctc, e_ce = max_err(ctc_g, ctc_c), max_err(ce_g, ce_c)
    print(f"[check] f32 card vs CPU, 2 utts: ctc_fc logits err {e_ctc:.3g}, "
          f"decoder logits err {e_ce:.3g} (tol 1e-3)")
    require(e_ctc <= 1e-3 and e_ce <= 1e-3, "card and CPU disagree")


# --------------------------------------------------------------- phase 5

def train_config(train_json, dev_json, vocab, exp_dir, dtype, yaml_path=FLAGSHIP_YAML):
    """A flagship YAML with its model and training sections unchanged but
    for one epoch, a log line per step, this run's paths and `dtype`."""
    import yaml

    with open(yaml_path) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=train_json, devset=dev_json, vocab_path=vocab)
    cfg["training"].update(exp_dir=exp_dir, num_epoch=1, print_inteval=1,
                           compute_dtype=DTYPE_NAME[dtype])
    path = os.path.join(exp_dir, f"train_{DTYPE_NAME[dtype]}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def per_step_launches(model_cfg=FLAGSHIP) -> dict:
    """Kernel launches of one training step (and of one dev batch) of the
    flagship: every LayerNorm and every attention of the module once, and
    the fbank kernel once for an online model."""
    from openasr_torch.config import Config
    from openasr_torch.models.layers import LayerNorm, MultiHeadAttention
    from openasr_torch.models.speech import ConvCTCTransformerModule

    with torch.device("meta"):
        module = ConvCTCTransformerModule(Config(model_cfg))
    n_ln = sum(isinstance(m, LayerNorm) for m in module.modules())
    n_attn = sum(isinstance(m, MultiHeadAttention) for m in module.modules())
    n_fbank = int(module.splayer.feature_type == "fbank")
    per = {"train": {"layer_norm_fwd": n_ln, "layer_norm_bwd": n_ln,
                     "flash_attention_fwd_dropout": n_attn,
                     "flash_attention_bwd_dkv": n_attn, "flash_attention_bwd_dq": n_attn},
           "dev": {"layer_norm_fwd": n_ln, "flash_attention_fwd": n_attn}}
    if n_fbank:
        per["train"]["fbank"] = per["dev"]["fbank"] = n_fbank
    return per


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def phase_train(train_json, dev_json, vocab, launches, online=False):
    """Train one epoch + dev pass through the CLI in f32 and bf16, from one
    initial package, on offline features (the flagship YAML) or on waves
    (the online flagship YAML); counters reset just before each run and
    read just after."""
    from openasr_torch.bin import train
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    model_cfg, yaml_path = (online_model(), ONLINE_YAML) if online else (FLAGSHIP, FLAGSHIP_YAML)
    tag = "online train" if online else "train"
    per = per_step_launches(model_cfg)
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        exp = os.path.join(WORK, f"exp_{tag.replace(' ', '_')}_{name}")
        os.makedirs(exp)
        init = save_flagship_package(
            os.path.join(exp, "last.pkg"),
            {"epoch": 0, "step": 0, "tr_loss": [], "cv_loss": []}, model_cfg)
        cfg = train_config(train_json, dev_json, vocab, exp, dtype, yaml_path)
        reset_counters()
        t0 = time.time()
        train.main([cfg, "--continue-training", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = read_counters()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        tr = [r for r in rows if r["phase"] == "train"]
        cv = [r for r in rows if r["phase"] == "cv"]
        steps, dev_batches = len(tr), len(cv)
        losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
        step_s = [b["time"] - a["time"] for a, b in zip(tr, tr[1:])]
        print(f"[{tag} path] {name}: {steps} steps + {dev_batches} dev batch(es) in "
              f"{wall:.2f}s wall; per-step host s after the first {step_s}; "
              f"losses {[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
              f"{[round(r['ce_loss'], 4) for r in tr]} (ce); launches {n}")
        require(steps >= 2 and dev_batches >= 1, f"{steps} steps, {dev_batches} dev batches")
        require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
        want = {k: 0 for k in n}
        for k, c in per["train"].items():
            want[k] += c * steps
        for k, c in per["dev"].items():
            want[k] += c * dev_batches
        require(n == want, f"launches {n} != {want} "
                           f"({per['train']} a step, {per['dev']} a dev batch)")
        require(min(n[k] for k in per["train"]) > 0, "a kernel of the path never launched")
        launches[(tag, dtype)] = {"total": n, "steps": steps, "dev_batches": dev_batches}

        last = load_package(os.path.join(exp, "last.pkg"))
        require(last["solver_state"]["step"] == steps and
                last["optim_state"]["count"] == steps, "last.pkg holds the wrong step")
        model = get_model_class("conv-ctc-transformer").create_model(model_cfg, device="cuda")
        model.restore(last["model"])
        before = dict(leaves(init["model"]["components"]))
        after = dict(leaves(last["model"]["components"]))
        matrices = [k for k, v in before.items() if v.ndim >= 2]
        changed = [k for k in matrices if not np.array_equal(before[k], after[k])]
        finite = all(np.isfinite(v).all() for v in after.values())
        print(f"[{tag} path] {name}: last.pkg reloads at step {steps}; "
              f"{len(changed)}/{len(matrices)} weight matrices changed; finite {finite}")
        require(finite and len(changed) == len(matrices),
                f"unchanged weights: {sorted(set(matrices) - set(changed))[:5]}")
    return per


def phase_train_head_dim_16(vocab, chars, rng, launches):
    """Two training steps and a dev pass of egs/aishell1/configs/
    conv-ctc-transformer-test.yaml (d_model 32, 2 heads: head dim 16, which
    the attention wrappers zero-pad to 32) through the CLI on the card, f32,
    on 4 random 20-dim utterances: finite losses, and every attention
    kernel launched."""
    import yaml

    from openasr_torch.bin import train

    manifest, _ = write_corpus("htrain", rng, chars, 4, (80, 96), (4, 8), dim=20)
    exp = os.path.join(WORK, "exp_head_dim_16")
    os.makedirs(exp)
    with open(TEST_YAML) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(trainset=manifest, devset=manifest, vocab_path=vocab)
    cfg["training"].update(exp_dir=exp, num_epoch=1, print_inteval=1)
    path = os.path.join(exp, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    reset_counters()
    train.main([path, "--device", "cuda"])
    n = read_counters()
    launches[("head dim 16 train", torch.float32)] = n
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tr = [r for r in rows if r["phase"] == "train"]
    losses = [v for r in rows for k, v in r.items() if k.endswith("loss")]
    print(f"[head dim 16 train path] {len(tr)} steps: losses "
          f"{[round(r['ctc_loss'], 4) for r in tr]} (ctc), "
          f"{[round(r['ce_loss'], 4) for r in tr]} (ce); launches {n}")
    require(len(tr) >= 2, f"{len(tr)} training steps")
    require(all(np.isfinite(v) for v in losses), f"non-finite loss logged: {losses}")
    require(min(n[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                               "flash_attention_bwd_dq", "layer_norm_bwd")) > 0,
            "an attention or LayerNorm kernel never launched at head dim 16")


def check_grads_against_cpu(pkg_path, feats):
    """One f32 training step (dropout and SpecAugment off) on 2 utterances
    at full width: every parameter's gradient on the card against the CPU,
    TF32 off."""
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg_path)
    batch = padded_batch(feats, sorted(feats)[:2], np.random.RandomState(SEED + 5))
    grads = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(FLAGSHIP, device=device)
        model.restore(pkg)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        losses = model.loss(tb, None, label_smooth=0.1,
                            empty_rows=model.has_empty_rows(batch["feat_lengths"]))
        total = losses["ce_loss"] / losses["n_tokens"] + losses["ctc_loss"] / losses["n_seqs"]
        total.backward()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}
        print(f"[grad check] {device}: loss {float(total.detach()):.6f}")
    worst, worst_name = 0.0, None
    for name, want in grads["cpu"].items():
        # an attention k-projection bias has an analytically zero gradient
        # (softmax is shift-invariant), so its values are rounding noise:
        # its error is measured against its projection weight's gradient
        ref = grads["cpu"][name[: -len("bias")] + "weight"] if name.endswith(".k.bias") else want
        scale = max(float(ref.abs().max()), 1e-30)
        rel = max_err(grads["cuda"][name], want) / scale
        if not rel <= worst:
            worst, worst_name = rel, name
    print(f"[grad check] f32 card vs CPU, 2 utts, {len(grads['cpu'])} parameters: worst "
          f"err {worst:.3g} of the gradient's max abs ({worst_name}; tol 1e-3; "
          f"k-projection biases against their weight's)")
    require(worst <= 1e-3, f"gradient of {worst_name} disagrees: {worst:.3g}")


# --------------------------------------------------------------- phase 6

def train_shapes(train_json):
    """The training path's largest batch: B, padded T' after ConvV2 and the
    encoder lengths, and the decoder's U (ids width)."""
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import ArkDataset
    from openasr_torch.data.sampler import FrameBasedSampler

    ds = ArkDataset(train_json, feat_range=(1, 1200), label_range=(1, 60))
    best = None
    for batch in FrameBasedSampler(ds, 36000).batches:
        lens = np.array([ds[i]["feat_length"] for i in batch])
        t = quantize(int(lens.max()))
        for _ in range(2):
            t, lens = (t - 1) // 2, (lens - 1) // 2
        u = quantize(max(int(ds[i]["token_length"]) for i in batch) + 2)
        if best is None or len(batch) * t > best["b"] * best["t"]:
            best = {"b": len(batch), "t": t, "enc_lens": lens, "u": u}
    return best


def online_train_batch(train_json, waves):
    """The online training path's largest batch (by padded samples): its
    utterances and the corpus's waves."""
    import yaml

    from openasr_torch.config import parse_range
    from openasr_torch.data.collate import quantize
    from openasr_torch.data.manifest import SpeechDataset
    from openasr_torch.data.sampler import TimeBasedSampler

    with open(ONLINE_YAML) as f:
        cfg = yaml.safe_load(f)
    ds = SpeechDataset(train_json, feat_range=parse_range(cfg["data"]["feat_range"]),
                       label_range=parse_range(cfg["data"]["label_range"]))
    batches = TimeBasedSampler(ds, int(cfg["training"]["batch_time"])).batches
    best = max(batches, key=lambda b: len(b) * quantize(max(ds[i]["feat_length"] for i in b)))
    return {"utts": [ds[i]["uttid"] for i in best], "waves": waves}


def encoder_shapes(feats):
    """The decode path's encoder batch: B, padded T' after ConvV2, lengths."""
    from openasr_torch.data.collate import quantize

    lens = np.array([m.shape[0] for m in feats.values()])
    t = quantize(int(lens.max()))
    for _ in range(2):
        t, lens = (t - 1) // 2, (lens - 1) // 2
    return len(lens), t, lens


def times(kernel, plain, library) -> dict:
    """Device ms per call (CUDA-graph replay) of the kernel, its plain
    version and the library call."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library)}


def bound(nbytes, flops, dtype, peaks=PEAK_FLOPS) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peaks[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def held_to_plain(name, kernel, plain, tol, errs, key) -> None:
    """Kernel against plain version at a main-path shape; the first
    outputs (y, O) are compared and the error joins the kernel's max."""
    got, want = kernel()[0], plain()[0]
    torch.cuda.synchronize()
    e = max_err(got, want)
    print(f"[{name}] main-path shape: err {e:.3g} (tol {tol})")
    require(e <= tol, f"{name} disagrees at the main path's shape")
    errs[key] = max(errs[key], e)


def attention_pairs(tq, lens, causal) -> int:
    """(query, key) pairs the masks leave valid, summed over the batch."""
    q = np.arange(tq)[:, None]
    total = 0
    for n in lens:
        k = np.arange(int(n))[None, :]
        total += int(((k <= q) if causal else np.ones((tq, int(n)), bool)).sum())
    return total


def fwd_rows(feats, errs, launches):
    """The forward kernels (LayerNorm, attention) at the decode path's encoder shape."""
    import torch.nn.functional as F

    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

    b, t, lens = encoder_shapes(feats)
    h, d, dm = 8, 64, 512
    rng = np.random.RandomState(SEED + 2)
    rows = []
    for dtype in DTYPES:
        es = torch.tensor([], dtype=dtype).element_size()
        dec, tr = launches[("decode", dtype)], launches[("train", dtype)]
        n = b * t
        x, g, beta = ln_inputs(n, dm, dtype, rng)
        g_l, b_l = g.to(dtype), beta.to(dtype)
        held_to_plain(f"layer_norm {DTYPE_NAME[dtype]} [{n}, {dm}]",
                      lambda: fused_layer_norm(x, g, beta),
                      lambda: layer_norm_reference(x, g, beta),
                      TOL_LN[dtype], errs, ("layer_norm_fwd", dtype))
        rows.append({
            "name": f"layer_norm_fwd[{DTYPE_NAME[dtype]}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:56",
            "shape": [n, dm],
            "launches": dec["layer_norm_fwd"],
            "launches_train_path": tr["total"]["layer_norm_fwd"],
            "max_abs_err": errs[("layer_norm_fwd", dtype)],
            "tol": TOL_LN[dtype],
            **times(
                lambda: fused_layer_norm(x, g, beta),
                lambda: layer_norm_reference(x, g, beta),
                lambda: F.layer_norm(x, (dm,), g_l, b_l, 1e-6),
            ),
            **bound(2 * n * dm * es + 2 * dm * 4 + 2 * n * 4, 8 * n * dm, torch.float32),
        })

        rows.append({
            "name": f"flash_attention_fwd[{DTYPE_NAME[dtype]}]",
            **attention_fwd_row(b, h, d, t, t, False, lens, dtype, rng, errs, 0.0),
            "launches": dec["flash_attention_fwd"],
            "launches_train_path": tr["total"]["flash_attention_fwd"],
            "max_abs_err": errs[("flash_attention_fwd", dtype)],
            "tol": TOL_FLASH[dtype],
        })
    return rows


def fbank_ops_per_frame(cfg) -> float:
    """Operations of one frame's log-mel, what the fbank needs: DC removal,
    preemphasis and window, 5 a sample; a real FFT of nfft points, 2.5 nfft
    log2 nfft; the power, 3 a bin; the mel product over the banks'
    nonzeros, 2 each; max and log, 2 a bin."""
    from openasr_torch.ops.fbank import mel_banks

    ws, nfft, m = cfg.window_size, cfg.padded_window_size, cfg.num_mel_bins
    nnz = int(np.count_nonzero(mel_banks(cfg)))
    return 5 * ws + 2.5 * nfft * float(np.log2(nfft)) + 3 * (nfft // 2 + 1) + 2 * nnz + 2 * m


def fbank_rows(train_batch, test_waves, errs, launches):
    """The fused fbank kernel at the online paths' batches (f32 only: the
    frontend always runs in f32): the FFT kernel, which those paths run,
    and at the decode batch with nfft 400 (round_to_power_of_two false) the
    folded kernel, which no path of the smoke test runs."""
    from openasr_torch.kernels.fbank import fbank_reference, fused_fbank
    from openasr_torch.ops.fbank import FbankConfig, rfft_fbank

    rows = []
    for path, waves, utts, kw in (
        ("train", train_batch["waves"], train_batch["utts"], {}),
        ("decode", test_waves, sorted(test_waves), {}),
        ("decode, nfft 400", test_waves, sorted(test_waves), {"round_to_power_of_two": False}),
    ):
        cfg = FbankConfig(**kw)
        ws, m = cfg.window_size, cfg.num_mel_bins
        x, lens = fbank_batch(waves, utts)
        frames, feat_lens = fbank_inputs(x, lens, cfg, False)
        b, t, _ = frames.shape
        n_valid = int(feat_lens.sum())
        # the composite computes every frame it is given: give it the valid
        # ones only, gathered before the timing, as the kernel skips padding
        valid = torch.arange(t, device="cuda")[None, :] < feat_lens[:, None]
        valid_frames = frames[valid]
        # samples read once, every output written, the frame counts read
        nbytes = 4 * int(lens.sum()) + 4 * b * t * m + 4 * b
        if kw:
            name, kernel = "fbank_folded[decode, nfft 400]", "fbank_folded_kernel"
            counted = {"launches": 0,
                       "launches_are": "the online paths' configs (nfft 512) take the FFT "
                                       "kernel; this one runs where nfft is not a power of "
                                       "two (the [fbank] phase's nfft 400 case)"}
        else:
            name, kernel = f"fbank[{path}]", "fbank_fft_kernel"
            run = launches[(f"online {path}", torch.float32)]
            counted = {"launches": run.get("total", run)["fbank"],
                       "launches_are": f"the online {path} path's, in f32 (in bf16 the same)"}
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"openasr_torch/kernels/csrc/fbank.cu:{kernel}",
            "replaces": "openasr_tpu/kernels/fbank_fused.py:90",
            "shape": [b, t, ws],
            "nfft": cfg.padded_window_size,
            **counted,
            **({"max_abs_err": errs["fbank_folded"], "tol": TOL_FBANK_FOLDED} if kw else {
                "max_abs_err": errs["fbank"],
                "tol_is": "per case, the plain version's max_abs_err against float64 plus "
                          "tol_vs_float64",
                "largest_share_of_tol": errs["fbank_of_tol"],
                "max_abs_err_vs_float64": errs["fbank_vs_f64"],
                "tol_vs_float64": TOL_FBANK_F64,
                "plain_max_abs_err_vs_float64": errs["fbank_plain_vs_f64"]}),
            "max_rel_err_no_log": errs["fbank_mel_rel"],
            "tol_no_log": TOL_FBANK_REL,
            "valid_frames": n_valid,
            **times(lambda: fused_fbank(frames, feat_lens, cfg),
                    lambda: fbank_reference(frames, feat_lens, cfg),
                    lambda: rfft_fbank(valid_frames, cfg)),
            "plain_is": "the folded products over all B.T frames, then masked",
            "library_is": "several calls, the cuFFT composite (ops.fbank.rfft_fbank): DC "
                          "removal, preemphasis and window, torch.fft.rfft, power, the mel "
                          "matmul and the log, over the valid frames only (gathered "
                          "before the timing)",
            # what the log-mel needs over the valid frames (an FFT, the mel
            # banks' nonzeros), at the rate of the f32 it reads and writes
            **bound(nbytes, n_valid * fbank_ops_per_frame(cfg), torch.float32),
            **({} if kw else {"float64_ops_bound_ms": n_valid * fbank_ops_per_frame(cfg)
                              / PEAK_FLOPS[torch.float64] * 1e3,
                              "float64_ops_bound_is": "the same operations at float64's "
                                                      "rate, the type the kernel computes in"}),
        })
    return rows


def bwd_errs(err, tol) -> dict:
    """Row keys of a backward kernel's errors over every checked case."""
    return {"max_abs_err": err[0], "max_scaled_err": err[1], "tol": tol,
            "tol_of": "max_scaled_err: max abs error over max(1, largest plain "
                      "magnitude), gradients with and without dropout"}


def backward_ms(fwd, inputs, grad_out) -> float:
    """Device ms of the backward of `fwd`: forward + backward minus the
    forward alone, both by CUDA-graph replay."""
    def both():
        torch.autograd.grad(fwd(), inputs, grad_out)

    return device_ms(both) - device_ms(fwd)


def attention_shapes(shapes, model_cfg=FLAGSHIP):
    """The training step's attention shapes: (name, Tq, Tk, causal, kv
    lengths or None, calls a step), one call a layer, forward and
    backward."""
    t, u, lens = shapes["t"], shapes["u"], shapes["enc_lens"]
    n_enc, n_dec = model_cfg["encoder"]["num_layers"], model_cfg["decoder"]["num_layers"]
    return [("encoder", t, t, False, lens, n_enc), ("decoder", u, u, True, None, n_dec),
            ("cross", u, t, False, lens, n_dec)]


def attention_bwd_times(b, h, d, tq, tk, causal, lens, dtype, rng) -> dict:
    """The whole attention backward (delta, dK/dV, dQ) at one shape, with
    dropout 0.1 as the training path runs it: device ms of the kernels,
    the plain backward and SDPA's backward, the bound and the inputs."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_delta,
    )

    es = torch.tensor([], dtype=dtype).element_size()
    q, dout = (torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to("cuda", dtype)
               for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, tk, h, d).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    kv = None if lens is None else torch.from_numpy(lens.astype(np.int32)).cuda()
    qt, kt, vt, dot = (z.transpose(1, 2) for z in (q, k, v, dout))
    qg, kg, vg = (z.detach().clone().requires_grad_() for z in (qt, kt, vt))
    if kv is None:
        sdpa = dict(is_causal=causal)
    else:
        sdpa = dict(attn_mask=(torch.arange(tk, device="cuda")[None, :]
                               < kv[:, None])[:, None, None, :])
    rate, seed = DROPOUT, DROPOUT_SEED
    out, lse = flash_attention(q, k, v, kv_lengths=kv, causal=causal, dropout_rate=rate,
                               dropout_seed=seed)
    args = (q, k, v, out, lse, dout, kv, causal, None, rate, seed)
    key_lens = [tk] * b if lens is None else [min(int(n), tk) for n in lens]
    pairs = h * attention_pairs(tq, key_lens, causal)
    qo_bytes = es * b * tq * h * d                 # one [B, Tq, H, D] tensor
    kv_bytes = es * sum(key_lens) * h * d          # K or V over valid keys
    stat_bytes = 4 * b * h * tq                    # lse or delta
    # q, O, dO read; K, V over valid keys; lse and lengths; dQ written over
    # every query, dK and dV over every key; five Tq.Tk.D products over the
    # valid pairs (S, dP, dV, dK, dQ)
    nbytes = 4 * qo_bytes + 2 * kv_bytes + 2 * es * b * tk * h * d + stat_bytes + 4 * b
    return {
        "shape": [b, tq, tk, h, d],
        "ms": device_ms(lambda: flash_attention_bwd(*args)),
        "plain_ms": device_ms(lambda: flash_attention_bwd_reference(*args)),
        "library_ms": backward_ms(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, dropout_p=rate, **sdpa),
            (qg, kg, vg), dot),
        **bound(nbytes, 5 * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
        "kernel_args": args[:6] + (flash_delta(out, dout),) + args[6:],
        "pairs": pairs, "qo_bytes": qo_bytes, "kv_bytes": kv_bytes, "stat_bytes": stat_bytes,
    }


def train_rows(shapes, errs, launches, per):
    """The training path's kernels at its encoder shape (largest batch),
    and the attention forward and backward also at the decoder's and the
    cross-attention's."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )
    from openasr_torch.kernels.layer_norm import (
        layer_norm_bwd,
        layer_norm_bwd_reference,
        layer_norm_reference,
    )

    b, t = shapes["b"], shapes["t"]
    h, d, dm = 8, 64, 512
    rng = np.random.RandomState(SEED + 6)
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        es = torch.tensor([], dtype=dtype).element_size()
        tr = launches[("train", dtype)]

        def launch_keys(key):
            return {"launches": tr["total"][key],
                    "launches_per_step": per["train"].get(key, 0)}

        # LayerNorm backward over the encoder's rows
        n = b * t
        x, g, beta = ln_inputs(n, dm, dtype, rng)
        dy = torch.from_numpy(rng.randn(n, dm).astype(np.float32)).to("cuda", dtype)
        _, mean, rstd = layer_norm_reference(x, g, beta)
        xl, gl, bl = (z.clone().requires_grad_() for z in (x, g.to(dtype), beta.to(dtype)))
        lib_ln_ms = backward_ms(lambda: F.layer_norm(xl, (dm,), gl, bl, 1e-6), (xl, gl, bl), dy)
        rows.append({
            "name": f"layer_norm_bwd[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:85 (and :69, the dx-only mode)",
            "shape": [n, dm],
            **launch_keys("layer_norm_bwd"),
            **bwd_errs(errs[("layer_norm_bwd", dtype)], TOL_LN_BWD[dtype]),
            "ms": device_ms(lambda: layer_norm_bwd(x, dy, g, mean, rstd)),
            "plain_ms": device_ms(lambda: layer_norm_bwd_reference(x, dy, g, mean, rstd)),
            "library_ms": lib_ln_ms,
            "library_is": "F.layer_norm forward + backward minus forward (graph replay)",
            # x, dy read and dx written; mean, rstd, gamma read; dgamma, dbeta written
            **bound(3 * n * dm * es + 2 * n * 4 + 3 * dm * 4, 13 * n * dm, torch.float32),
        })
        # the same kernel's dx-only mode (the JAX package's _bwd_dx_kernel)
        rows.append({
            "name": f"layer_norm_bwd_dx[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:69",
            "shape": [n, dm],
            **launch_keys("layer_norm_bwd_dx"),
            "launches_are": "the training path's (on no path of the port: the JAX package "
                            "runs it under SPMD only)",
            **bwd_errs(errs[("layer_norm_bwd_dx", dtype)], TOL_LN_BWD[dtype]),
            "ms": device_ms(lambda: layer_norm_bwd(x, dy, g, mean, rstd, dgamma_dbeta=False)),
            "plain_ms": device_ms(lambda: layer_norm_bwd_reference(x, dy, g, mean, rstd,
                                                                   dgamma_dbeta=False)),
            "library_ms": lib_ln_ms,
            "library_is": "F.layer_norm forward + backward minus forward (graph replay); "
                          "it also computes dgamma and dbeta",
            # x, dy read and dx written; mean, rstd, gamma read
            **bound(3 * n * dm * es + 2 * n * 4 + dm * 4, 9 * n * dm, torch.float32),
        })

        # the attention backward at the step's three shapes, with dropout as
        # the training path runs it; the encoder's rows keep their older names
        bwd_notes = {
            "plain_is": "the whole plain backward (dq, dk, dv together), dropout 0.1",
            "library_is": "F.scaled_dot_product_attention (dropout_p 0.1; a bool key "
                          "mask, or is_causal for the decoder) forward + backward minus "
                          "forward (graph replay), dq dk dv together",
        }
        errs_bwd = tuple(max(a, c) for a, c in zip(errs[("flash_attention_bwd_dkv", dtype)],
                                                    errs[("flash_attention_bwd_dq", dtype)]))
        bwd_shapes = attention_shapes(shapes)
        calls = [c for *_, c in bwd_shapes]
        require(sum(calls) * tr["steps"] == tr["total"]["flash_attention_bwd_dkv"],
                f"{calls} attention backward calls a step by the config, but "
                f"{tr['total']['flash_attention_bwd_dkv']} dK/dV launches in {tr['steps']} steps")
        step_ms = step_lib_ms = 0.0
        for where, tq, tk, causal, kv_lens, n_calls in bwd_shapes:
            at = attention_bwd_times(b, h, d, tq, tk, causal, kv_lens, dtype, rng)
            step_ms += n_calls * at["ms"]
            step_lib_ms += n_calls * at["library_ms"]
            rows.append({
                "name": (f"flash_attention_bwd[{name}]" if where == "encoder"
                         else f"flash_attention_bwd_{where}[{name}]"),
                "route": "cuda",
                "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
                "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                            "delta :468, dK/dV :238, dQ :327)",
                "shape": at["shape"],
                "causal": causal,
                **launch_keys("flash_attention_bwd_dkv"),
                "calls_per_step_at_this_shape": n_calls,
                "launches_are": "backward calls at the step's three shapes, each launching "
                                "the dK/dV and the dQ kernel once",
                **bwd_errs(errs_bwd, TOL_FLASH_BWD[dtype]),
                **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")},
                **bwd_notes,
                "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
            })
            if where != "encoder":
                continue
            # each kernel alone at the encoder shape, for its launches and
            # error; its plain and library times are those of the whole
            # backward above
            kernel_args, pairs = at["kernel_args"], at["pairs"]
            qo_bytes, kv_bytes, stat_bytes = at["qo_bytes"], at["kv_bytes"], at["stat_bytes"]
            for kernel, fn, replaces, nbytes, products in (
                ("flash_attention_bwd_dkv", flash_attention_bwd_dkv,
                 "openasr_tpu/kernels/flash_attention.py:238",
                 # q, dO, lse, delta read; K, V over valid keys; dK, dV written
                 2 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes + 2 * qo_bytes, 4),  # S dP dV dK
                ("flash_attention_bwd_dq", flash_attention_bwd_dq,
                 "openasr_tpu/kernels/flash_attention.py:327",
                 # q, dO, lse, delta read; K, V over valid keys; dQ written
                 3 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes, 3),                 # S dP dQ
            ):
                rows.append({
                    "name": f"{kernel}[{name}]",
                    "route": "cuda",
                    "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
                    "replaces": replaces,
                    "shape": at["shape"],
                    **launch_keys(kernel),
                    **bwd_errs(errs[(kernel, dtype)], TOL_FLASH_BWD[dtype]),
                    "ms": device_ms(lambda: fn(*kernel_args)),
                    "plain_ms": at["plain_ms"],
                    "library_ms": at["library_ms"],
                    **bwd_notes,
                    "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
                    **bound(nbytes, products * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
                })
        print(f"[time] attention backward a training step {name}, computed: each shape's "
              f"device ms a call times its calls a step ({' + '.join(map(str, calls))}, the "
              f"measured dK/dV launches a step; largest batch): kernels {step_ms:.4f} ms, "
              f"SDPA {step_lib_ms:.4f} ms")

        # the forward with dropout at the step's three shapes
        fwd_shapes = attention_shapes(shapes)
        calls = [c for *_, c in fwd_shapes]
        require(sum(calls) * tr["steps"] == tr["total"]["flash_attention_fwd_dropout"],
                f"{calls} attention forward calls a step by the config, but "
                f"{tr['total']['flash_attention_fwd_dropout']} dropout forward launches in "
                f"{tr['steps']} steps")
        step_ms = step_lib_ms = 0.0
        for where, tq, tk, causal, kv_lens, n_calls in fwd_shapes:
            row = attention_fwd_row(b, h, d, tq, tk, causal, kv_lens, dtype, rng, errs,
                                    DROPOUT)
            step_ms += n_calls * row["ms"]
            step_lib_ms += n_calls * row["library_ms"]
            rows.append({
                "name": (f"flash_attention_fwd_dropout[{name}]" if where == "encoder"
                         else f"flash_attention_fwd_dropout_{where}[{name}]"),
                **row,
                **launch_keys("flash_attention_fwd_dropout"),
                "calls_per_step_at_this_shape": n_calls,
                "launches_are": "dropout forward calls at the step's three shapes",
                "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                "tol": TOL_FLASH[dtype],
            })
        print(f"[time] attention forward a training step {name}, computed: each shape's "
              f"device ms a call times its calls a step ({' + '.join(map(str, calls))}, the "
              f"measured dropout forward launches a step; largest batch): kernels "
              f"{step_ms:.4f} ms, SDPA {step_lib_ms:.4f} ms")
    return rows


def head_dim_rows(shapes, errs, launches):
    """The attention kernels at head dim 16 (zero-padded to 32 by the
    wrappers) at the training encoder's shape with dropout 0.1, forward and
    whole backward, beside the same kernels at 32 on the inputs padded
    beforehand (`at_32_ms`: what the pad and the slices cost is the
    difference)."""
    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        pad_head_dim,
    )

    b, t, lens = shapes["b"], shapes["t"], shapes["enc_lens"]
    h, d = 8, 16
    rng = np.random.RandomState(SEED + 8)
    run = launches[("head dim 16 train", torch.float32)]
    rows = []
    for dtype in DTYPES:
        name = DTYPE_NAME[dtype]
        row = attention_fwd_row(b, h, d, t, t, False, lens, dtype, rng, errs, DROPOUT)
        q, k, v = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
                   for _ in range(3))
        kv = torch.from_numpy(lens.astype(np.int32)).cuda()
        qp, kp, vp = (pad_head_dim(z, 32) for z in (q, k, v))
        scale = 1.0 / np.sqrt(d)
        fwd_32 = device_ms(lambda: flash_attention(qp, kp, vp, kv_lengths=kv, sm_scale=scale,
                                                   dropout_rate=DROPOUT,
                                                   dropout_seed=DROPOUT_SEED))
        rows.append({"name": f"flash_attention_fwd_dropout_d16[{name}]", **row,
                     "launches": run["flash_attention_fwd"],
                     "launches_are": "the head-dim-16 test config's two steps and dev pass "
                                     "(its dropout is 0)",
                     "max_abs_err": errs[("flash_attention_fwd_dropout", dtype)],
                     "tol": TOL_FLASH[dtype], "at_32_ms": fwd_32})
        at = attention_bwd_times(b, h, d, t, t, False, lens, dtype, rng)
        args = at["kernel_args"]
        q, k, v, out, lse, dout = (pad_head_dim(z, 32) if z.dim() == 4 else z
                                   for z in args[:6])
        bwd_32 = device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, kv, False,
                                                       scale, DROPOUT, DROPOUT_SEED))
        err = tuple(max(a, c) for a, c in zip(errs[("flash_attention_bwd_dkv", dtype)],
                                               errs[("flash_attention_bwd_dq", dtype)]))
        rows.append({
            "name": f"flash_attention_bwd_d16[{name}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:567-596 (custom VJP: "
                        "delta :468, dK/dV :238, dQ :327)",
            "shape": at["shape"],
            "launches": run["flash_attention_bwd_dkv"],
            "launches_are": "dK/dV launches of the head-dim-16 test config's two steps",
            **bwd_errs(err, TOL_FLASH_BWD[dtype]),
            **{key: at[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "at_32_ms": bwd_32,
        })
    return rows


def attention_fwd_row(b, h, d, tq, tk, causal, lens, dtype, rng, errs, rate) -> dict:
    """The forward kernel at one shape, with dropout `rate` (0, or 0.1 as
    the training path runs it): held to its plain version with the same
    seed, then device ms of the kernel, the plain version and SDPA's
    forward (dropout_p `rate`), and the bound."""
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    es = torch.tensor([], dtype=dtype).element_size()
    q = torch.from_numpy(rng.randn(b, tq, h, d).astype(np.float32)).to("cuda", dtype)
    k, v = (torch.from_numpy(rng.randn(b, tk, h, d).astype(np.float32)).to("cuda", dtype)
            for _ in range(2))
    kv = None if lens is None else torch.from_numpy(lens.astype(np.int32)).cuda()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    if kv is None:
        sdpa = dict(is_causal=causal)
    else:
        sdpa = dict(attn_mask=(torch.arange(tk, device="cuda")[None, :]
                               < kv[:, None])[:, None, None, :])
    seed = DROPOUT_SEED if rate else None

    def kernel():
        return flash_attention(q, k, v, kv_lengths=kv, causal=causal, dropout_rate=rate,
                               dropout_seed=seed)

    def plain():
        return flash_attention_reference(q, k, v, kv, causal, None, rate, seed or 0)

    held_to_plain(
        f"flash dropout={rate} {DTYPE_NAME[dtype]} [{b}, {tq}, {tk}, {h}, {d}] "
        f"causal={causal}", kernel, plain, TOL_FLASH[dtype], errs,
        ("flash_attention_fwd_dropout" if rate else "flash_attention_fwd", dtype))
    key_lens = [tk] * b if lens is None else [min(int(n), tk) for n in lens]
    pairs = h * attention_pairs(tq, key_lens, causal)
    # q read and O written over every query; K and V over the valid keys,
    # where the walk stops; lse written; lengths read.  S and P.V over the
    # valid pairs; the hash's integer operations are not counted
    nbytes = (2 * es * b * tq * h * d + 2 * es * sum(key_lens) * h * d + 4 * b * h * tq
              + (0 if kv is None else 4 * b))
    return {
        "route": "cuda",
        "source": "openasr_torch/kernels/csrc/flash_attention.cu",
        "replaces": "openasr_tpu/kernels/flash_attention.py:146"
                    + (" (hash dropout :78-134)" if rate else ""),
        "shape": [b, tq, tk, h, d],
        "causal": causal,
        "dropout_rate": rate,
        **times(kernel, plain,
                lambda: F.scaled_dot_product_attention(qt, kt, vt, dropout_p=rate, **sdpa)),
        "library_is": f"F.scaled_dot_product_attention (dropout_p {rate}"
                      + (", its own Philox mask" if rate else "")
                      + "; a bool key mask, or is_causal for the decoder)",
        "ops_peak_tflops": MMA_PEAK_FLOPS[dtype] / 1e12,
        **bound(nbytes, 2 * 2 * pairs * d, dtype, MMA_PEAK_FLOPS),
    }


# ------------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    errs, launches = {}, {}
    t_start = time.time()
    try:
        phase_build()
        rng = np.random.RandomState(SEED)
        vocab, chars = write_vocab()
        test_json, test_feats = write_corpus("test", rng, chars, 8, (600, 1200), (12, 12))
        train_json, train_feats = write_corpus("train", rng, chars, 128, (400, 512), (20, 24))
        dev_json, _ = write_corpus("dev", rng, chars, 16, (400, 512), (20, 24))
        wtest_json, wtest = write_wave_corpus("wtest", rng, chars, 8, (160000, 217600),
                                              (12, 12))
        wtrain_json, wtrain = write_wave_corpus("wtrain", rng, chars, 128, (64000, 83200),
                                                (20, 24))
        wdev_json, _ = write_wave_corpus("wdev", rng, chars, 16, (64000, 83200), (20, 24))
        shapes = train_shapes(train_json)
        wbatch = online_train_batch(wtrain_json, wtrain)
        print(f"[shapes] training path's largest batch: B {shapes['b']}, T' {shapes['t']}, "
              f"U {shapes['u']}; online: B {len(wbatch['utts'])}")
        print(f"[time] corpora written at {time.time() - t_start:.1f}s")
        phase_layer_norm(errs)
        phase_layer_norm_bwd(errs, shapes["b"] * shapes["t"])
        phase_flash(errs)
        phase_flash_bwd(errs, shapes)
        phase_fbank(errs, wbatch, wtest)
        print(f"[time] kernel checks done at {time.time() - t_start:.1f}s")
        phase_train_head_dim_16(vocab, chars, rng, launches)

        pkg = os.path.join(WORK, "flagship.pkg")
        save_flagship_package(pkg)
        phase_decode(pkg, vocab, test_json, launches)
        check_logits_against_cpu(pkg, test_feats)
        print(f"[time] decode path done at {time.time() - t_start:.1f}s")
        per = phase_train(train_json, dev_json, vocab, launches)
        check_grads_against_cpu(pkg, train_feats)
        print(f"[time] training path done at {time.time() - t_start:.1f}s")
        online_pkg = os.path.join(WORK, "flagship_online.pkg")
        save_flagship_package(online_pkg, model_cfg=online_model())
        phase_decode(online_pkg, vocab, wtest_json, launches, online=True)
        check_features_against_cpu(wtest)
        print(f"[time] online decode path done at {time.time() - t_start:.1f}s")
        phase_train(wtrain_json, wdev_json, vocab, launches, online=True)
        print(f"[time] online training path done at {time.time() - t_start:.1f}s")
        rows = (fwd_rows(test_feats, errs, launches) + train_rows(shapes, errs, launches, per)
                + head_dim_rows(shapes, errs, launches) + fbank_rows(wbatch, wtest, errs, launches))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[time] {r['name']} {r['shape']}: device ms kernel {r['ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}); launches {r['launches']}")
    print(f"[time] total {time.time() - t_start:.1f}s")
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    # the run drives one card (cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
