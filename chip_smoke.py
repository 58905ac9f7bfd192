#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
`openasr_torch/kernels/csrc/`, holds each kernel against its plain PyTorch
version on the card, then decodes 8 random-feature utterances through
`openasr_torch.bin.infer` at the full width of the flagship
conv-ctc-transformer (egs/aishell1/configs/conv-ctc-transformer.yaml:
ConvV2, d512, 6+6 post-LN layers, 8 heads, GLU 2048, vocab 4233) with
random weights from a fixed seed, in float32 and in bfloat16, and shows
through the kernels' launch counters that the decode ran through them.

It prints the card's name and power limit, a `{"kernels": [...]}` line
with each kernel's error, launches, times and bound, and last
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
SEED = 1234

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL_LN = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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


# --------------------------------------------------------------- phase 1

def phase_build():
    from openasr_torch import kernels

    t0 = time.time()
    so = kernels.build_library()
    kernels.library()
    secs = time.time() - t0
    print(f"[build] {so.name} in {secs:.1f}s (sm_90a)")
    print(nvidia_smi())


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
        for n in (2400, 40):
            x, g, b = ln_inputs(n, 512, dtype, rng)
            y, mu, rs = fused_layer_norm(x, g, b)
            torch.cuda.synchronize()
            y_r, mu_r, rs_r = layer_norm_reference(x, g, b)
            e = max_err(y, y_r)
            e_stats = max(max_err(mu, mu_r), max_err(rs, rs_r))
            tol = TOL_LN[dtype]
            print(f"[layer_norm] [{n}, 512] {DTYPE_NAME[dtype]}: y err {e:.3g}, "
                  f"stats err {e_stats:.3g} (tol {tol})")
            require(e <= tol and e_stats <= 1e-5,
                    f"layer_norm [{n}, 512] {DTYPE_NAME[dtype]} disagrees")
            errs[("layer_norm", dtype)] = max(errs.get(("layer_norm", dtype), 0.0), e)


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
    for dtype in DTYPES:
        for b, h, d, tq, tk, causal in cases:
            q, k, v, lens = flash_case(b, h, d, tq, tk, dtype, rng)
            out, lse = flash_attention(q, k, v, kv_lengths=lens, causal=causal)
            torch.cuda.synchronize()
            out_r, lse_r = flash_attention_reference(q, k, v, lens, causal)
            e = max_err(out, out_r)
            e_lse = max_err(lse, lse_r)
            tol = TOL_FLASH[dtype]
            zero_row = float(out[-1].float().abs().max())
            print(f"[flash] B{b} H{h} D{d} Tq{tq} Tk{tk} causal={causal} "
                  f"{DTYPE_NAME[dtype]}: out err {e:.3g}, lse err {e_lse:.3g} "
                  f"(tol {tol})")
            require(e <= tol and e_lse <= 1e-3 and zero_row == 0.0,
                    f"flash {tq}x{tk} causal={causal} {DTYPE_NAME[dtype]} disagrees")
            if d == 64:
                key = ("flash_attention", dtype)
                errs[key] = max(errs.get(key, 0.0), e)


# --------------------------------------------------------------- phase 4

def write_corpus(rng):
    """8 utterances of 600-1200 random 80-dim frames as ark/scp + json,
    and a 4229-character vocabulary (4233 ids with the specials)."""
    from openasr_torch.data.kaldi_io import write_ark_scp

    chars = [chr(0x4E00 + i) for i in range(4229)]
    vocab = os.path.join(WORK, "chars.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("".join(c + "\n" for c in chars))
    feats = {
        f"utt{i:02d}": rng.randn(int(rng.randint(600, 1201)), 80).astype(np.float32)
        for i in range(8)
    }
    write_ark_scp(os.path.join(WORK, "feats"), feats.items())
    rows = []
    with open(os.path.join(WORK, "feats.scp")) as f:
        for line in f:
            utt, path = line.split()
            toks = " ".join(rng.choice(chars, size=12))
            rows.append({"uttid": utt, "feat": path,
                         "feat_length": feats[utt].shape[0],
                         "tokens": toks, "token_length": 12})
    manifest = os.path.join(WORK, "test.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    return vocab, manifest, feats


def save_flagship_package():
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import save_package

    model = get_model_class("conv-ctc-transformer").create_model(
        FLAGSHIP, device="cuda", generator=torch.Generator().manual_seed(SEED)
    )
    path = os.path.join(WORK, "flagship.pkg")
    save_package(model.package(), path)
    return path


def phase_main_path(pkg, vocab, manifest, launches):
    """Decode through the CLI in both dtypes; counters reset just before
    each run and read just after."""
    from openasr_torch.bin import infer
    from openasr_torch.data.manifest import ArkDataset
    from openasr_torch.data.sampler import FrameBasedSampler
    from openasr_torch.kernels.flash_attention import flash_attention
    from openasr_torch.kernels.layer_norm import fused_layer_norm

    n_batches = len(FrameBasedSampler(
        ArkDataset(manifest, feat_range=(1, 10**9), label_range=(0, 10**9),
                   rate_in_out=(0, 10**9)), 36000))
    n_utts = len(json.load(open(manifest)))
    for dtype in DTYPES:
        hyp = os.path.join(WORK, f"hyp_{DTYPE_NAME[dtype]}.txt")
        argv = ["--model_type", "conv-ctc-transformer", "--model_pkg", pkg,
                "--vocab_path", vocab, "--json_file", manifest, "--output", hyp,
                "--offline", "--add_blk", "--nbest", "5", "--maxlen", "40",
                "--batch_frames", "36000", "--dtype", DTYPE_NAME[dtype],
                "--device", "cuda"]
        torch.cuda.synchronize()
        flash_attention.launches = 0
        fused_layer_norm.launches = 0
        t0 = time.time()
        infer.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_flash, n_ln = flash_attention.launches, fused_layer_norm.launches
        launches[("flash_attention", dtype)] = n_flash
        launches[("layer_norm", dtype)] = n_ln
        with open(hyp, encoding="utf-8") as f:
            lines = [line for line in f if line.strip()]
        print(f"[main path] {DTYPE_NAME[dtype]}: {len(lines)} hyps in {wall:.2f}s wall, "
              f"{n_batches} batch(es); launches: flash_attention {n_flash}, "
              f"layer_norm {n_ln}")
        require(len(lines) == n_utts, f"{len(lines)} hyp lines for {n_utts} utterances")
        require(n_flash >= 6 * n_batches, f"flash launched {n_flash} times")
        require(n_ln >= 13 * n_batches, f"layer_norm launched {n_ln} times")


def check_against_cpu(pkg, feats):
    """The card's f32 encoder and teacher-forced decoder (kernels) against
    the same package on the CPU (plain versions), on two utterances."""
    from openasr_torch.config import Config
    from openasr_torch.data.collate import quantize
    from openasr_torch.models import get_model_class
    from openasr_torch.utils.checkpoint import load_package

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = load_package(pkg)
    utts = sorted(feats)[:2]
    lengths = np.array([feats[u].shape[0] for u in utts], np.int32)
    x = np.zeros((2, quantize(int(lengths.max())), 80), np.float32)
    for i, u in enumerate(utts):
        x[i, : lengths[i]] = feats[u]
    ids = np.random.RandomState(SEED).randint(3, 4232, size=(2, 12)).astype(np.int64)
    outs = {}
    for device in ("cuda", "cpu"):
        model = get_model_class("conv-ctc-transformer").create_model(
            Config(pkg["configs"]), device=device
        )
        model.restore(pkg)
        with torch.inference_mode():
            ctc, elens, ce = model.module(
                torch.from_numpy(x).to(device), torch.from_numpy(lengths).to(device),
                torch.from_numpy(ids).to(device),
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

def encoder_shapes(feats):
    """The main path's encoder batch: B, padded T' after ConvV2, lengths."""
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


def held_to_plain(name, kernel, plain, tol, errs, key) -> None:
    """Kernel against plain version at a main-path shape; the first
    outputs (y, O) are compared and the error joins the kernel's max."""
    got, want = kernel()[0], plain()[0]
    torch.cuda.synchronize()
    e = max_err(got, want)
    print(f"[{name}] main-path shape: err {e:.3g} (tol {tol})")
    require(e <= tol, f"{name} disagrees at the main path's shape")
    errs[key] = max(errs[key], e)


def kernel_rows(feats, errs, launches):
    import torch.nn.functional as F

    from openasr_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from openasr_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

    b, t, lens = encoder_shapes(feats)
    h, d, dm = 8, 64, 512
    rng = np.random.RandomState(SEED + 2)
    rows = []
    for dtype in DTYPES:
        es = torch.tensor([], dtype=dtype).element_size()
        n = b * t
        x, g, beta = ln_inputs(n, dm, dtype, rng)
        g_l, b_l = g.to(dtype), beta.to(dtype)
        held_to_plain(f"layer_norm {DTYPE_NAME[dtype]} [{n}, {dm}]",
                      lambda: fused_layer_norm(x, g, beta),
                      lambda: layer_norm_reference(x, g, beta),
                      TOL_LN[dtype], errs, ("layer_norm", dtype))
        ln_bytes = 2 * n * dm * es + 2 * dm * 4 + 2 * n * 4
        ln_flops = 8 * n * dm
        ln_bound = max(ln_bytes / HBM_BYTES_PER_S, ln_flops / PEAK_FLOPS[torch.float32])
        rows.append({
            "name": f"layer_norm_fwd[{DTYPE_NAME[dtype]}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/layer_norm.cu",
            "replaces": "openasr_tpu/kernels/layer_norm.py:56",
            "shape": [n, dm],
            "launches": launches[("layer_norm", dtype)],
            "max_abs_err": errs[("layer_norm", dtype)],
            "tol": TOL_LN[dtype],
            **times(
                lambda: fused_layer_norm(x, g, beta),
                lambda: layer_norm_reference(x, g, beta),
                lambda: F.layer_norm(x, (dm,), g_l, b_l, 1e-6),
            ),
            "bound_ms": ln_bound * 1e3,
            "bound_by": "bytes" if ln_bytes / HBM_BYTES_PER_S >= ln_flops / PEAK_FLOPS[torch.float32] else "operations",
        })

        q, k, v = (
            torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to("cuda", dtype)
            for _ in range(3)
        )
        kv = torch.from_numpy(lens.astype(np.int32)).cuda()
        mask = (torch.arange(t, device="cuda")[None, :] < kv[:, None])[:, None, None, :]
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        held_to_plain(f"flash {DTYPE_NAME[dtype]} [{b}, {t}, {h}, {d}]",
                      lambda: flash_attention(q, k, v, kv_lengths=kv),
                      lambda: flash_attention_reference(q, k, v, kv),
                      TOL_FLASH[dtype], errs, ("flash_attention", dtype))
        # Q read and O written over all rows; K and V read only over the
        # valid keys, where the kernel's key loop stops; lse f32, lengths
        valid = int(lens.clip(0, t).sum())
        fa_bytes = es * (2 * b * t * h * d + 2 * valid * h * d) + 4 * b * h * t + 4 * b
        fa_flops = 4 * t * valid * h * d
        peak = PEAK_FLOPS[dtype]
        rows.append({
            "name": f"flash_attention_fwd[{DTYPE_NAME[dtype]}]",
            "route": "cuda",
            "source": "openasr_torch/kernels/csrc/flash_attention.cu",
            "replaces": "openasr_tpu/kernels/flash_attention.py:146",
            "shape": [b, t, h, d],
            "launches": launches[("flash_attention", dtype)],
            "max_abs_err": errs[("flash_attention", dtype)],
            "tol": TOL_FLASH[dtype],
            **times(
                lambda: flash_attention(q, k, v, kv_lengths=kv),
                lambda: flash_attention_reference(q, k, v, kv),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            ),
            "bound_ms": max(fa_bytes / HBM_BYTES_PER_S, fa_flops / peak) * 1e3,
            "bound_by": "bytes" if fa_bytes / HBM_BYTES_PER_S >= fa_flops / peak else "operations",
        })
    for r in rows:
        print(f"[time] {r['name']} {r['shape']}: device ms kernel {r['ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


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
    try:
        phase_build()
        phase_layer_norm(errs)
        phase_flash(errs)
        rng = np.random.RandomState(SEED)
        vocab, manifest, feats = write_corpus(rng)
        pkg = save_flagship_package()
        phase_main_path(pkg, vocab, manifest, launches)
        check_against_cpu(pkg, feats)
        rows = kernel_rows(feats, errs, launches)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(nvidia_smi())
    print(json.dumps({"kernels": rows}))
    # the run drives one card (cuda:0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
