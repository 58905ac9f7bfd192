"""Profile the flagship train step: an inventory of its matmuls and
convolutions, and its device time by kernel class, source line and kernel.

Counterpart of tools/profile_step.py, importing nothing of the JAX package:

    python -m openasr_torch.bin.profile_step [--ops] [--trace] [--fast]
        [--model {flagship,cif,wide,online}] [--device cuda|cpu]
        [--dtype bfloat16|float32]

It builds `bench.py`'s step (a copy of its configs, batches and training
section; `--fast` is its BENCH_FAST shape, BENCH_B / BENCH_T override the
batch as there) with the port's model and solver, on the card unless
`--device cpu`, forward in `--dtype` (bf16 autocast over f32 weights, as
`bench.py` builds the model).

--ops    one step under `torch.profiler` with `record_shapes` (after its
         warm-up step, which builds the kernels and the moments): every
         matmul and convolution dispatched forward and backward (op, output
         dtype, operand dtypes, output shape, estimated GFLOP), f32
         operands flagged and counted.  It takes the place of the JAX
         tool's `--hlo` (the optimized HLO's dot inventory), which has no
         counterpart in eager PyTorch.
--trace  2 warm steps, 5 steps timed on the host clock without the
         profiler, then 5 profiled steps after the profiler's warm-up step
         (utils/trace.py): the device
         ms a step and share of each kernel class and the idle share; then
         one more step with Python stacks, each kernel joined to the op that
         launched it and to that op's innermost frame in openasr_torch/
         (the JAX tool's HLO `source_file` join), the top 25 such frames;
         and the top kernels with their calls a step and their class.
         The stacks' host cost would inflate the idle share, hence the two
         windows.  The JAX tool's HLO byte estimates (its GB touched and
         GB/s a class and an op) have no counterpart here.

With neither flag it runs both.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import tempfile

import numpy as np
import torch

from openasr_torch.bin.infer import resolve_device
from openasr_torch.config import Config
from openasr_torch.models import get_model_class
from openasr_torch.solvers import batch_to_device, get_solver_class
from openasr_torch.utils import trace
from openasr_torch.utils.timer import Timer

# bench.py's shape (bench.py:36-44)
VOCAB = 4233
D = 80
U = 24
NHEAD = 8
WARM_STEPS = 2
TRACE_STEPS = 5
SOURCE_STEPS = 1  # the Python stacks' trace is large: one step suffices
TOP_SOURCES = 25


def shape(fast=None) -> dict:
    """bench.py's B, T, D_MODEL, LAYERS and FFN (BENCH_FAST, unless `fast`
    is given, BENCH_B and BENCH_T read as there, at call time)."""
    if fast is None:
        fast = os.environ.get("BENCH_FAST", "0") == "1"
    d_model = 256 if fast else 512
    return {"B": 8 if fast else int(os.environ.get("BENCH_B", "64")),
            "T": 256 if fast else int(os.environ.get("BENCH_T", "512")),
            "D_MODEL": d_model, "LAYERS": 2 if fast else 6, "FFN": 4 * d_model}


def make_batch(fast=None) -> dict:
    s = shape(fast)
    b, t = s["B"], s["T"]
    rng = np.random.RandomState(0)
    paddings = np.zeros((b, U), np.float32)
    paddings[:, U - 4:] = 1.0
    return {
        "feats": rng.randn(b, t, D).astype(np.float32),
        "feat_lengths": np.linspace(t * 3 // 4, t, b).astype(np.int32),
        "ids": rng.randint(3, VOCAB - 1, (b, U)).astype(np.int32),
        "labels": rng.randint(3, VOCAB - 1, (b, U)).astype(np.int32),
        "paddings": paddings,
    }


def flagship_cfg(fast=None) -> dict:
    s = shape(fast)
    return {
        "type": "conv-ctc-transformer",
        "add_eos": True,
        "add_blk": True,
        "signal": {"feature_type": "offline"},
        "encoder": {"type": "Transformer",
                    "sub": {"type": "ConvV2", "layer_num": 2},
                    "input_dim": D, "d_model": s["D_MODEL"], "nhead": NHEAD,
                    "dim_feedforward": s["FFN"], "activation": "glu",
                    "num_layers": s["LAYERS"], "dropout_rate": 0.1},
        "decoder": {"type": "TransformerDecoder", "vocab_size": VOCAB,
                    "d_model": s["D_MODEL"], "nhead": NHEAD, "num_layers": s["LAYERS"],
                    "encoder_dim": s["D_MODEL"], "dim_feedforward": s["FFN"],
                    "activation": "glu", "dropout_rate": 0.1},
    }


def cif_cfg(fast=None) -> dict:
    s = shape(fast)
    cfg = flagship_cfg(fast)
    cfg["type"] = "ctc_cif"
    cfg["assigner"] = {"d_model": s["D_MODEL"], "n_layers": 2, "w_context": 3,
                       "dropout": 0.1}
    cfg["decoder"] = dict(cfg["decoder"], type="CIF_Decoder", num_layers=s["LAYERS"] // 2)
    return cfg


def wide_cfg(fast=None) -> dict:
    d = 1024
    cfg = flagship_cfg(fast)
    cfg["encoder"] = dict(cfg["encoder"], d_model=d, dim_feedforward=4 * d, nhead=16)
    cfg["decoder"] = dict(cfg["decoder"], d_model=d, dim_feedforward=4 * d, nhead=16,
                          encoder_dim=d)
    return cfg


def online_cfg(fast=None) -> dict:
    cfg = flagship_cfg(fast)
    cfg["signal"] = {
        "feature_type": "fbank", "num_mel_bins": D, "sample_rate": 16000,
        "spec_aug": {"freq_mask_num": 2, "freq_mask_width": 27,
                     "time_mask_num": 2, "time_mask_width": 40},
    }
    return cfg


def make_wave_batch(fast=None) -> dict:
    s = shape(fast)
    b, t = s["B"], s["T"]
    n = (t - 1) * 160 + 400  # samples yielding exactly T fbank frames
    rng = np.random.RandomState(1)
    base = make_batch(fast)
    return {
        "waves": (rng.randn(b, n) * 0.1).astype(np.float32),
        "wave_lengths": np.linspace(n * 3 // 4, n, b).astype(np.int32),
        "ids": base["ids"],
        "labels": base["labels"],
        "paddings": base["paddings"],
    }


CONFIGS = {"flagship": flagship_cfg, "cif": cif_cfg, "wide": wide_cfg, "online": online_cfg}


def training_config(exp_dir: str, fast=None) -> Config:
    """The JAX tool's training section (tools/profile_step.py:40-48)."""
    return Config({
        "num_epoch": 1, "exp_dir": exp_dir,
        "print_inteval": 10**9, "accumulate_grad_batch": 1,
        "init_lr": 1.0, "optimtype": "adam", "grad_max_norm": 50.0,
        "label_smooth": 0.1, "lambda_ctc": 1.0, "lambda_qua": 1.0,
        "lr_scheduler": {"type": "warmup_transformer", "warmup_step": 10000,
                         "d_model": shape(fast)["D_MODEL"]},
    })


def build_step(model_name: str, fast, device: torch.device, dtype: torch.dtype, exp_dir: str):
    """-> step(): one train step (forward, backward, clip + Adam) of
    `model_name` on bench.py's batch, returning its losses."""
    cfg = Config(CONFIGS[model_name](fast))
    model = get_model_class(cfg.type).create_model(cfg, device=device)
    solver = get_solver_class(cfg.type)(model, training_config(exp_dir, fast), [], [],
                                        device=device, compute_dtype=dtype)
    raw = make_wave_batch(fast) if model_name == "online" else make_batch(fast)
    arrays = batch_to_device(raw, device)
    empty_rows = model.has_empty_rows(model.batch_inputs(raw)[1])

    def step():
        losses = solver.grad_step(arrays, empty_rows)
        solver.apply_update()
        return losses

    return step


# ---------------------------------------------------------------- --ops

# the operands' positions among each product's inputs
MATMUL_OPS = {"aten::mm": (0, 1), "aten::addmm": (1, 2), "aten::bmm": (0, 1),
              "aten::baddbmm": (1, 2)}
DTYPE_NAMES = {"float": "f32", "c10::BFloat16": "bf16", "c10::Half": "f16", "double": "f64"}


def _ints(text: str) -> list:
    return [int(x) for x in re.findall(r"-?\d+", text)]


def op_entry(e: dict):
    """(op, output dtype, operand dtypes, output shape, GFLOP) of a matmul
    or convolution `cpu_op` span recorded with shapes, else None."""
    name, args = e["name"], e.get("args", {})
    dims, types = args.get("Input Dims"), args.get("Input type")
    if not dims or not types:
        return None
    if name in MATMUL_OPS:
        a, b = MATMUL_OPS[name]
        x, w = dims[a], dims[b]
        out = [*x[:-1], w[-1]]
        flops = 2.0 * float(np.prod(out)) * x[-1]
        operands = (types[a], types[b])
    elif name == "aten::convolution":
        x, w = dims[0], dims[1]
        conc = args.get("Concrete Inputs", [])
        stride, pad, dil = (_ints(conc[i]) for i in (3, 4, 5))
        spatial = [(n + 2 * p - d * (k - 1) - 1) // s + 1
                   for n, k, s, p, d in zip(x[2:], w[2:], stride, pad, dil)]
        out = [x[0], w[0], *spatial]
        flops = 2.0 * float(np.prod(out)) * float(np.prod(w[1:]))
        operands = (types[0], types[1])
    elif name == "aten::convolution_backward":
        out, w = dims[0], dims[2]  # the gradient of the output: the forward's shape
        mask = args.get("Concrete Inputs", [""] * 11)[10]
        grads = max(1, sum(m == "True" for m in re.findall(r"True|False", mask)[:2]))
        flops = 2.0 * float(np.prod(out)) * float(np.prod(w[1:])) * grads
        operands = (types[0], types[1], types[2])
    else:
        return None
    short = tuple(DTYPE_NAMES.get(t, t) for t in operands)
    return name, short[0], short, tuple(out), flops / 1e9


def ops_report(step, device: torch.device) -> dict:
    """The matmul and convolution inventory of one step (printed)."""
    events = trace.collect_trace(step, device.type, "openasr_ops_", record_shapes=True)
    inventory = collections.Counter()
    gflop = collections.Counter()
    for e in trace.spans(events, "cpu_op"):
        entry = op_entry(e)
        if entry is not None:
            inventory[entry[:4]] += 1
            gflop[entry[:4]] += entry[4]
    print("\n=== matmul / conv inventory (op, out dtype, operand dtypes, out shape) ===")
    f32 = 0
    for key, n in sorted(inventory.items()):
        op, od, ods, out = key
        flag = ""
        if "f32" in ods:
            flag = "  <-- F32 OPERANDS"
            f32 += n
        print(f"{n:3d}x {op} out={od}{list(out)} in={ods} {gflop[key]:.3f} GFLOP{flag}")
    total = sum(gflop.values())
    print(f"\nf32-operand matmul/conv count: {f32}")
    print(f"estimated GFLOP a step: {total:.2f}")
    return {"inventory": inventory, "f32_count": f32, "gflop": total}


# ---------------------------------------------------------------- --trace

def trace_report(step, device: torch.device) -> dict:
    """Class split, idle share, source lines and top kernels (printed)."""
    n_steps = TRACE_STEPS

    def run(n):
        for _ in range(n):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize()

    run(WARM_STEPS)
    with Timer() as wall:
        run(n_steps)
    wall_ms = wall.elapsed * 1e3 / n_steps

    lane = trace.device_lane(
        trace.collect_trace(step, device.type, "openasr_prof_", steps=n_steps), device.type)
    split = trace.split_window(lane, n_steps)
    print(f"\n=== device lane over {n_steps} steps ({device.type}): window "
          f"{split['span_ms']:.3f} ms a step, busy {split['busy_ms']:.3f} ms, "
          f"overlap {split['overlap_ms']:.3f} ms ===")
    print("\n--- class totals ---")
    for c, row in split["classes"].items():
        print(f"{c:>10s}: {row['ms']:8.3f} ms/step ({100 * row['share']:5.1f}%) "
              f"x{row['calls']:g}")
    print(f"{'idle':>10s}: {100 * split['idle_share']:5.1f}% of the window")
    print(f"step wall without the profiler: {wall_ms:.3f} ms ({device.type}); the traced "
          f"lane's busy {split['busy_ms']:.3f} ms is {100 * split['busy_ms'] / wall_ms:.1f}% of it")

    stacked = trace.collect_trace(step, device.type, "openasr_src_", with_stack=True,
                                  steps=SOURCE_STEPS)
    src_lane = trace.dedupe(trace.device_lane(stacked, device.type))
    src_us = collections.Counter()
    for e, src in zip(src_lane, trace.sources(stacked, src_lane)):
        src_us[src] += float(e.get("dur", 0.0)) / SOURCE_STEPS
    print(f"\n--- top source lines (device ms/step, {SOURCE_STEPS} step(s) with Python "
          "stacks) ---")
    for src, us in src_us.most_common(TOP_SOURCES):
        print(f"{us / 1e3:8.3f} ms  {src}")
    print(f"{src_us.get(trace.NO_SOURCE, 0.0) / 1e3:8.3f} ms  {trace.NO_SOURCE} "
          f"(of {sum(src_us.values()) / 1e3:.3f} ms)")

    names = trace.by_name(lane)
    top = int(os.environ.get("PROFILE_TOP", "50"))
    total = sum(r["us"] for r in names.values())
    shown = 0.0
    print("\n--- top kernels ---")
    for name, r in sorted(names.items(), key=lambda kv: -kv[1]["us"])[:top]:
        print(f"{r['us'] / 1e3 / n_steps:8.3f} ms x{r['calls'] / n_steps:<5g} "
              f"[{r['class']:>10s}] {name[:90]}")
        shown += r["us"]
    print(f"[shown {shown / 1e3 / n_steps:.3f} ms of {total / 1e3 / n_steps:.3f} ms]")
    return {"split": split, "kernels": names, "sources": src_us, "wall_ms": wall_ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--model", default="flagship", choices=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    if not (args.ops or args.trace):
        args.ops = args.trace = True
    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    fast = True if args.fast else None
    out = {}
    with tempfile.TemporaryDirectory(prefix="openasr_profile_") as exp_dir:
        step = build_step(args.model, fast, device, dtype, exp_dir)
        if args.ops:
            out["ops"] = ops_report(step, device)
        if args.trace:
            out["trace"] = trace_report(step, device)
    return out


if __name__ == "__main__":
    main()
