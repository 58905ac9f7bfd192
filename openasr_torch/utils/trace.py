"""The port's trace reader: `torch.profiler` Chrome traces, split by kernel
class and joined to the Python source that launched each kernel.

Counterpart of openasr_tpu/utils/xprof.py (`collect_device_events` :25,
`sum_span_us` :68).  A trace holds, beside the host's `cpu_op` and
`python_function` spans, the card's own timing of every kernel, copy and
memset (`cat` `kernel`, `gpu_memcpy`, `gpu_memset`): the device lane,
which is what this module sums.  On the CPU (`device="cpu"`) the lane is
the outermost `cpu_op` spans, which do not overlap on the one thread that
runs a CPU step, so the CPU tests run the same code.

Unlike xprof.py (:48, :63), a trace that cannot be taken or holds no
device-lane event raises: no caller falls back to wall-clock.

- `collect_trace(run, device, ..., steps)` runs `run()` `steps` times
  under the profiler, after one warm-up call that it traces but drops, and
  returns every event of its Chrome trace; `collect_device_events` just
  the lane.  `read_trace(path)` reads a trace that `training.profile`
  wrote (solvers/__init__.py).
- `classify(name)` buckets a kernel (or CPU op) name: gemm, conv,
  attention, layer_norm, fbank, optimizer, loss, copy or other.
- `split_window(lane, steps)` gives each class's ms, calls and share of
  the window (first lane event's start to the last one's end) a step, and
  the idle share: the window less the union of the lane's intervals.  An
  instant covered by two events counts once, for the one that started
  first, so the class shares and the idle share sum to 1.
- `sources(events, lane)` joins each lane event to the `cpu_op` that
  launched it (the kernel's `External id`, else its `correlation` through
  the runtime launch) and to that op's innermost `python_function` frame
  under `root`; a backward op (or an op inside one) takes its forward
  op's frame (`Sequence number`).  Events that join nothing are `(no source)`.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SOURCE = "(no source)"
CLASSES = ("gemm", "conv", "attention", "layer_norm", "fbank", "optimizer", "loss", "copy",
           "other")
# (class, lower-case substrings), first match wins: cuDNN's implicit GEMMs
# and SDPA's CUTLASS kernels must not fall into gemm
_RULES = (
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "winograd", "aten::convolution",
              "aten::_convolution", "convolution_backward", "mkldnn_convolution")),
    ("attention", ("flash_attention", "flash_fwd", "flash_bwd", "fmha",
                   "scaled_dot_product", "efficient_attention")),
    ("layer_norm", ("layer_norm_fwd", "layer_norm_bwd", "column_sum")),
    ("fbank", ("fbank",)),
    ("optimizer", ("multi_tensor_apply", "lpnorm_cleanup", "_foreach_")),
    ("loss", ("ctc_loss",)),
    ("gemm", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas", "splitkreduce",
              "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm")),
    ("copy", ("memcpy", "memset", "copy_kernel", "catarraybatchedcopy", "aten::copy_",
              "aten::cat", "aten::_to_copy", "aten::clone")),
)


def classify(name: str) -> str:
    """The class of a kernel or CPU op name (`CLASSES`)."""
    low = name.lower()
    for cls, keys in _RULES:
        if any(k in low for k in keys):
            return cls
    return "other"


def event_class(e: dict) -> str:
    """A lane event's class: its name's, or on the CPU lane the first in
    `_RULES` order of its own and its enclosed ops' classes
    (`aten::linear` under autocast holds copies and the gemm
    `aten::addmm`: gemm)."""
    found = {classify(name) for name in (e["name"], *e.get("inner", ()))}
    return next((cls for cls, _ in _RULES if cls in found), "other")


def read_trace(path: str) -> List[dict]:
    """The `traceEvents` of a Chrome trace file (.json or .json.gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def spans(events, cat) -> List[dict]:
    """The complete ('X') spans of a category."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat]


def _op_tree(events, root: str) -> dict:
    """For every `cpu_op` (by id()): its innermost enclosing
    `python_function` frame whose name holds `root` (or None), its parent
    op and the ops it encloses directly.  One sweep a thread over the
    spans sorted by start (longest first at a tie), with a stack of the
    open ones."""
    info = {}
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "python_function"):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for thread in by_thread.values():
        thread.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack = []  # (end, innermost frame under root, innermost op)
        for e in thread:
            ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            while stack and stack[-1][0] <= ts:
                stack.pop()
            frame, parent = stack[-1][1:] if stack else (None, None)
            if e["cat"] == "cpu_op":
                info[id(e)] = {"frame": frame, "parent": parent, "children": []}
                if parent is not None:
                    info[id(parent)]["children"].append(e)
                stack.append((end, frame, e))
            else:
                name = e.get("name", "")
                stack.append((end, name[name.index(root):] if root in name else frame, parent))
    return info


def device_lane(events: List[dict], device: str = "cuda") -> List[dict]:
    """The lane events of a trace: the card's kernels, copies and memsets,
    or on the CPU the outermost `cpu_op` spans (their self time is the
    CPU's compute), each with `inner`, the names of the ops it encloses."""
    if device != "cpu":
        return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    info = _op_tree(events, "openasr_torch/")
    lane = []
    for e in spans(events, "cpu_op"):
        if info[id(e)]["parent"] is None:
            inner, todo = [], list(info[id(e)]["children"])
            while todo:
                c = todo.pop()
                inner.append(c["name"])
                todo += info[id(c)]["children"]
            lane.append({**e, "inner": inner})
    return lane


def collect_trace(run: Callable[[], None], device: str = "cuda", prefix: str = "openasr_trace_",
                  with_stack: bool = False, record_shapes: bool = False,
                  steps: int = 1) -> List[dict]:
    """Run `run()` `steps` times under `torch.profiler` (CPU activities, and
    CUDA's on the card) and return every event of its Chrome trace.  One
    more call runs first as the profiler's warm-up step, traced but not
    kept: the first kernels after the tracer starts can go unrecorded.  The
    card is synchronised before the window closes.  Raises when the trace
    holds no device-lane event."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(
                activities=activities, with_stack=with_stack, record_shapes=record_shapes,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=steps),
                on_trace_ready=lambda prof: prof.export_chrome_trace(path)) as prof:
            for i in range(steps + 1):
                run()
                if i == steps and device != "cpu":
                    torch.cuda.synchronize()
                prof.step()
        if not os.path.exists(path):
            raise RuntimeError("torch.profiler wrote no trace")
        events = read_trace(path)
    if not device_lane(events, device):
        raise RuntimeError(f"the {device} trace holds no device-lane event "
                           f"({', '.join(DEVICE_CATS) if device != 'cpu' else 'cpu_op'})")
    return events


def collect_device_events(run: Callable[[], None], prefix: str = "openasr_trace_",
                          device: str = "cuda", steps: int = 1) -> List[dict]:
    """The device-lane events of `steps` calls of `run()` (`collect_trace`,
    `device_lane`)."""
    return device_lane(collect_trace(run, device, prefix, steps=steps), device)


def dedupe(lane: List[dict]) -> List[dict]:
    """The lane without repeats of a (name, ts), sorted by start."""
    seen, out = set(), []
    for e in sorted(lane, key=lambda e: float(e["ts"])):
        key = (e.get("name"), e["ts"])
        if key not in seen:
            seen.add(key)
            out.append(e)
    return out


def sum_span_us(events: List[dict], name_prefix: str = "") -> float:
    """Total duration (us) of the spans whose name starts with
    `name_prefix` (every span with the default "")."""
    return float(sum(float(e.get("dur", 0.0)) for e in events
                     if e.get("name", "").startswith(name_prefix)))


def split_window(lane: List[dict], steps: int = 1) -> dict:
    """Each class's device ms, calls and share of the window a step, and
    the idle share.  -> {"steps", "span_ms", "busy_ms", "overlap_ms" (the
    lane's summed durations less its union), "idle_share", "classes":
    {class: {"ms", "calls", "share"}}} with ms and calls a step."""
    lane = dedupe(lane)
    if not lane:
        raise ValueError("an empty lane has no window")
    start = float(lane[0]["ts"])
    end = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in lane)
    span = end - start
    us = dict.fromkeys(CLASSES, 0.0)
    calls = dict.fromkeys(CLASSES, 0)
    covered, raw = start, 0.0
    for e in lane:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        cls = event_class(e)
        us[cls] += max(0.0, ts + dur - max(ts, covered))
        calls[cls] += 1
        covered = max(covered, ts + dur)
        raw += dur
    busy = sum(us.values())
    share = (lambda x: x / span) if span > 0 else (lambda x: 0.0)
    return {
        "steps": steps, "span_ms": span / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
        "overlap_ms": max(0.0, raw - busy) / 1e3 / steps, "idle_share": 1.0 - share(busy),
        "classes": {c: {"ms": us[c] / 1e3 / steps, "calls": calls[c] / steps,
                        "share": share(us[c])} for c in CLASSES},
    }


def sources(events: List[dict], lane: List[dict], root: str = "openasr_torch/") -> List[str]:
    """Each lane event's source: the innermost frame under `root` of the op
    that launched it (of the event itself on the CPU lane), its forward
    op's for a backward op, else NO_SOURCE."""
    info = _op_tree(events, root)
    ops = spans(events, "cpu_op")
    by_ext = {e["args"]["External id"]: e for e in ops if "External id" in e.get("args", {})}
    ext_of_corr = {}
    for e in events:
        args = e.get("args") or {}
        if (e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args
                and "External id" in args):
            ext_of_corr[args["correlation"]] = args["External id"]
    forward = {}
    for e in ops:
        args = e.get("args", {})
        if "Sequence number" in args and not args.get("Fwd thread id"):
            forward.setdefault(args["Sequence number"], e)

    def frame_of(op) -> Optional[str]:
        o = op
        while o is not None:  # a backward op's source is its forward op's
            args = o.get("args", {})
            fwd = forward.get(args.get("Sequence number")) if args.get("Fwd thread id") else None
            if fwd is not None and info[id(fwd)]["frame"] is not None:
                return info[id(fwd)]["frame"]
            o = info[id(o)]["parent"]
        return info[id(op)]["frame"]

    out = []
    for e in lane:
        if e.get("cat") == "cpu_op":
            op = by_ext.get(e.get("args", {}).get("External id"), e)
        else:
            args = e.get("args") or {}
            ext = args.get("External id")
            if ext not in by_ext:
                ext = ext_of_corr.get(args.get("correlation"))
            op = by_ext.get(ext)
        frame = frame_of(op) if op is not None and id(op) in info else None
        out.append(frame or NO_SOURCE)
    return out


def by_name(lane: List[dict]) -> Dict[str, dict]:
    """{name: {"us", "calls", "class"}} of a (deduped) lane."""
    out: Dict[str, dict] = {}
    for e in dedupe(lane):
        row = out.setdefault(e["name"], {"us": 0.0, "calls": 0, "class": event_class(e)})
        row["us"] += float(e.get("dur", 0.0))
        row["calls"] += 1
    return out
