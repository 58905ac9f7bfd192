"""The port's trace reader (`openasr_torch/utils/trace.py`) and the two
tools that read through it, `bin/profile_step.py` and `bin/bench_flash.py`,
on the CPU.

The reader is held to a handwritten Chrome trace with kernel names as the
card's profiler writes them, whose class totals, calls, idle share and
unjoined kernels are worked out by hand below.  profile_step's copies of
bench.py's configs and batches must equal bench.py's exactly, and its CLI
runs end to end; bench_flash's chains must equal SDPA's in f32 (1e-5 the
output, 1e-4 the gradient).
"""

import importlib
import sys

import numpy as np
import pytest
import torch

from openasr_torch.bin import bench_flash, profile_step
from openasr_torch.utils import trace


def _op(name, ts, dur, ext, tid=1, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": {"External id": ext, **args}}


def _frame(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def _kernel(name, ts, dur, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": args}


FLASH = "void flash_attention_fwd_kernel<Bf16Ops, 64, true>(Args)"
GEMM = ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
        "_execute_segment_k_off_kernel__5x_cublas")
LN_BWD = "void layer_norm_bwd_kernel<__nv_bfloat16, 8, 2, true>(BwdArgs)"
FPROP = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64"
         "_warpgroupsize1x1x1_g1_execute_kernel__5x_cudnn")
ADAM = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
        "(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::"
        "BinaryOpListAlphaFunctor<float, 2, 2, 0>, std::multiplies<float>, float>(...)")
MEMCPY = "Memcpy HtoD (Pageable -> Device)"
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, "
       "float, float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >"
       "(int, at::native::BinaryFunctor<float, float, float, at::native::binary_internal::"
       "MulFunctor<float> >, std::array<char*, 3ul>)")
COLUMN_SUM = "void column_sum_kernel<8>(float const*, int, int, float*, float*)"


def handwritten_trace():
    """Host spans: thread 1 runs the forward and the optimizer, thread 2
    the autograd engine (no Python frames there).  Device lane (us):
    attention [100, 140], gemm [140, 170] (and a mirrored copy of it),
    layer_norm [180, 190], conv [185, 205] (overlapping it by 5), optimizer
    [210, 218] (joined through its launch's correlation), copy [220, 224],
    other [230, 236] (a backward op, joined through its forward op's
    sequence number), layer_norm [240, 245] with no correlation at all."""
    host = [
        _frame("openasr_torch/models/layers.py(100): forward", -1, 20),
        _op("openasr::flash_fwd", 0, 10, 1),
        _op("aten::addmm", 12, 5, 2),
        _frame("/work/openasr_torch/kernels/layer_norm.py(50): layer_norm_bwd", 19, 7),
        _op("openasr::layer_norm_bwd", 20, 5, 3),
        _frame("openasr_torch/models/subsample.py(51): forward", 28, 10),
        _frame("torch/nn/modules/conv.py(10): forward", 29, 8),
        _op("aten::convolution", 30, 5, 4),
        _frame("openasr_torch/models/layers.py(200): glu", 44, 5),
        _op("aten::mul", 45, 3, 10, **{"Sequence number": 7, "Fwd thread id": 0}),
        _frame("openasr_torch/solvers/__init__.py(130): batch_to_device", 49, 6),
        _op("aten::to", 50, 4, 8),
        _op("aten::copy_", 51, 2, 7),
        _frame("openasr_torch/ops/fused_adam.py(86): step", 69, 12),
        _op("aten::_foreach_mul_", 70, 10, 5),
        _op("autograd::engine::evaluate_function: MulBackward0", 60, 10, 9, tid=2,
            **{"Sequence number": 7, "Fwd thread id": 1}),
        _op("aten::mul", 61, 5, 6, tid=2),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 71, "dur": 2, "args": {"External id": 5, "correlation": 15}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 15, "pid": 1, "tid": 1, "ts": 71},
    ]
    device = [
        _kernel(FLASH, 100, 40, **{"External id": 1, "correlation": 11}),
        _kernel(GEMM, 140, 30, **{"External id": 2, "correlation": 12}),
        _kernel(GEMM, 140, 30, **{"External id": 2, "correlation": 12}),
        _kernel(LN_BWD, 180, 10, **{"External id": 3, "correlation": 13}),
        _kernel(FPROP, 185, 20, **{"External id": 4, "correlation": 14}),
        _kernel(ADAM, 210, 8, correlation=15),
        _kernel(MEMCPY, 220, 4, cat="gpu_memcpy", **{"External id": 7, "correlation": 16}),
        _kernel(MUL, 230, 6, **{"External id": 6, "correlation": 17}),
        _kernel(COLUMN_SUM, 240, 5),
    ]
    return host + device


def test_classify_buckets_kernel_and_cpu_op_names():
    want = {FLASH: "attention", GEMM: "gemm", LN_BWD: "layer_norm", FPROP: "conv",
            ADAM: "optimizer", MEMCPY: "copy", MUL: "other", COLUMN_SUM: "layer_norm",
            "void flash_attention_bwd_dkv_kernel<F32Ops, 64, false>(...)": "attention",
            "void fbank_fft_kernel<8>(FbankArgs, FftSmem)": "fbank",
            "sm80_xmma_wgrad_implicit_gemm_indexed_tf32f32_tf32f32_f32_nhwckrsc": "conv",
            "nvjet_tst_128x64_64x8_2x1_v_bz_coopB_TNT": "gemm",
            "void at::native::ctc_loss_log_alpha_gpu_kernel<float, long>(...)": "loss",
            "Memset (Device)": "copy",
            "openasr::flash_bwd_dq": "attention", "openasr::fbank": "fbank",
            "aten::_foreach_add_": "optimizer", "aten::mm": "gemm", "aten::cat": "copy"}
    assert {name: trace.classify(name) for name in want} == want


def test_split_window_of_a_handwritten_trace():
    events = handwritten_trace()
    lane = trace.device_lane(events, "cuda")
    assert len(lane) == 9 and len(trace.dedupe(lane)) == 8
    split = trace.split_window(lane, steps=1)
    span = 145.0
    want_us = {"attention": 40, "gemm": 30, "layer_norm": 15, "conv": 15, "optimizer": 8,
               "copy": 4, "other": 6, "fbank": 0, "loss": 0}
    want_calls = {"attention": 1, "gemm": 1, "layer_norm": 2, "conv": 1, "optimizer": 1,
                  "copy": 1, "other": 1, "fbank": 0, "loss": 0}
    got = split["classes"]
    for cls in trace.CLASSES:
        assert got[cls]["ms"] == pytest.approx(want_us[cls] / 1e3), cls
        assert got[cls]["calls"] == want_calls[cls], cls
        assert got[cls]["share"] == pytest.approx(want_us[cls] / span), cls
    assert split["span_ms"] == pytest.approx(0.145)
    assert split["busy_ms"] == pytest.approx(0.118)
    assert split["overlap_ms"] == pytest.approx(0.005)
    assert split["idle_share"] == pytest.approx(27 / 145)
    assert sum(c["share"] for c in got.values()) + split["idle_share"] == pytest.approx(1, abs=1e-12)
    # two steps: ms and calls a step halve, shares stay
    two = trace.split_window(lane, steps=2)
    assert two["classes"]["layer_norm"]["calls"] == 1
    assert two["classes"]["attention"]["ms"] == pytest.approx(0.02)
    assert two["idle_share"] == pytest.approx(split["idle_share"])


def test_sources_join_kernels_to_their_python_lines():
    events = handwritten_trace()
    lane = trace.dedupe(trace.device_lane(events, "cuda"))
    got = dict(zip((e["name"] for e in lane), trace.sources(events, lane)))
    assert got == {
        FLASH: "openasr_torch/models/layers.py(100): forward",
        GEMM: "openasr_torch/models/layers.py(100): forward",
        LN_BWD: "openasr_torch/kernels/layer_norm.py(50): layer_norm_bwd",
        FPROP: "openasr_torch/models/subsample.py(51): forward",
        ADAM: "openasr_torch/ops/fused_adam.py(86): step",
        MEMCPY: "openasr_torch/solvers/__init__.py(130): batch_to_device",
        MUL: "openasr_torch/models/layers.py(200): glu",
        COLUMN_SUM: trace.NO_SOURCE,
    }
    assert list(got.values()).count(trace.NO_SOURCE) == 1


def test_the_trace_reader_reads_files_and_sums_spans(tmp_path):
    import gzip
    import json

    events = handwritten_trace()
    for path, opener in ((tmp_path / "t.json", open), (tmp_path / "t.json.gz", gzip.open)):
        with opener(path, "wt") as f:
            json.dump({"traceEvents": events}, f)
        assert trace.read_trace(str(path)) == events
    lane = trace.dedupe(trace.device_lane(events, "cuda"))
    assert trace.sum_span_us(lane, "void layer_norm") == 10.0
    assert trace.sum_span_us(lane) == 123.0
    names = trace.by_name(trace.device_lane(events, "cuda"))
    assert names[GEMM] == {"us": 30.0, "calls": 1, "class": "gemm"}


def test_collect_device_events_on_the_cpu_lane_and_no_fallback():
    lin = torch.nn.Linear(8, 4)

    def run():
        lin(torch.randn(3, 8)).sum().backward()

    lane = trace.collect_device_events(run, device="cpu")
    names = {e["name"] for e in lane}
    assert "aten::linear" in names and "aten::addmm" not in names  # outermost only
    split = trace.split_window(lane)
    assert split["classes"]["gemm"]["calls"] >= 1 and split["overlap_ms"] < 1e-6  # rounding
    with pytest.raises(RuntimeError, match="no device-lane event"):
        trace.collect_trace(lambda: None, device="cpu")


@pytest.fixture
def bench(monkeypatch):
    """bench.py imported afresh under the environment the test sets; the
    JAX cache variables it sets at import are put back afterwards."""
    for var in ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                "BENCH_FAST", "BENCH_B", "BENCH_T"):
        monkeypatch.delenv(var, raising=False)

    def load(fast: bool):
        if fast:
            monkeypatch.setenv("BENCH_FAST", "1")
        else:
            monkeypatch.delenv("BENCH_FAST", raising=False)
        module = importlib.import_module("bench")
        return importlib.reload(module)

    yield load
    sys.modules.pop("bench", None)


@pytest.mark.parametrize("fast", [False, True])
def test_profile_step_copies_bench_exactly(bench, fast):
    b = bench(fast)
    for name in ("flagship", "cif", "wide", "online"):
        assert profile_step.CONFIGS[name]() == getattr(b, f"{name}_cfg")(), name
    for mine, theirs in ((profile_step.make_batch(), b.make_batch()),
                         (profile_step.make_wave_batch(), b.make_wave_batch())):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k
    s = profile_step.shape()
    assert (s["B"], s["T"], s["D_MODEL"], s["LAYERS"], s["FFN"]) == (
        b.B, b.T, b.D_MODEL, b.LAYERS, b.FFN)
    assert (profile_step.VOCAB, profile_step.D, profile_step.U, profile_step.NHEAD) == (
        b.VOCAB, b.D, b.U, b.NHEAD)


def test_profile_step_cli_runs_every_report_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(profile_step, "WARM_STEPS", 1)
    monkeypatch.setattr(profile_step, "TRACE_STEPS", 1)
    out = profile_step.main(["--device", "cpu", "--fast", "--ops", "--trace",
                             "--model", "online"])
    text = capsys.readouterr().out
    for header in ("=== matmul / conv inventory", "f32-operand matmul/conv count",
                   "estimated GFLOP a step", "--- class totals ---", "idle:",
                   "--- top source lines", "--- top kernels ---", "[shown"):
        assert header in text, header
    split = out["trace"]["split"]
    assert sum(c["share"] for c in split["classes"].values()) + split["idle_share"] == \
        pytest.approx(1.0, abs=1e-6)
    for cls in ("gemm", "conv", "attention", "layer_norm", "fbank", "optimizer", "loss"):
        assert split["classes"][cls]["calls"] > 0, cls
    ops = out["ops"]
    assert ops["gflop"] > 0 and ops["f32_count"] > 0
    assert any(key[0] == "aten::convolution_backward" for key in ops["inventory"])


def test_bench_flash_chains_match_sdpa_in_f32():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 16, bench_flash.H, bench_flash.DH) * 0.1).float()
    lens = torch.tensor([9, 16], dtype=torch.int32)
    out = bench_flash.chained(bench_flash.FLASH)(q, lens)
    ref = bench_flash.chained(bench_flash.SDPA)(q, lens)
    assert out.shape == q.shape and float((out - ref).abs().max()) <= 1e-5
    grad = bench_flash.chained_grad(bench_flash.FLASH)(q, lens)
    ref_grad = bench_flash.chained_grad(bench_flash.SDPA)(q, lens)
    assert float((grad - ref_grad).abs().max()) <= 1e-4


def test_bench_flash_cli_prints_a_row(monkeypatch, capsys):
    monkeypatch.setattr(bench_flash, "SHAPES", [(2, 16)])
    rows = bench_flash.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[1].split()[:2] == ["2", "16"]
    (row,) = rows
    assert row["err_fwd"] <= bench_flash.TOL and row["err_grad"] <= bench_flash.TOL
    assert all(row[k] > 0 for k in ("flash_fwd", "sdpa_fwd", "flash_fb", "sdpa_fb"))
