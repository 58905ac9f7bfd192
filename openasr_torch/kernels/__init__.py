"""Hand-written Hopper kernels: build and load.

The CUDA C++ sources under `csrc/` are compiled with nvcc for `sm_90a`
into ONE shared library with a plain C interface and loaded with ctypes.
The build runs at first use into `kernels/build/` (git-ignored): one nvcc
process per source, all started together, then one link.  The library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached library.

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception.  Nothing here falls
back to a plain version: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("layer_norm.cu", "flash_attention.cu", "flash_attention_bwd.cu", "fbank.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def _digest() -> str:
    """Hash of every file under csrc/ (sources and headers) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources (if their hash changed) and return the .so path.
    The compiler's output, including ptxas's register and shared-memory
    report, is kept in `build/build-<hash>.log`."""
    digest = _digest()
    so = BUILD_DIR / f"libopenasr_kernels-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}-{digest}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = [], []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    log_path = BUILD_DIR / f"build-{digest}.log"
    log_path.write_text("\n".join(logs))
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}; see {log_path}:\n" + "\n".join(logs)
        )
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        u32, i64p = ctypes.c_uint32, ctypes.POINTER(ctypes.c_int64)
        lib.openasr_layer_norm_fwd.argtypes = [
            p, p, p, p, p, p,        # x, gamma, beta, y, mean, rstd
            i, i, i64, i64,          # n_rows, d, x_row_stride, y_row_stride
            f, i, i, p,              # eps, dtype, device, stream
        ]
        lib.openasr_layer_norm_fwd.restype = i
        lib.openasr_layer_norm_bwd.argtypes = [
            p, p, p, p, p, p,        # x, dy, gamma, mean, rstd, dx
            p, p, p, i,              # dgamma, dbeta, scratch, its rows
            i, i, i64, i64, i64,     # n_rows, d, x/dy/dx row strides
            i, i, p,                 # dtype, device, stream
        ]
        lib.openasr_layer_norm_bwd.restype = i
        lib.openasr_flash_attention_fwd.argtypes = [
            p, p, p, p, p, p,        # q, k, v, kv_lengths, out, lse
            i, i, i, i, i,           # B, H, Tq, Tk, D
            i64, i64, i64,           # q strides (b, t, h)
            i64, i64, i64,           # k strides
            i64, i64, i64,           # v strides
            f, i,                    # sm_scale, causal
            i, i, i,                 # chunk (0: off), left chunks, phase
            u32, u32, f, i,          # dropout seed, keep threshold, scale, on
            i, i, p,                 # dtype, device, stream
        ]
        lib.openasr_flash_attention_fwd.restype = i
        bwd_tail = [
            i, i, i, i, i,           # B, H, Tq, Tk, D
            i64p,                    # q, k, v, dout strides (b, t, h) x 4
            f, i,                    # sm_scale, causal
            i, i, i,                 # chunk (0: off), left chunks, phase
            u32, u32, f, i,          # dropout seed, keep threshold, scale, on
            i, i, p,                 # dtype, device, stream
        ]
        # q, k, v, dout, the stats (written by the stats pass, read by the
        # others), kv_lengths, then dk, dv / dq
        lib.openasr_flash_attention_bwd_stats.argtypes = [p] * 6 + bwd_tail
        lib.openasr_flash_attention_bwd_stats.restype = i
        lib.openasr_flash_attention_bwd_dkv.argtypes = [p] * 8 + bwd_tail
        lib.openasr_flash_attention_bwd_dkv.restype = i
        lib.openasr_flash_attention_bwd_dq.argtypes = [p] * 7 + bwd_tail
        lib.openasr_flash_attention_bwd_dq.restype = i
        lib.openasr_fbank.argtypes = [
            p, p, p,                 # frames, feat_lengths, out
            p, p, p,                 # window, twiddle, twiddle_lo
            p, p, p, p,              # mel_idx, mel_w, mel_order, cs (or null)
            i, i, i, i, i, i,        # B, T, ws, nfft, M, mel weights
            i64, i64,                # frames' batch and frame strides
            ctypes.c_double,         # preemphasis
            i, i, i, p,              # remove_dc, use_log, device, stream
        ]
        lib.openasr_fbank.restype = i
        lib.openasr_cuda_error_string.argtypes = [i]
        lib.openasr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().openasr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    """The C interface's element-type code: 0 = float32, 1 = bfloat16."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]
