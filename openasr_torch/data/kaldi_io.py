"""Kaldi ark/scp float-matrix IO (NumPy).

Counterpart of the matrix part of openasr_tpu/data/kaldi_io.py: binary
float/double matrices, the three compressed-matrix formats, text-mode
matrices, scp `path:offset` addressing and `cmd |` pipe inputs, plus the
binary float-matrix writer.  Output pipes (`| cmd`) and the int/float
vector and posterior readers wait for the slices that need them.
"""

from __future__ import annotations

import contextlib
import struct
import subprocess
import threading
from typing import BinaryIO, Iterable, Iterator, Tuple

import numpy as np


def _is_pipe(path: str) -> bool:
    return path.rstrip().endswith("|")


@contextlib.contextmanager
def open_or_fd(path: str) -> Iterator[BinaryIO]:
    """A binary stream for reading 'file' or 'cmd |' (the command's standard
    output, run by the shell).  The command is waited for on exit."""
    if _is_pipe(path):
        with subprocess.Popen(path.rstrip()[:-1], shell=True,
                              stdout=subprocess.PIPE) as proc:
            yield proc.stdout
    else:
        with open(path, "rb") as f:
            yield f


def _read_token(f: BinaryIO) -> bytes:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok


def _read_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"Expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_compressed(f: BinaryIO, fmt: int) -> np.ndarray:
    """Kaldi CompressedMatrix: format 1 = per-column uint8 with percentile
    headers, 2 = uint16, 3 = uint8 (row-major)."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if fmt == 1:
        headers = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4)
        pct = min_value + rng * headers.astype(np.float64) / 65535.0
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8)
        data = data.reshape(cols, rows).astype(np.float64)
        p0, p25, p75, p100 = (pct[:, i : i + 1] for i in range(4))
        low = p0 + (p25 - p0) * (data / 64.0)
        mid = p25 + (p75 - p25) * ((data - 64.0) / 128.0)
        high = p75 + (p100 - p75) * ((data - 192.0) / 63.0)
        out = np.where(data <= 64, low, np.where(data <= 192, mid, high))
        return out.T.astype(np.float32)
    if fmt == 2:
        data = np.frombuffer(f.read(2 * rows * cols), dtype="<u2")
        return (min_value + rng * data.astype(np.float64) / 65535.0).reshape(
            rows, cols
        ).astype(np.float32)
    if fmt == 3:
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8)
        return (min_value + rng * data.astype(np.float64) / 255.0).reshape(
            rows, cols
        ).astype(np.float32)
    raise ValueError(f"Unknown compressed matrix format {fmt}")


def _read_text_mat(f: BinaryIO, first: bytes) -> np.ndarray:
    buf = first
    while b"]" not in buf:
        chunk = f.read(4096)
        if not chunk:
            break
        buf += chunk
    text = buf.decode("utf-8")
    text = text[text.index("[") + 1 : text.index("]")]
    rows = [r.split() for r in text.strip().split("\n") if r.strip()]
    return np.array(rows, dtype=np.float32)


def read_mat_fd(f: BinaryIO, writable: bool = True) -> np.ndarray:
    """One matrix from an open stream.  writable=False may return a
    read-only view of the read buffer (the collate copies rows anyway)."""
    binary = f.read(2)
    if binary != b"\x00B":
        return _read_text_mat(f, binary)
    tok = _read_token(f)
    if tok == b"FM":
        rows, cols = _read_int32(f), _read_int32(f)
        data = np.frombuffer(f.read(4 * rows * cols), dtype="<f4")
        data = data.reshape(rows, cols)
        return data.copy() if writable else data
    if tok == b"DM":
        rows, cols = _read_int32(f), _read_int32(f)
        data = np.frombuffer(f.read(8 * rows * cols), dtype="<f8")
        return data.reshape(rows, cols).astype(np.float32)
    if tok == b"CM":
        return _read_compressed(f, 1)
    if tok == b"CM2":
        return _read_compressed(f, 2)
    if tok == b"CM3":
        return _read_compressed(f, 3)
    raise ValueError(f"Unknown matrix token {tok!r}")


_fd_cache_local = threading.local()


def _cached_ark_fd(path: str, offset: int) -> BinaryIO:
    """Thread-local cache of open ark handles for 'path:offset' reads
    (prefetch threads seek independently)."""
    cache = getattr(_fd_cache_local, "cache", None)
    if cache is None:
        cache = _fd_cache_local.cache = {}
    f = cache.get(path)
    if f is None or f.closed:
        if len(cache) >= 32:
            for old in cache.values():
                old.close()
            cache.clear()
        f = cache[path] = open(path, "rb")
    f.seek(offset)
    return f


def read_mat(path: str, writable: bool = True) -> np.ndarray:
    """Read one matrix from 'file', 'file:offset' or 'cmd |' (a ':' inside
    a command is not an offset)."""
    if ":" in path and not _is_pipe(path):
        head, tail = path.rsplit(":", 1)
        if tail.isdigit():
            return read_mat_fd(
                _cached_ark_fd(head, int(tail)), writable=writable
            )
    with open_or_fd(path) as f:
        return read_mat_fd(f, writable=writable)


def write_mat(f: BinaryIO, mat: np.ndarray, key: str) -> int:
    """Append one binary float matrix; returns the value's byte offset
    (for building scp files)."""
    f.write(key.encode("utf-8") + b" ")
    offset = f.tell()
    f.write(b"\x00BFM ")
    rows, cols = mat.shape
    f.write(b"\x04" + struct.pack("<i", rows))
    f.write(b"\x04" + struct.pack("<i", cols))
    f.write(mat.astype("<f4").tobytes())
    return offset


def write_ark_scp(path_prefix: str, mats: Iterable[Tuple[str, np.ndarray]]):
    """Write an ark + scp pair from (key, matrix) pairs."""
    ark_path = path_prefix + ".ark"
    scp_path = path_prefix + ".scp"
    with open(ark_path, "wb") as fa, open(scp_path, "w") as fs:
        for key, mat in mats:
            offset = write_mat(fa, mat, key)
            fs.write(f"{key} {ark_path}:{offset}\n")
