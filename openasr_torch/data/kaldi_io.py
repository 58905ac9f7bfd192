"""Kaldi ark/scp IO (NumPy).

Counterpart of openasr_tpu/data/kaldi_io.py: binary float/double
matrices, the three compressed-matrix formats, text-mode matrices, scp
`path:offset` addressing and `cmd |` pipe inputs, the binary float-matrix
writer, and the ark readers and writers of integer vectors (alignments,
`read_ali_ark`), float vectors and posteriors (also confusion networks,
`read_cnet_ark`).  Output pipes (`| cmd`) are not supported.
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
    """A binary stream for reading 'file', 'file:offset' (seeked there) or
    'cmd |' (the command's standard output, run by the shell; a ':' inside
    it is not an offset).  The command is waited for on exit."""
    if _is_pipe(path):
        with subprocess.Popen(path.rstrip()[:-1], shell=True,
                              stdout=subprocess.PIPE) as proc:
            yield proc.stdout
        return
    offset = 0
    head, _, tail = path.rpartition(":")
    if head and tail.isdigit():
        path, offset = head, int(tail)
    with open(path, "rb") as f:
        f.seek(offset)
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


def read_mat_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(key, matrix) of each `key rxfilename` line of an scp file."""
    with open(scp_path, "r") as f:
        for line in f:
            fields = line.strip().split(" ", 1)
            if len(fields) == 2:
                yield fields[0], read_mat(fields[1])


def _read_ark(ark_path: str, read_fd) -> Iterator[Tuple[str, object]]:
    """(key, value) of each entry of an ark, each value read by `read_fd`."""
    with open_or_fd(ark_path) as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            yield key.decode("utf-8"), read_fd(f)


def read_mat_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    return _read_ark(ark_path, read_mat_fd)


def write_mat(f: BinaryIO, mat: np.ndarray, key: str) -> int:
    """Append one binary float matrix; returns the value's byte offset
    (for building scp files)."""
    offset = _write_key(f, key)
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


def _text_vector(f: BinaryIO, first: bytes, dtype) -> np.ndarray:
    text = (first + f.readline()).decode("utf-8").replace("[", " ").replace("]", " ")
    return np.array(text.split(), dtype=dtype)


def _write_key(f: BinaryIO, key: str) -> int:
    f.write(key.encode("utf-8") + b" ")
    return f.tell()


# ------------------------------------------------------------ int vectors

# each element is stored as (int8 size marker 4, int32 value)
_INT_ELEM = np.dtype([("size", "i1"), ("value", "<i4")])


def read_vec_int_fd(f: BinaryIO) -> np.ndarray:
    binary = f.read(2)
    if binary != b"\x00B":
        return _text_vector(f, binary, np.int64)
    n = _read_int32(f)
    raw = np.frombuffer(f.read(5 * n), dtype=_INT_ELEM, count=n)
    if n and raw["size"][0] != 4:
        raise ValueError(f"Expected int32 elements, size marker {raw['size'][0]}")
    return raw["value"].copy()


def read_vec_int(path: str) -> np.ndarray:
    with open_or_fd(path) as f:
        return read_vec_int_fd(f)


def read_vec_int_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    return _read_ark(ark_path, read_vec_int_fd)


read_ali_ark = read_vec_int_ark  # alignments are int vectors


def write_vec_int(f: BinaryIO, v: np.ndarray, key: str) -> int:
    """Append one binary int32 vector; returns the value's byte offset."""
    offset = _write_key(f, key)
    f.write(b"\x00B\x04" + struct.pack("<i", len(v)))
    out = np.empty(len(v), dtype=_INT_ELEM)
    out["size"] = 4
    out["value"] = np.asarray(v, dtype=np.int32)
    f.write(out.tobytes())
    return offset


# ---------------------------------------------------------- float vectors

def read_vec_flt_fd(f: BinaryIO) -> np.ndarray:
    binary = f.read(2)
    if binary != b"\x00B":
        return _text_vector(f, binary, np.float64)
    tok = _read_token(f)
    if tok not in (b"FV", b"DV"):
        raise ValueError(f"Unknown vector token {tok!r}")
    n = _read_int32(f)
    width, dtype = (4, "<f4") if tok == b"FV" else (8, "<f8")
    return np.frombuffer(f.read(width * n), dtype=dtype).copy()


def read_vec_flt(path: str) -> np.ndarray:
    with open_or_fd(path) as f:
        return read_vec_flt_fd(f)


def read_vec_flt_ark(ark_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    return _read_ark(ark_path, read_vec_flt_fd)


def read_vec_flt_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    with open(scp_path, "r") as f:
        for line in f:
            fields = line.strip().split(" ", 1)
            if len(fields) == 2:
                yield fields[0], read_vec_flt(fields[1])


def write_vec_flt(f: BinaryIO, v: np.ndarray, key: str) -> int:
    """Append one binary vector, DV for float64 input, else FV (float32);
    returns the value's byte offset."""
    offset = _write_key(f, key)
    v = np.asarray(v)
    if v.dtype != np.float64:
        v = v.astype("<f4")
    f.write(b"\x00B" + (b"DV " if v.dtype == np.float64 else b"FV "))
    f.write(b"\x04" + struct.pack("<i", len(v)))
    f.write(v.tobytes())
    return offset


# ------------------------------------------------------------- posteriors
# vector<vector<pair<int32, float>>>: frames of (index, value) records

_POST_ELEM = np.dtype([("si", "i1"), ("idx", "<i4"), ("sp", "i1"), ("val", "<f4")])


def read_post_fd(f: BinaryIO) -> list:
    """One posterior: a list of frames, each a list of (index, value)."""
    if f.read(2) != b"\x00B":
        raise ValueError("posteriors are binary-only")
    post = []
    for _ in range(_read_int32(f)):
        n = _read_int32(f)
        raw = np.frombuffer(f.read(10 * n), dtype=_POST_ELEM, count=n)
        if n and (raw["si"][0] != 4 or raw["sp"][0] != 4):
            raise ValueError("Expected (int32, float32) posterior records")
        post.append([(int(i), float(v)) for i, v in zip(raw["idx"], raw["val"])])
    return post


def read_post_ark(ark_path: str) -> Iterator[Tuple[str, list]]:
    return _read_ark(ark_path, read_post_fd)


read_cnet_ark = read_post_ark  # confusion networks use the posterior format


def write_post(f: BinaryIO, post, key: str) -> int:
    """Append one binary posterior; returns the value's byte offset."""
    offset = _write_key(f, key)
    f.write(b"\x00B\x04" + struct.pack("<i", len(post)))
    for frame in post:
        f.write(b"\x04" + struct.pack("<i", len(frame)))
        for idx, val in frame:
            f.write(b"\x04" + struct.pack("<i", int(idx)) + b"\x04" + struct.pack("<f", float(val)))
    return offset
