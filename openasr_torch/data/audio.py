"""Audio IO: WAV (with ark-embedded offsets), FLAC, and piped commands.

Counterpart of openasr_tpu/data/audio.py, carried over as NumPy: the
offset-aware RIFF/WAVE reader (8/16/24/32-bit PCM, float, multi-channel,
truncated streams), a pure-Python FLAC decoder with the optional ctypes
fast path of `native/flac_decoder` (used when that library has been
built), `write_wav`, and the multi-scheme `load_wave` (bare path,
`file:`, `flac:`, `ark:fn:offset`, `pipe:cmd |`).

All readers return (sample_rate, np.ndarray float32) keeping the integer
PCM scale (int16 range) that the Kaldi feature pipeline expects.
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import BinaryIO, Tuple

import numpy as np


# --------------------------------------------------------------------- WAV

def read_wav_fd(f: BinaryIO) -> Tuple[int, np.ndarray]:
    """Parse a RIFF/WAVE stream starting at the current file position.

    Tolerates the truncated/streamed chunk sizes Kaldi writes for wavs
    embedded in ark files (falls back to reading to EOF).
    """
    riff = f.read(4)
    if riff not in (b"RIFF", b"RIFX"):
        raise ValueError(f"Not a RIFF file (got {riff!r})")
    big_endian = riff == b"RIFX"
    fmt_prefix = ">" if big_endian else "<"
    f.read(4)  # declared riff size; unreliable for streamed wavs
    wave = f.read(4)
    if wave != b"WAVE":
        raise ValueError("Not a WAVE file")

    n_channels = sample_rate = bits = None
    audio_format = 1
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        chunk_id, size = struct.unpack(fmt_prefix + "4sI", hdr)
        if chunk_id == b"fmt ":
            fmt = f.read(size)
            audio_format, n_channels, sample_rate = struct.unpack(
                fmt_prefix + "HHI", fmt[:8]
            )
            bits = struct.unpack(fmt_prefix + "H", fmt[14:16])[0]
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack(fmt_prefix + "H", fmt[24:26])[0]
        elif chunk_id == b"data":
            raw = f.read(size) if size > 0 else f.read()
            if size > 0 and len(raw) < size:
                pass  # truncated stream: use what we have
            data = raw
            break
        else:
            f.seek(size + (size & 1), io.SEEK_CUR)
    if data is None or sample_rate is None:
        raise ValueError("Malformed WAVE: missing fmt/data chunk")

    endian = ">" if big_endian else "<"
    if audio_format == 1:  # PCM
        if bits == 16:
            arr = np.frombuffer(data, dtype=endian + "i2")
        elif bits == 8:
            arr = np.frombuffer(data, dtype=np.uint8).astype(np.int16) - 128
        elif bits == 32:
            arr = np.frombuffer(data, dtype=endian + "i4")
        elif bits == 24:
            b3 = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            if endian == ">":  # RIFX: bytes arrive MSB-first
                b3 = b3[:, ::-1]
            arr = (
                b3[:, 0].astype(np.int32)
                | (b3[:, 1].astype(np.int32) << 8)
                | (b3[:, 2].astype(np.int32) << 16)
            )
            arr = (arr << 8) >> 8  # sign-extend
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        arr = np.frombuffer(data, dtype=endian + ("f4" if bits == 32 else "f8"))
    else:
        raise ValueError(f"Unsupported WAVE format code: {audio_format}")

    arr = arr.astype(np.float32)
    if n_channels and n_channels > 1:
        arr = arr[: len(arr) // n_channels * n_channels]
        arr = arr.reshape(-1, n_channels).mean(axis=1)
    return int(sample_rate), arr


def read_wav(path: str, offset: int = 0) -> Tuple[int, np.ndarray]:
    with open(path, "rb") as f:
        if offset:
            f.seek(offset)
        return read_wav_fd(f)


# -------------------------------------------------------------------- FLAC

class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # byte position
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        val = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        count = 0
        while self.read(1) == 0:
            count += 1
        return count

    def align(self) -> None:
        self.acc = 0
        self.nbits = 0

    def read_utf8_coded(self) -> int:
        """FLAC's extended-UTF8 coded number (frame/sample index)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x80
        while b0 & mask:
            n += 1
            mask >>= 1
        val = b0 & (mask - 1)
        for _ in range(n - 1):
            val = (val << 6) | (self.read(8) & 0x3F)
        return val


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(br: _BitReader, block_size: int, order: int) -> list:
    method = br.read(2)
    if method > 1:
        raise ValueError("Reserved FLAC residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    residual = []
    samples_per_part = block_size >> part_order
    for p in range(n_parts):
        n = samples_per_part - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            residual.extend(
                br.read_signed(bits) if bits else 0 for _ in range(n)
            )
        else:
            for _ in range(n):
                q = br.read_unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                residual.append((v >> 1) ^ -(v & 1))  # unzigzag
    return residual


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> list:
    if br.read(1) != 0:
        raise ValueError("Invalid FLAC subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        v = br.read_signed(bps)
        out = [v] * block_size
    elif sf_type == 1:  # VERBATIM
        out = [br.read_signed(bps) for _ in range(block_size)]
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        out = [br.read_signed(bps) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        coefs = _FIXED_COEFS[order]
        for r in residual:
            pred = sum(c * out[-1 - j] for j, c in enumerate(coefs))
            out.append(r + pred)
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        out = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        for r in residual:
            pred = sum(c * out[-1 - j] for j, c in enumerate(coefs)) >> shift
            out.append(r + pred)
    else:
        raise ValueError(f"Reserved FLAC subframe type {sf_type}")

    if wasted:
        out = [v << wasted for v in out]
    return out


_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


_FLAC_NATIVE = None
_FLAC_NATIVE_TRIED = False


def _load_native_flac():
    """native/flac_decoder fast path (~2 orders of magnitude faster than the
    Python bit-reader); built with `make -C native/flac_decoder`."""
    import ctypes

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    so = os.path.join(here, "native", "flac_decoder", "libflac_decoder.so")
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    lib.flac_stream_info.restype = ctypes.c_int
    lib.flac_stream_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.flac_decode.restype = ctypes.c_int64
    lib.flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    return lib


def _read_flac_native(data: bytes) -> Tuple[int, np.ndarray] | None:
    import ctypes

    global _FLAC_NATIVE, _FLAC_NATIVE_TRIED
    if not _FLAC_NATIVE_TRIED:
        _FLAC_NATIVE = _load_native_flac()
        _FLAC_NATIVE_TRIED = True
    if _FLAC_NATIVE is None:
        return None
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bps = ctypes.c_int()
    total = ctypes.c_int64()
    if _FLAC_NATIVE.flac_stream_info(
        data, len(data), ctypes.byref(sr), ctypes.byref(ch),
        ctypes.byref(bps), ctypes.byref(total)
    ) != 0 or total.value <= 0:
        return None
    out = np.zeros((ch.value, total.value), np.int32)
    n = _FLAC_NATIVE.flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        total.value,
    )
    if n <= 0:
        return None
    out = out[:, :n].astype(np.float32)
    signal = out[0] if ch.value == 1 else out.mean(axis=0)
    return int(sr.value), signal


def read_flac(path: str) -> Tuple[int, np.ndarray]:
    """Decode a FLAC file (all standard subframe types, stereo decorrelation).
    Uses the native decoder when built; the Python path below is the
    correctness oracle and fallback."""
    with open(path, "rb") as f:
        data = f.read()
    native = _read_flac_native(data)
    if native is not None:
        return native
    if data[:4] != b"fLaC":
        raise ValueError("Not a FLAC file")

    pos = 4
    sample_rate = channels = bps = total = None
    while True:
        hdr = data[pos]
        last = hdr & 0x80
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + size]
        if btype == 0:  # STREAMINFO
            bits = int.from_bytes(body[10:18], "big")
            sample_rate = (bits >> 44) & 0xFFFFF
            channels = ((bits >> 41) & 0x7) + 1
            bps = ((bits >> 36) & 0x1F) + 1
            total = bits & 0xFFFFFFFFF
        pos += 4 + size
        if last:
            break
    if sample_rate is None:
        raise ValueError("FLAC missing STREAMINFO")

    out = [[] for _ in range(channels)]
    br = _BitReader(data, pos)
    n_decoded = 0
    while br.pos < len(data) - 2 and (total == 0 or n_decoded < total):
        sync = br.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"Lost FLAC frame sync at byte {br.pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_coded()

        if bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read(8)  # CRC-8

        if ch_code < 8:
            subs = [
                _decode_subframe(br, block_size, frame_bps)
                for _ in range(ch_code + 1)
            ]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            subs = [left, [l - s for l, s in zip(left, side)]]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, frame_bps + 1)
            right = _decode_subframe(br, block_size, frame_bps)
            subs = [[r + s for r, s in zip(right, side)], right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            subs = [[], []]
            for m, s in zip(mid, side):
                m = (m << 1) | (s & 1)
                subs[0].append((m + s) >> 1)
                subs[1].append((m - s) >> 1)
        else:
            raise ValueError(f"Reserved FLAC channel assignment {ch_code}")

        for c, sub in enumerate(subs):
            out[c].extend(sub)
        n_decoded += block_size
        br.align()
        br.read(16)  # CRC-16

    arrs = [np.asarray(c, dtype=np.float32) for c in out]
    if total:
        arrs = [a[:total] for a in arrs]
    signal = arrs[0] if channels == 1 else np.mean(arrs, axis=0)
    return int(sample_rate), signal


def write_wav(path: str, rate: int, data: np.ndarray) -> None:
    """Write a PCM16 RIFF/WAVE file (capability parity with the reference's
    vendored `wavfile.write`, src/third_party/wavfile.py:284).  Float input
    in the int16 PCM scale is rounded; mono [N] or multi-channel [N, C]."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n, channels = data.shape
    pcm = np.clip(np.rint(data), -32768, 32767).astype("<i2")
    byte_rate = rate * channels * 2
    block_align = channels * 2
    data_bytes = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data_bytes)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate,
                            block_align, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data_bytes)))
        f.write(data_bytes)


# ----------------------------------------------------------- scheme loader

def load_wave(path: str) -> Tuple[int, np.ndarray]:
    """Multi-scheme loader: 'file:...', 'pipe:cmd |', 'ark:fn:offset',
    'flac:...' (reference: src/utils.py:77-104).  Bare paths are inferred
    by extension."""
    if ":" not in path:
        if path.endswith(".flac"):
            return read_flac(path)
        return read_wav(path)
    tag, rest = path.strip().split(":", 1)
    if tag == "file":
        return read_wav(rest)
    if tag == "flac":
        return read_flac(rest)
    if tag == "ark":
        fn, offset = rest.rsplit(":", 1)
        return read_wav(fn, offset=int(offset))
    if tag == "pipe":
        cmd = rest.rstrip().rstrip("|")
        proc = subprocess.run(
            cmd, shell=True, stdout=subprocess.PIPE, check=True
        )
        return read_wav_fd(io.BytesIO(proc.stdout))
    raise ValueError(f"Unknown wave scheme: {tag}")
