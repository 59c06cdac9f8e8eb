"""Self-contained WAV codec (the reference leans on soundfile/librosa, which
are not part of this framework's dependency set).

Supports PCM 8/16/24/32-bit and IEEE float32/float64, mono or multi-channel.
Reads return float32 in [-1, 1]; writes accept float arrays and encode PCM16
by default (or float32).  A read walks the chunk headers over the file's
bytes in place, then converts the frames asked for once, straight from the
data chunk.
"""

from __future__ import annotations

import io
import mmap
import struct
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# decodes in this process by route: "direct" where the data chunk's samples
# went into the output in one conversion (PCM 16 / 32, IEEE float),
# "general" for PCM 8 / 24
READS = {"direct": 0, "general": 0}
_READS_LOCK = threading.Lock()


def _count(route: str) -> None:
    with _READS_LOCK:
        READS[route] += 1


def wav_duration(path_or_bytes: Union[str, bytes, io.BytesIO]) -> float:
    """Duration in seconds from the RIFF chunk headers alone — no sample
    decode (a server-side upload probe must not decode a multi-minute file
    to learn its length).  Raises ValueError for non-WAV/corrupt input."""
    if isinstance(path_or_bytes, bytes):
        f: io.IOBase = io.BytesIO(path_or_bytes)
        close = False
    elif hasattr(path_or_bytes, "read"):
        f = path_or_bytes
        close = False
    else:
        f = open(path_or_bytes, "rb")
        close = True
    try:
        start = f.tell()
        file_end = f.seek(0, 2)
        f.seek(start)
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (size,) = struct.unpack_from("<I", hdr, 4)
            # clamp a lying size field to the actual bytes present
            size = min(size, max(file_end - f.tell(), 0))
            if hdr[:4] == b"fmt ":
                fmt = f.read(size)
                f.seek(size & 1, 1)
            else:
                if hdr[:4] == b"data":
                    data_size = size
                f.seek(size + (size & 1), 1)
        if fmt is None or data_size is None:
            raise ValueError("WAV missing fmt/data chunk")
        if len(fmt) < 16:
            raise ValueError("truncated WAV fmt chunk")
        (_, channels, sample_rate, _, block_align, bits) = struct.unpack_from(
            "<HHIIHH", fmt, 0)
        frame_bytes = block_align or max(1, channels) * max(bits, 8) // 8
        if sample_rate <= 0 or frame_bytes <= 0:
            raise ValueError("invalid WAV fmt chunk")
        return (data_size // frame_bytes) / float(sample_rate)
    finally:
        if close:
            f.close()


def _contents(path_or_bytes: Union[str, bytes, io.BytesIO]):
    """The whole file without a copy where it can be had: ``bytes`` as they
    are, a path's file mapped read-only (its pages are read where they lie,
    and the map goes with the last array over it); a file object is read
    from where it stands."""
    if isinstance(path_or_bytes, bytes):
        return path_or_bytes
    if hasattr(path_or_bytes, "read"):
        return path_or_bytes.read()
    with open(path_or_bytes, "rb") as f:
        try:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):  # an empty file, a pipe
            return f.read()


def read_wav(
    path_or_bytes: Union[str, bytes, io.BytesIO],
    *,
    _region: Optional[Callable[[int, int], Tuple[int, int]]] = None,
) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file.

    Returns
    -------
    (samples, sample_rate) where samples is float32 with shape (n,) for mono
    or (n, channels) for multi-channel, scaled to [-1, 1].

    ``_region(frames, sample_rate) -> (start, stop)`` (``load_audio``'s
    offset and duration) decodes frames [start, stop) alone: bitwise those
    frames of the whole decode.
    """
    data = _contents(path_or_bytes)
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    raw = None  # (offset, bytes) of the data chunk
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = (pos + 8, min(chunk_size, len(data) - pos - 8))
        if chunk_id == b"fmt ":
            fmt = data[body[0] : body[0] + body[1]]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError("WAV missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError("truncated WAV fmt chunk")

    (audio_format, channels, sample_rate, _byte_rate, _block_align, bits) = (
        struct.unpack_from("<HHIIHH", fmt, 0)
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        (audio_format,) = struct.unpack_from("<H", fmt, 24)
    if audio_format == _WAVE_FORMAT_PCM:
        if bits not in (8, 16, 24, 32):
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")

    # whole samples (a corrupt tail is cut), then whole frames
    width = max(channels, 1)
    frames = raw[1] // (bits // 8) // width
    start, stop = (0, frames) if _region is None else _region(frames, sample_rate)
    shape = (stop - start, channels) if channels > 1 else (stop - start,)
    count = (stop - start) * width
    first = raw[0] + start * width * (bits // 8)

    if bits == 24:
        b = np.frombuffer(data, np.uint8, 3 * count, first).reshape(shape + (3,))
        x = (
            b[..., 0].astype(np.int32)
            | (b[..., 1].astype(np.int32) << 8)
            | (b[..., 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
            1 << 23
        )
        _count("general")
    elif bits == 8:
        b = np.frombuffer(data, np.uint8, count, first).reshape(shape)
        x = (b.astype(np.float32) - 128.0) / 128.0
        _count("general")
    else:  # straight from the chunk's samples, converted once
        dtype = ("<i" if audio_format == _WAVE_FORMAT_PCM else "<f") + str(bits // 8)
        samples = np.frombuffer(data, dtype, count, first).reshape(shape)
        if audio_format == _WAVE_FORMAT_PCM:
            # a power-of-two scale: the product has the quotient's bits
            x = np.empty(shape, np.float32)
            np.multiply(samples, np.float32(2.0 ** (1 - bits)), out=x,
                        dtype=np.float32)
        else:
            x = samples.astype(np.float32)
        _count("direct")
    return x, sample_rate


def write_wav(
    path_or_buf: Union[str, io.BytesIO],
    samples: np.ndarray,
    sample_rate: int,
    *,
    dtype: str = "int16",
) -> None:
    """Write a RIFF/WAVE file (PCM16 or float32)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    elif samples.ndim == 2:
        channels = samples.shape[1]
    else:
        raise ValueError("samples must be 1-D or 2-D (n, channels)")

    if dtype == "int16":
        clipped = np.clip(samples, -1.0, 1.0)
        payload = np.round(clipped * 32767.0).astype("<i2").tobytes()
        audio_format, bits = _WAVE_FORMAT_PCM, 16
    elif dtype == "float32":
        payload = samples.astype("<f4").tobytes()
        audio_format, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
    else:
        raise ValueError(f"unsupported write dtype: {dtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack(
        "<HHIIHH", audio_format, channels, sample_rate, byte_rate, block_align, bits
    )
    out = io.BytesIO()
    out.write(b"RIFF")
    out.write(struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)))
    out.write(b"WAVE")
    out.write(b"fmt ")
    out.write(struct.pack("<I", len(fmt)))
    out.write(fmt)
    out.write(b"data")
    out.write(struct.pack("<I", len(payload)))
    out.write(payload)
    blob = out.getvalue()

    if hasattr(path_or_buf, "write"):
        path_or_buf.write(blob)
    else:
        with open(path_or_buf, "wb") as f:
            f.write(blob)
