"""Self-contained WAV codec (the reference leans on soundfile/librosa, which
are not part of this framework's dependency set).

Supports PCM 16/24/32-bit and IEEE float32/float64, mono or multi-channel.
Reads return float32 in [-1, 1]; writes accept float arrays and encode PCM16
by default (or float32).
"""

from __future__ import annotations

import io
import struct
from typing import Tuple, Union

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


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


def read_wav(path_or_bytes: Union[str, bytes, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file.

    Returns
    -------
    (samples, sample_rate) where samples is float32 with shape (n,) for mono
    or (n, channels) for multi-channel, scaled to [-1, 1].
    """
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    elif hasattr(path_or_bytes, "read"):
        data = path_or_bytes.read()
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = body
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
    if bits in (16, 24, 32, 64):  # clamp data to whole samples (corrupt tail)
        bps = bits // 8
        raw = raw[: (len(raw) // bps) * bps]
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        (audio_format,) = struct.unpack_from("<H", fmt, 24)

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
                1 << 23
            )
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
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
