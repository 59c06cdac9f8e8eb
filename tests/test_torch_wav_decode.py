"""The port's WAV decode (``io/wav.py``, ``io/audio.py``) against the JAX
package's, bitwise, on the CPU.

Every case builds one WAV (a format and channel count in one chunk layout)
and decodes it from each kind of input, over regions and rates, with
``read_wav`` and ``load_audio`` of both packages: the port's arrays are the
JAX package's bits, float32, and new arrays of their own (writable, owning
their data, C-contiguous); ``wav.READS`` counts one decode a call on the
route of the format.
"""

import io
import struct

import numpy as np
import pytest

from aegis_tpu.io import audio as jaudio
from aegis_tpu.io import wav as jwav
from aegis_tpu_torch.io import audio as taudio
from aegis_tpu_torch.io import wav as twav

SR = 8000
FRAMES = 2501
# name: (format code, bits, WAVE_FORMAT_EXTENSIBLE)
FORMATS = {
    "pcm8": (1, 8, False),
    "pcm16": (1, 16, False),
    "pcm24": (1, 24, False),
    "pcm32": (1, 32, False),
    "float32": (3, 32, False),
    "float64": (3, 64, False),
    "ext_pcm16": (1, 16, True),
    "ext_float32": (3, 32, True),
}
LAYOUTS = ("plain", "odd_list", "lying_size", "cut_sample", "two_data")
# (offset s, duration s): whole, inside, a tail, past the end, empty, a
# duration past the end, a negative offset (a Python tail slice)
REGIONS = ((0.0, None), (0.05, 0.1), (0.1, None), (1.0, None), (0.05, 0.0),
           (0.2, 5.0), (-0.05, None))
RATES = (None, SR, 11025)


class _Stream:
    """A file object with ``read`` alone (no seek, no readinto)."""

    def __init__(self, data):
        self._buf = io.BytesIO(data)

    def read(self, n=-1):
        return self._buf.read(n)


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _fmt(code, bits, ext, channels, sr=SR):
    block = channels * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if ext else code, channels, sr,
                       sr * block, block, bits)
    if ext:  # cbSize, valid bits, channel mask, the sub-format GUID
        head += struct.pack("<HHIH14s", 22, bits, 0, code,
                            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x008\x9bq")
    return _chunk(b"fmt ", head)


def _payload(code, bits, channels, rng):
    n = FRAMES * channels
    if code == 3:
        return rng.uniform(-1, 1, n).astype(f"<f{bits // 8}").tobytes()
    if bits in (8, 24):
        return rng.integers(0, 256, n * bits // 8, dtype=np.uint8).tobytes()
    info = np.iinfo(f"<i{bits // 8}")
    return rng.integers(info.min, info.max, n, endpoint=True,
                        dtype=f"<i{bits // 8}").tobytes()


def _wav(name, channels, layout, rng):
    code, bits, ext = FORMATS[name]
    payload = _payload(code, bits, channels, rng)
    fmt = _fmt(code, bits, ext, channels)
    if layout == "plain":
        chunks = fmt + _chunk(b"data", payload)
    elif layout == "odd_list":
        chunks = fmt + _chunk(b"LIST", b"INFOabc") + _chunk(b"data", payload)
    elif layout == "lying_size":
        chunks = fmt + b"data" + struct.pack("<I", len(payload) + 1000) + payload
    elif layout == "cut_sample":  # whole samples of a cut frame, then a byte
        extra = bytes(range(1, (channels - 1) * bits // 8 + 2))
        chunks = fmt + _chunk(b"data", payload + extra)
    else:  # two of each: the last fmt and the last data win
        chunks = (_fmt(1, 16, False, 1, sr=44100) + _chunk(b"data", b"\x01" * 5)
                  + fmt + _chunk(b"data", payload))
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _inputs(data, path):
    return {"path": lambda: str(path), "bytes": lambda: data,
            "bytesio": lambda: io.BytesIO(data),
            "stream": lambda: _Stream(data)}


def _same(a, b, where):
    assert a.dtype == np.float32 and b.dtype == np.float32, where
    assert a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where
    assert (a.flags.writeable and a.flags.owndata
            and a.flags.c_contiguous), where


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", list(FORMATS))
def test_decode_is_the_jax_packages_bits(name, channels, layout, tmp_path):
    rng = np.random.default_rng(sorted(FORMATS).index(name) * 100
                                + channels * 10 + LAYOUTS.index(layout))
    data = _wav(name, channels, layout, rng)
    path = tmp_path / "t.wav"
    path.write_bytes(data)
    route = "general" if name in ("pcm8", "pcm24") else "direct"
    other = "direct" if route == "general" else "general"
    before = dict(twav.READS)
    decodes = 0
    for kind, src in _inputs(data, path).items():
        (a, ra), (b, rb) = twav.read_wav(src()), jwav.read_wav(src())
        assert ra == rb == SR
        # an 8-bit sample cannot be cut: the extra bytes are one more frame
        frames = FRAMES + (FORMATS[name][1] == 8 and layout == "cut_sample")
        assert a.shape[0] == frames and a.ndim == (2 if channels > 1 else 1)
        _same(a, b, (kind, "read_wav"))
        decodes += 1
        for offset, duration in REGIONS:
            for sr in RATES:
                where = (kind, offset, duration, sr)
                (a, ra) = taudio.load_audio(src(), sr=sr, offset=offset,
                                            duration=duration)
                (b, rb) = jaudio.load_audio(src(), sr=sr, offset=offset,
                                            duration=duration)
                assert ra == rb == (sr or SR), where
                _same(a, b, where)
                decodes += 1
        for mod in (taudio, jaudio):
            with pytest.raises(ValueError, match="non-negative"):
                mod.load_audio(src(), sr=SR, offset=0.05, duration=-0.1)
    assert twav.READS[route] - before[route] == decodes
    assert twav.READS[other] == before[other]

    # a decode hands out arrays of its own: writing one leaves the next alone
    first, _ = twav.read_wav(data)
    first[...] = 7.0
    y, _ = taudio.load_audio(data, sr=None, offset=0.1)
    y[...] = 7.0
    _same(twav.read_wav(data)[0], jwav.read_wav(data)[0], "after a write")
    _same(taudio.load_audio(data, sr=None, offset=0.1)[0],
          jaudio.load_audio(data, sr=None, offset=0.1)[0], "after a write")


@pytest.mark.parametrize("data, error", [
    (b"", "not a RIFF/WAVE"),
    (b"RIFF\0\0\0\0WAVX", "not a RIFF/WAVE"),
    (b"RIFF\0\0\0\0WAVE" + _chunk(b"data", b"\0\0"), "missing fmt/data"),
    (b"RIFF\0\0\0\0WAVE" + _chunk(b"fmt ", b"\1\0\1\0") + _chunk(b"data", b""),
     "truncated WAV fmt"),
    (b"RIFF\0\0\0\0WAVE" + _fmt(1, 12, False, 1) + _chunk(b"data", b"\0\0"),
     "PCM bit depth: 12"),
    (b"RIFF\0\0\0\0WAVE" + _fmt(3, 16, False, 1) + _chunk(b"data", b"\0\0"),
     "float bit depth: 16"),
    (b"RIFF\0\0\0\0WAVE" + _fmt(2, 16, False, 1) + _chunk(b"data", b"\0\0"),
     "format code: 2"),
])
def test_refuses_what_the_jax_package_refuses(data, error, tmp_path):
    path = tmp_path / "bad.wav"
    path.write_bytes(data)
    for read in (twav.read_wav, jwav.read_wav):
        for src in (data, str(path)):
            with pytest.raises(ValueError, match=error):
                read(src)
