"""Audio loading with resampling / offset / duration semantics.

Mirrors the behavioral contract of the reference's loader (librosa.load calls
at aegis_engine.py:22-27 and aegis_engine_financial.py:52-63): mono mixdown,
resample to the engine rate, optional [offset, offset+duration) slice.

Resampling uses a polyphase FIR (scipy.signal.resample_poly) — high quality,
deterministic, and an exact match between the CPU oracle and the device
pipeline because resampling always happens on host before ingest
(SURVEY.md §7.4 "Resampling parity").
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
from scipy import signal as _signal

from aegis_tpu_torch.io.wav import read_wav


def to_mono(x: np.ndarray) -> np.ndarray:
    """Mono float32: the channel mean of (n, channels), a 1-D float32 input
    itself."""
    if x.ndim == 2:
        x = x.mean(axis=1)
    return x.astype(np.float32, copy=False)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample to target_sr. Identity if rates match (a float32
    input itself)."""
    if orig_sr == target_sr:
        return x.astype(np.float32, copy=False)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    y = _signal.resample_poly(x.astype(np.float64), up, down)
    return y.astype(np.float32)


def _decode_with_ffmpeg(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Fallback decode (mp3/ogg/m4a/...) through ffmpeg when available."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise ValueError("unsupported audio format and ffmpeg not available")
    if isinstance(path_or_bytes, (bytes, bytearray)):
        src = ["-i", "pipe:0"]
        stdin = bytes(path_or_bytes)
    else:
        src = ["-i", str(path_or_bytes)]
        stdin = None
    out = subprocess.run(
        [ffmpeg, "-v", "error", *src, "-f", "f32le", "-ac", "1",
         "-ar", "44100", "pipe:1"],
        input=stdin, capture_output=True, timeout=120,
    )
    if out.returncode != 0:
        raise ValueError(f"ffmpeg decode failed: {out.stderr[:200]!r}")
    return np.frombuffer(out.stdout, dtype="<f4").copy(), 44100


def probe_duration(path_or_bytes: Union[str, bytes]) -> Optional[float]:
    """Cheap duration probe: WAV header math (no sample decode), ffprobe for
    other formats, None when neither applies.  The serve layer's turbo=auto
    decision keys on this, so it must work for every format the analyze
    path can decode (anything ffmpeg handles ships with ffprobe)."""
    from aegis_tpu_torch.io.wav import wav_duration

    try:
        return wav_duration(path_or_bytes)
    except (ValueError, OSError):
        pass
    import shutil
    import subprocess

    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    cmd = [ffprobe, "-v", "error", "-show_entries", "format=duration",
           "-of", "csv=p=0"]
    try:
        if isinstance(path_or_bytes, (bytes, bytearray)):
            out = subprocess.run(cmd + ["pipe:0"], input=bytes(path_or_bytes),
                                 capture_output=True, timeout=30)
        else:
            out = subprocess.run(cmd + [str(path_or_bytes)],
                                 capture_output=True, timeout=30)
        text = out.stdout.decode().strip()
        return float(text) if out.returncode == 0 and text else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def load_audio(
    path_or_bytes: Union[str, bytes],
    sr: Optional[int] = 22050,
    offset: float = 0.0,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """Load an audio file as mono float32 at the requested sample rate.

    WAV is decoded natively; other formats fall back to ffmpeg when present.
    Offset/duration are applied at the *native* rate before resampling, like
    librosa.load's offset/duration arguments.
    """
    if duration is not None and duration < 0:
        # a negative duration would be a Python negative-index slice —
        # silently analyzing the WRONG region (e.g. end_time <
        # start_time at the engine facade used to drop the tail and
        # return seconds 4..9 for the request "region 4..3 s")
        raise ValueError(f"duration must be non-negative, got {duration}")

    def region(n: int, native_sr: int) -> Tuple[int, int]:
        """Frames [start, stop) of n that ``[round(offset * sr):]`` and then
        ``[:round(duration * sr)]`` keep."""
        start = slice(int(round(offset * native_sr)) if offset else 0,
                      None).indices(n)[0]
        if duration is None:
            return start, n
        return start, start + min(int(round(duration * native_sr)), n - start)

    try:  # a WAV decodes the region's frames alone
        x, native_sr = read_wav(path_or_bytes, _region=region)
    except ValueError:
        x, native_sr = _decode_with_ffmpeg(path_or_bytes)
        x = x[slice(*region(len(x), native_sr))]
    x = to_mono(x)
    if sr is None:  # sr=None: native rate, no resampling (librosa.load parity)
        return x, native_sr
    return resample(x, native_sr, sr), sr
