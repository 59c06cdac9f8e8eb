"""The v1 analyze step (PyTorch): the port's hot path.

Counterpart of the v1 part of ``aegis_tpu/core/analyze.py``:

    y ──► frames ──► |STFT|² (matmul-DFT) ──► mel ──► dB ──► rake mask
      └─► pYIN frames ──► CMNDF ──► trough probs ──► observations ─► Viterbi
      └─► RMS
      └─► onset envelope (from the same mel)

The host helpers (bucketing, transports, packing) are copies of the JAX
module's, which the port cannot import because that module imports jax.
Input lengths are padded to the same buckets as the JAX package: the
global max of ``power_to_db`` and the frames near the true end see the
zero-padded bucket tail, so skipping the padding would change edge frames.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import dsp, masks
from aegis_tpu_torch.core.cqt import onset_strength_t
from aegis_tpu_torch.core.pyin import extract_pyin_frames, pyin_from_frames
from aegis_tpu_torch.core.tables import Tables, tables_from_numpy

MIN_BUCKET = 1 << 16  # ~3 s @ 22050

# Block size for the int8 block-float transport (one scale per block).
# Must divide every bucket length (bucket_length returns multiples of 4096).
PCM8_BLOCK = 1024


def bucket_length(n: int) -> int:
    """Smallest padded length >= n on a 32-steps-per-octave grid (the JAX
    package's buckets: <= ~3.2% padding above 2^17 samples, a 2^12 grid
    floor, and MIN_BUCKET below)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    g = 1 << max((n - 1).bit_length() - 6, 12)
    return -(-n // g) * g


def pad_to_bucket(y: np.ndarray) -> np.ndarray:
    b = bucket_length(len(y))
    if b == len(y):
        return y
    return np.pad(y, (0, b - len(y)))


def quantize_pcm16(y: np.ndarray):
    """ONE track -> (int16 PCM, dequant scale float), peak-scaled.  A silent
    track returns scale 0.0."""
    y = np.asarray(y)
    peak = float(np.max(np.abs(y))) if y.size else 0.0
    if peak <= 0:
        return np.zeros(y.shape, np.int16), 0.0
    return np.round(y * (32767.0 / peak)).astype(np.int16), peak / 32767.0


def quantize_pcm8(y: np.ndarray):
    """ONE bucket-padded track -> (int8 PCM, per-block float32 scales):
    block-floating-point transport, one peak scale per PCM8_BLOCK samples.
    Silent blocks return scale 0.0."""
    y = np.asarray(y, np.float32)
    if len(y) % PCM8_BLOCK:
        raise ValueError(f"int8 transport needs len % {PCM8_BLOCK} == 0 "
                         f"(bucket-pad first), got {len(y)}")
    b = y.reshape(-1, PCM8_BLOCK)
    peak = np.abs(b).max(axis=1)
    q = np.round(b * (127.0 / np.maximum(peak[:, None], 1e-30)))
    return q.astype(np.int8).reshape(-1), (peak / 127.0).astype(np.float32)


def dequant_transport(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A 0-d ``scale`` is the int16 (or float32 pass-through) convention; a
    rank-1 ``scale`` is int8 block-float, one scale per PCM8_BLOCK."""
    y = y.to(torch.float32)
    if scale.dim() == 1:
        return (y.reshape(scale.shape[0], -1) * scale[:, None]).reshape(-1)
    return y * scale


def analyze_program(y: torch.Tensor, rake_sensitivity: float,
                    audio: AudioConfig, pyin_cfg: PyinConfig,
                    tables: Tables) -> Dict[str, torch.Tensor]:
    """v1 Perception Phase.  Returns time-major tensors; f0 is NaN on
    unvoiced frames."""
    y = y.to(torch.float32)
    mel = dsp.melspectrogram_t(y, audio.hop_length, tables)
    mel_db = dsp.power_to_db(mel)
    rake = masks.detect_rake(mel_db, audio.hop_length, audio.sample_rate,
                             rake_sensitivity)

    frames = extract_pyin_frames(y, audio.hop_length, pyin_cfg)
    f0, voiced, probs = pyin_from_frames(frames, audio.sample_rate, pyin_cfg,
                                         tables)
    rms_ = dsp.rms(y, pyin_cfg.frame_length, audio.hop_length)
    return {
        "mel_db": mel_db,
        "rake_mask": rake,
        "f0": f0,
        "voiced_flag": voiced,
        "voiced_probs": probs,
        "rms": rms_,
        "onset_env": onset_strength_t(mel),  # same mel, ~free
    }


# Per-frame output rows packed beside mel_db into ONE buffer, so the
# device->host fetch is a single copy.
_V1_ROWS = ("f0", "voiced_flag", "voiced_probs", "rms", "rake_mask",
            "onset_env")
_BOOL_ROWS = {"voiced_flag", "rake_mask"}


def _pack(out: Dict[str, torch.Tensor], rows, include_mel: bool) -> torch.Tensor:
    cols = [out[k].to(torch.float32)[:, None] for k in rows]
    head = [out["mel_db"]] if include_mel else []
    return torch.cat(head + cols, dim=1)


def _unpack(buf: np.ndarray, rows, n_mels: int) -> Dict[str, np.ndarray]:
    """Packed buffer (T, n_mels + len(rows)) -> named arrays."""
    result: Dict[str, np.ndarray] = (
        {"mel_db": buf[..., :n_mels]} if n_mels else {})
    for i, k in enumerate(rows):
        col = buf[..., n_mels + i]
        if k in _BOOL_ROWS:
            result[k] = col > 0.5
        else:
            result[k] = col.astype(np.float64) if k == "f0" else col
    return result


def run_analyze(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    fetch_mel: bool = True,
    transport: str = "int8",
    device="cpu",
) -> Dict[str, np.ndarray]:
    """Host wrapper: bucket-pad, quantize for the upload, run the analyze
    step on ``device``, fetch the single packed buffer, truncate to the
    true frame count, return NumPy arrays.

    transport: "int8" (default, block-floating-point 8-bit PCM), "int16"
    (peak-scaled) or "float32" (bit-exact ingest)."""
    device = torch.device(device)
    true_frames = audio.n_frames(len(y))
    y_pad = pad_to_bucket(np.asarray(y, np.float32))
    if transport == "int8":
        y8, s8 = quantize_pcm8(y_pad)
        y_dev = torch.from_numpy(y8).to(device)
        scale = torch.from_numpy(s8).to(device)
    elif transport == "int16":
        y16, s = quantize_pcm16(y_pad)
        y_dev = torch.from_numpy(y16).to(device)
        scale = torch.tensor(s, dtype=torch.float32, device=device)
    elif transport == "float32":
        y_dev = torch.from_numpy(y_pad).to(device)
        scale = torch.tensor(1.0, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown transport {transport!r} "
                         "(int8 | int16 | float32)")
    tables = tables_from_numpy(audio, pyin_cfg, device)
    out = analyze_program(dequant_transport(y_dev, scale), rake_sensitivity,
                          audio, pyin_cfg, tables)
    packed = _pack(out, _V1_ROWS, fetch_mel)
    n_mels = audio.n_mels if fetch_mel else 0
    return _unpack(packed[:true_frames].cpu().numpy(), _V1_ROWS, n_mels)
