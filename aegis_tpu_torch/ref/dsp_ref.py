"""NumPy reference DSP: framing, STFT, mel spectrogram, dB scaling, RMS
(a copy of ``aegis_tpu/ref/dsp_ref.py``).

Behavioral contract matches the librosa calls in the reference engine
(aegis_engine.py:22-27, :70): centered frames with reflect padding, periodic
Hann window, power mel spectrogram with Slaney filterbank, power_to_db with
ref=max and top_db=80, RMS over zero-padded centered frames.
"""

from __future__ import annotations

import numpy as np

from aegis_tpu_torch.core.filters import hann_window, mel_filterbank


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int,
                 pad_mode: str = "reflect") -> np.ndarray:
    """Centered framing: pad by frame_length//2 then slide. Shape (T, frame_length),
    T = 1 + len(y)//hop_length."""
    pad = frame_length // 2
    y_p = np.pad(y, pad, mode=pad_mode)
    n_frames = 1 + len(y) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return y_p[idx]


def stft_power(y: np.ndarray, n_fft: int, hop_length: int) -> np.ndarray:
    """|STFT|^2 with centered reflect padding and periodic Hann window.
    Shape (T, 1 + n_fft//2)."""
    frames = frame_signal(y, n_fft, hop_length, pad_mode="reflect")
    window = hann_window(n_fft)
    spec = np.fft.rfft(frames * window[None, :], axis=-1)
    return (spec.real**2 + spec.imag**2).astype(np.float32)


def melspectrogram(y: np.ndarray, sr: int, n_fft: int, hop_length: int,
                   n_mels: int = 128) -> np.ndarray:
    """Power mel spectrogram, shape (n_mels, T) (librosa layout)."""
    power = stft_power(y, n_fft, hop_length)  # (T, bins)
    fb = mel_filterbank(sr, n_fft, n_mels)  # (mels, bins)
    return (power @ fb.T).T.astype(np.float32)


def power_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(max(amin, abs(ref)))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.astype(np.float32)


def amplitude_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-5,
                    top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    return power_to_db(S**2, ref=ref**2, amin=amin**2, top_db=top_db)


def rms(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Frame-wise root-mean-square energy with centered zero padding,
    shape (T,)."""
    frames = frame_signal(y, frame_length, hop_length, pad_mode="constant")
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=-1)).astype(np.float32)


def hz_to_midi(hz):
    return 12.0 * np.log2(np.asanyarray(hz) / 440.0) + 69.0


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((np.asanyarray(midi) - 69.0) / 12.0)
