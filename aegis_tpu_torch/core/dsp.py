"""Framing, STFT power, mel spectrogram, dB, RMS and the Hz / MIDI
conversions (PyTorch).

Counterpart of ``aegis_tpu/core/dsp.py``.  The STFT is the same real-DFT
matmul pair (frames @ cos, frames @ sin) against ``dft_matrices``, or with
``use_matmul_dft=False`` the power of ``torch.fft.rfft``; the tables come
from ``core.tables.tables_from_numpy``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aegis_tpu_torch.core.tables import Tables


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """Centered framing, shape (T, frame_length), T = 1 + len(y)//hop.

    When frame_length is a multiple of hop_length the frames are built from
    frame_length//hop_length contiguous slice+reshape views; otherwise from
    a strided window view (the gather of the JAX version).

    Reflect padding follows numpy only while the pad is shorter than the
    signal; torch refuses longer pads, and so does this function (ValueError)
    rather than differ from numpy.
    """
    pad = frame_length // 2
    if pad_mode == "reflect":
        if pad >= y.shape[0]:
            raise ValueError(f"reflect pad {pad} needs a signal longer than "
                             f"the pad, got {y.shape[0]} samples")
        y_p = F.pad(y[None], (pad, pad), mode="reflect")[0]
    else:
        y_p = F.pad(y, (pad, pad))
    n_frames = 1 + y.shape[0] // hop_length
    if frame_length % hop_length == 0:
        k = frame_length // hop_length
        need = (n_frames + k - 1) * hop_length
        if y_p.shape[0] < need:  # ragged tail (len(y) not hop-aligned)
            y_p = F.pad(y_p, (0, need - y_p.shape[0]))
        parts = [
            y_p[i * hop_length: (i + n_frames) * hop_length].reshape(
                n_frames, hop_length)
            for i in range(k)
        ]
        return torch.cat(parts, dim=1)
    return y_p.unfold(0, frame_length, hop_length)[:n_frames]


def stft_power(y: torch.Tensor, hop_length: int, tables: Tables,
               use_matmul_dft: bool = True) -> torch.Tensor:
    """|STFT|^2, centered reflect padding, periodic Hann.  (T, 1+n_fft//2).

    ``use_matmul_dft`` (the default, and every engine's path) takes the
    real-DFT matmul pair; False takes the power of ``torch.fft.rfft`` of
    the windowed frames, as the JAX version's ``jnp.fft.rfft`` path."""
    n_fft = tables.window.shape[0]
    fw = frame_signal(y, n_fft, hop_length, "reflect") * tables.window[None, :]
    if not use_matmul_dft:
        spec = torch.fft.rfft(fw, dim=-1)
        return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)
    re = fw @ tables.dft_cos
    im = fw @ tables.dft_sin
    return re * re + im * im


def melspectrogram_t(y: torch.Tensor, hop_length: int, tables: Tables,
                     use_matmul_dft: bool = True) -> torch.Tensor:
    """Power mel spectrogram, time-major (T, n_mels)."""
    return stft_power(y, hop_length, tables, use_matmul_dft) @ tables.mel_fb_t


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float = 80.0) -> torch.Tensor:
    """10*log10(S / max(S)), floored at max - top_db (ref=max semantics)."""
    ref = torch.max(S)
    log_spec = 10.0 * torch.log10(torch.clamp_min(S, amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp_min(ref, amin))
    return torch.maximum(log_spec, torch.max(log_spec) - top_db)


def amplitude_to_db(S: torch.Tensor, amin: float = 1e-5,
                    top_db: float = 80.0) -> torch.Tensor:
    return power_to_db(S ** 2, amin=amin ** 2, top_db=top_db)


def rms(y: torch.Tensor, frame_length: int = 2048,
        hop_length: int = 512) -> torch.Tensor:
    """Frame-wise RMS with centered zero padding, shape (T,)."""
    frames = frame_signal(y, frame_length, hop_length, "constant")
    return torch.sqrt(torch.mean(frames ** 2, dim=-1))


def hz_to_midi(hz):
    """MIDI note numbers of frequencies in Hz: a tensor, or a NumPy array
    or a float (taken through ``torch.as_tensor``)."""
    if not isinstance(hz, torch.Tensor):
        hz = torch.as_tensor(hz)
    return 12.0 * torch.log2(hz / 440.0) + 69.0


def midi_to_hz(midi):
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
