"""Audio similarity features on the device (PyTorch).

Counterpart of ``aegis_tpu/verify/similarity.py``:

* ``audio_similarity`` — 0.4 * mel-spectrogram cosine + 0.6 * chroma cosine
  between two signals (the auto-matcher objective, reference
  auto_matcher.py:51-85).  Chroma is |STFT|^2 projected onto the pseudo-CQT
  filterbank and folded into 12 pitch classes (core.filters.cqt_filterbank /
  chroma_fold).  ``features`` computes both feature rows for a batch of
  signals; the auto-match sweep scores every combo with it.
* ``note_slice_similarity`` — batched per-note similarity: 0.5 * RMS-envelope
  Pearson correlation + 0.3 * spectral-centroid similarity + 0.2 * zero-
  crossing-rate similarity (the per-note optimizer objective, reference
  per_note_optimizer.py:72-164) for a whole (B, L) batch of slices.

JAX's reductions are matched by name: ``std`` is the population one
(``correction=0``), ``signbit`` and ``rfft`` are torch's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core.filters import (chroma_fold, cqt_filterbank,
                                          dft_matrices, hann_window,
                                          mel_filterbank)

N_FFT, HOP = 2048, 512


def _chroma_matrix(sr: int, n_fft: int, n_bins: int = 84,
                   bins_per_octave: int = 12) -> np.ndarray:
    """(n_fft_bins, 12): CQT-folded chroma projection (pseudo-CQT filterbank
    composed with the pitch-class fold)."""
    fb = cqt_filterbank(sr, n_fft, n_bins, bins_per_octave)  # (n_bins, fft)
    fold = chroma_fold(n_bins, bins_per_octave)              # (12, n_bins)
    return (fold @ fb).T.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SimilarityTables:
    window: torch.Tensor    # (n_fft,) periodic Hann
    dft_cos: torch.Tensor   # (n_fft, 1 + n_fft//2)
    dft_sin: torch.Tensor   # (n_fft, 1 + n_fft//2)
    mel_fb_t: torch.Tensor  # (1 + n_fft//2, 128)
    chroma_t: torch.Tensor  # (1 + n_fft//2, 12)


@functools.lru_cache(maxsize=8)
def similarity_tables(sr: int, device: torch.device,
                      n_fft: int = N_FFT) -> SimilarityTables:
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    cos_m, sin_m = dft_matrices(n_fft)
    return SimilarityTables(window=dev(hann_window(n_fft)), dft_cos=dev(cos_m),
                            dft_sin=dev(sin_m),
                            mel_fb_t=dev(mel_filterbank(sr, n_fft, 128).T),
                            chroma_t=dev(_chroma_matrix(sr, n_fft)))


def stft_power_batch(y: torch.Tensor, hop: int,
                     tables: SimilarityTables) -> torch.Tensor:
    """|STFT|^2 of each row of (B, n): centered reflect padding, periodic
    Hann, the matmul-DFT of core/dsp.stft_power -> (B, T, 1 + n_fft//2)."""
    n_fft = tables.window.shape[0]
    pad = n_fft // 2
    y_p = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + y.shape[-1] // hop
    fw = y_p.unfold(-1, n_fft, hop)[:, :n_frames] * tables.window
    re = fw @ tables.dft_cos
    im = fw @ tables.dft_sin
    return re * re + im * im


def features(y: torch.Tensor, tables: SimilarityTables
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened mel and chroma feature rows of each signal of (B, n)."""
    p = stft_power_batch(y, HOP, tables)
    return ((p @ tables.mel_fb_t).reshape(y.shape[0], -1),
            (p @ tables.chroma_t).reshape(y.shape[0], -1))


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine of (B, M) against (B, M) or (M,)."""
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                              * torch.linalg.vector_norm(b, dim=-1) + 1e-8)


def similarity_scores(mel_r, ch_r, mel, ch) -> torch.Tensor:
    """0.4 * mel cosine + 0.6 * chroma cosine against the reference rows,
    clipped to [0, 1]."""
    return torch.clamp(0.4 * cosine(mel, mel_r) + 0.6 * cosine(ch, ch_r),
                       0.0, 1.0)


def audio_similarity(y_a: np.ndarray, y_b: np.ndarray, sr: int,
                     device="cuda") -> float:
    """Similarity in [0, 1] on ``device``; signals truncated to the common
    length (>= 0.5 s required, else 0 — matching the reference's guard)."""
    dev = resolve_device(device)
    n = min(len(y_a), len(y_b))
    if n < sr * 0.5:
        return 0.0
    # bucket length to stabilize the program's shapes
    b = 1 << 14
    while b < n:
        b <<= 1
    ys = np.zeros((2, b), np.float32)
    ys[0, :n] = y_a[:n]
    ys[1, :n] = y_b[:n]
    mel, ch = features(torch.from_numpy(ys).to(dev),
                       similarity_tables(sr, dev))
    return float(similarity_scores(mel[0], ch[0], mel[1:], ch[1:])[0])


# --------------------------------------------------------------------------
# Batched per-note slice similarity
# --------------------------------------------------------------------------

def _frame_view(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    n = x.shape[-1]
    n_frames = max(1 + (n - frame) // hop, 1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    # out-of-range reads clamp, as a JAX gather does
    idx = torch.from_numpy(np.minimum(idx, n - 1)).to(x.device)
    return x[..., idx]


def _pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    am = a - a.mean(dim=-1, keepdim=True)
    bm = b - b.mean(dim=-1, keepdim=True)
    denom = torch.sqrt((am * am).sum(-1) * (bm * bm).sum(-1))
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(denom > 1e-10,
                       (am * bm).sum(-1) / torch.clamp_min(denom, 1e-10), zero)


def note_slice_similarity(orig, synth, sr: int, device="cuda") -> torch.Tensor:
    """(B, L), (B, L) -> (B,) similarity scores on ``device`` (see the
    module docstring)."""
    dev = resolve_device(device)
    orig, synth = (x.to(device=dev, dtype=torch.float32) if torch.is_tensor(x)
                   else torch.from_numpy(np.array(x, np.float32)).to(dev)
                   for x in (orig, synth))
    frame = max(512, int(sr * 0.01))
    hop = frame // 2

    fo = _frame_view(orig, frame, hop)
    fs = _frame_view(synth, frame, hop)
    rms_o = torch.sqrt(torch.mean(fo * fo, dim=-1))
    rms_s = torch.sqrt(torch.mean(fs * fs, dim=-1))

    std_o = rms_o.std(dim=-1, correction=0)
    std_s = rms_s.std(dim=-1, correction=0)
    corr = torch.clamp((_pearson(rms_o, rms_s) + 1.0) / 2.0, 0.0, 1.0)
    one = torch.ones((), dtype=corr.dtype, device=dev)
    zero = torch.zeros((), dtype=corr.dtype, device=dev)
    rms_corr = torch.where((std_o < 1e-10) & (std_s < 1e-10), one,
                           torch.where((std_o < 1e-10) | (std_s < 1e-10),
                                       zero, corr))

    # spectral centroid via per-frame FFT power
    n_fft = 1024
    fo2 = _frame_view(orig, n_fft, 512)
    fs2 = _frame_view(synth, n_fft, 512)
    freqs = torch.from_numpy(np.linspace(0, sr / 2, 1 + n_fft // 2,
                                         dtype=np.float32)).to(dev)

    def centroid(frames):
        spec = torch.fft.rfft(frames, dim=-1)
        p = spec.real ** 2 + spec.imag ** 2
        return (p * freqs).sum(-1) / torch.clamp_min(p.sum(-1), 1e-10)

    c_o = centroid(fo2).mean(dim=-1)
    c_s = centroid(fs2).mean(dim=-1)
    max_c = torch.clamp_min(torch.maximum(c_o, c_s), 1.0)
    centroid_sim = torch.clamp(1.0 - torch.abs(c_o - c_s) / max_c, 0.0, 1.0)

    # zero crossing rate
    def zcr(x):
        s = torch.signbit(x)
        return (s[..., 1:] != s[..., :-1]).to(torch.float32).mean(dim=-1)

    z_o, z_s = zcr(orig), zcr(synth)
    max_z = torch.clamp_min(torch.maximum(z_o, z_s), 1e-10)
    zcr_sim = torch.clamp(1.0 - torch.abs(z_o - z_s) / max_z, 0.0, 1.0)

    return torch.clamp(0.5 * rms_corr + 0.3 * centroid_sim + 0.2 * zcr_sim,
                       0.0, 1.0)
