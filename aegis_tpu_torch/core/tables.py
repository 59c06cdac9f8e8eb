"""Constant tables of the analyze path, built once per (config, device).

Every table comes from this package's copy of the NumPy function the JAX
package calls (``core/filters.py``, ``ref/pyin_ref.py`` and, for the
financial trend stack, ``ref/trend_ref.py`` and the Kalman gain recurrence
of ``aegis_tpu/core/trend.py``) in float32, so both packages compute from
bit-identical constants.  The polyphonic programs have a table set of their
own (``PolyTables``): their window follows the sample rate (n_fft 2048 at
22 050 Hz, 4096 at 44 100 Hz, where the DFT pair alone is 67 MB), so it is
built once per (sr, n_fft, device) and kept on the device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core.filters import (chroma_fold, cqt_filterbank,
                                          dft_matrices, hann_window,
                                          mel_filterbank)
from aegis_tpu_torch.ref.pyin_ref import beta_threshold_probs, local_transition
from aegis_tpu_torch.ref.trend_ref import _savgol_kernel

# log(0 + 1e-30): the dense decode's out-of-band transition score
# (aegis_tpu/core/pyin.py applies log(trans + 1e-30) to the whole matrix)
LOG_FLOOR = np.float32(np.log(1e-30))


@dataclasses.dataclass(frozen=True)
class Tables:
    window: torch.Tensor       # (n_fft,) periodic Hann
    dft_cos: torch.Tensor      # (n_fft, 1 + n_fft//2)
    dft_sin: torch.Tensor      # (n_fft, 1 + n_fft//2)
    mel_fb_t: torch.Tensor     # (1 + n_fft//2, n_mels)
    thresholds: torch.Tensor   # (n_thresholds,)
    beta_probs: torch.Tensor   # (n_thresholds,)
    band: torch.Tensor         # (n_bins, 2w+1), see log_transition_band
    band_tab: torch.Tensor     # (n_cls, w+1), see band_class_table
    half_width: int            # w
    bin_hz: torch.Tensor       # (n_bins,) pitch of each bin, see bin_frequencies


def log_transition_band(n: int, w: int) -> np.ndarray:
    """(n, 2w+1) float32: band[j, k] = log(trans[i, j] + 1e-30) for the
    source state i = j - w + k of destination state j, where trans is
    ``local_transition(n, w)``.  Entries whose source lies outside [0, n)
    hold LOG_FLOOR and are never read by the decode."""
    log_t = np.log(local_transition(n, w) + 1e-30).astype(np.float32)
    band = np.full((n, 2 * w + 1), LOG_FLOOR, np.float32)
    j = np.arange(n)[:, None]
    i = j - w + np.arange(2 * w + 1)[None, :]
    ok = (i >= 0) & (i < n)
    band[ok] = log_t[i[ok], np.broadcast_to(j, i.shape)[ok]]
    return band


def row_classes(n: int, w: int) -> np.ndarray:
    """(n,) int: the class of each source state's row of the transition
    matrix.  The row sum of ``local_transition`` depends only on how far the
    source is from the nearer edge, min(i, n-1-i, w); where n < 2w + 1 a
    source can be clipped on both sides, and the class is the source."""
    i = np.arange(n)
    if n < 2 * w + 1:
        return i
    return np.minimum(np.minimum(i, n - 1 - i), w)


def expand_class_table(tab: np.ndarray, n: int, w: int) -> np.ndarray:
    """The (n, 2w+1) band that a class table stands for:
    band[j, k] = tab[class of i, |i - j|] for the source i = j - w + k."""
    band = np.full((n, 2 * w + 1), LOG_FLOOR, np.float32)
    j = np.arange(n)[:, None]
    i = j - w + np.arange(2 * w + 1)[None, :]
    ok = (i >= 0) & (i < n)
    cls = row_classes(n, w)
    band[ok] = tab[cls[i[ok]], np.abs(i - j)[ok]]
    return band


def band_class_table(band: np.ndarray, n: int, w: int) -> np.ndarray:
    """(n_cls, w+1) float32, the band without its repetitions:
    tab[c, d] is the score of a source of row class c (``row_classes``)
    into the destination d states away, either side; n_cls = w + 1, or n
    where n < 2w + 1.  Every entry is read out of ``band`` (entries no
    in-range pair reaches hold LOG_FLOOR), and the table is expanded again:
    unless that equals ``band`` bit for bit this raises, so a decode from
    the table reads the very float32 values a decode from the band reads."""
    band = np.ascontiguousarray(band, np.float32)
    if band.shape != (n, 2 * w + 1):
        raise ValueError(f"band has shape {band.shape}, expected "
                         f"{(n, 2 * w + 1)}")
    n_cls = int(row_classes(n, w).max()) + 1
    i = np.arange(n_cls)[:, None]   # class c's first source is state c
    d = np.arange(w + 1)[None, :]
    up, down = i + d, i - d
    j = np.where(up < n, up, down)
    ok = (up < n) | (down >= 0)
    tab = np.full((n_cls, w + 1), LOG_FLOOR, np.float32)
    tab[ok] = band[j[ok], (i - j + w)[ok]]
    if not np.array_equal(expand_class_table(tab, n, w).view(np.uint32),
                          band.view(np.uint32)):
        raise ValueError(
            f"the (n={n}, w={w}) band is not a function of the source's row "
            "class and |i - j|: it cannot be decoded from a class table")
    return tab


def bin_frequencies(cfg: PyinConfig) -> torch.Tensor:
    """(n_bins,) float32 Hz of each pitch bin, fmin * 2^(b / (12 * nbps)).

    Built once on the host so every device decodes a bin to the same f0.
    XLA evaluates the JAX package's division by 12 * nbps as a product with
    the float32 reciprocal; computing it the same way keeps every bin that
    sits exactly on a half semitone on the same side of the note rounding in
    extract_events as the JAX package (a true division moves five such bins
    across it)."""
    b = torch.arange(cfg.n_pitch_bins, dtype=torch.float32)
    return cfg.fmin * 2.0 ** (b * (1.0 / (12.0 * cfg.n_bins_per_semitone)))


@functools.lru_cache(maxsize=8)
def savgol_taps(window: int, polyorder: int) -> Tuple[float, ...]:
    """Savitzky-Golay correlation taps, float32-rounded, from the JAX
    package's ``trend_ref._savgol_kernel``.  Host floats: the
    filter is a shifted sum, so each tap is a scalar multiplier."""
    return tuple(float(c) for c in
                 _savgol_kernel(window, polyorder).astype(np.float32))


@functools.lru_cache(maxsize=16)
def kalman_gain_table(T: int, process_variance: float,
                      measurement_variance: float,
                      device: torch.device) -> torch.Tensor:
    """(T + 1,) float32 Kalman gains k[j] of the j-th valid sample (k[0]
    unused), the recurrence of aegis_tpu/core/trend.py::kalman line for
    line: the error covariance advances only on valid samples and never
    depends on their values.  A host loop of T steps, so it is cached per
    length."""
    ks = np.empty(T + 1, np.float32)
    ks[0] = 0.0  # unused (j is 1-indexed over valid samples)
    p = 1.0
    for j in range(1, T + 1):
        p_pred = p + process_variance
        ks[j] = p_pred / (p_pred + measurement_variance)
        p = (1.0 - ks[j]) * p_pred
    return torch.from_numpy(ks).to(device)


@functools.lru_cache(maxsize=16)
def tables_from_numpy(audio: AudioConfig, pyin_cfg: PyinConfig,
                      device: torch.device) -> Tables:
    """All constant tables for one (AudioConfig, PyinConfig, device)."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    cos_m, sin_m = dft_matrices(audio.n_fft)
    thresholds, beta = beta_threshold_probs(pyin_cfg)
    w = pyin_cfg.transition_width(audio.sample_rate, audio.hop_length)
    band = log_transition_band(pyin_cfg.n_pitch_bins, w)
    return Tables(
        window=dev(hann_window(audio.n_fft)),
        dft_cos=dev(cos_m),
        dft_sin=dev(sin_m),
        mel_fb_t=dev(mel_filterbank(audio.sample_rate, audio.n_fft,
                                    audio.n_mels).T),
        thresholds=dev(thresholds),
        beta_probs=dev(beta),
        band=dev(band),
        band_tab=dev(band_class_table(band, pyin_cfg.n_pitch_bins, w)),
        half_width=w,
        bin_hz=bin_frequencies(pyin_cfg).to(device),
    )


@dataclasses.dataclass(frozen=True)
class PolyTables:
    """Constants of the polyphonic programs (core/poly.py).  The first three
    fields carry the names ``dsp.stft_power`` reads off ``Tables``."""
    window: torch.Tensor         # (n_fft,) periodic Hann
    dft_cos: torch.Tensor        # (n_fft, 1 + n_fft//2)
    dft_sin: torch.Tensor        # (n_fft, 1 + n_fft//2)
    cqt_fb_t: torch.Tensor       # (1 + n_fft//2, n_bins)
    mel_fb_t: torch.Tensor       # (1 + n_fft//2, n_mels)
    chroma_fold_t: torch.Tensor  # (n_bins, 12)
    supp: torch.Tensor           # (n_bins, n_bins) harmonic comb, row = f0 bin
    sub: torch.Tensor            # (n_bins, n_bins) comb with the widened rim
    bins_per_octave: int


@functools.lru_cache(maxsize=8)
def poly_tables(sr: int, n_fft: int, n_bins: int, bins_per_octave: int,
                n_mels: int, device: torch.device) -> PolyTables:
    """All constant tables of one polyphonic configuration on ``device``."""
    from aegis_tpu_torch.core.poly import (harmonic_subtraction_matrix,
                                           harmonic_suppression_matrix)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    cos_m, sin_m = dft_matrices(n_fft)
    return PolyTables(
        window=dev(hann_window(n_fft)),
        dft_cos=dev(cos_m),
        dft_sin=dev(sin_m),
        cqt_fb_t=dev(cqt_filterbank(sr, n_fft, n_bins, bins_per_octave).T),
        mel_fb_t=dev(mel_filterbank(sr, n_fft, n_mels).T),
        chroma_fold_t=dev(chroma_fold(n_bins, bins_per_octave).T),
        supp=dev(harmonic_suppression_matrix(n_bins, bins_per_octave)),
        sub=dev(harmonic_subtraction_matrix(n_bins, bins_per_octave)),
        bins_per_octave=bins_per_octave,
    )
