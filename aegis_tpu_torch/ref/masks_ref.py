"""NumPy oracle for the mask kernels (mirrors aegis_tpu.core.masks).

Sequential/loop formulations kept deliberately close to the reference code
(vision.py, guitar_specific.py) — these are the "obviously correct" versions
the vectorized device kernels are tested against.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def run_length_keep(mask: np.ndarray, min_len: int, max_len: int) -> np.ndarray:
    out = np.zeros_like(mask)
    start = -1
    padded = np.concatenate([mask, [False]])  # close trailing runs
    for i in range(len(padded)):
        if padded[i] and start == -1:
            start = i
        elif not padded[i] and start != -1:
            duration = i - start
            if min_len <= duration <= max_len:
                out[start:i] = True
            start = -1
    return out


def detect_rake(S_db_t: np.ndarray, hop_length: int, sr: int,
                broadband_threshold_ratio: float = 0.6) -> np.ndarray:
    T, n_mels = S_db_t.shape
    candidate = np.zeros(T, dtype=bool)
    for t in range(T):
        col = S_db_t[t]
        col_max = np.max(col)
        if col_max < -60:
            continue
        ratio = np.sum(col > (col_max - 20)) / n_mels
        if ratio > broadband_threshold_ratio:
            candidate[t] = True
    ms_per_frame = (hop_length / sr) * 1000.0
    return run_length_keep(candidate, int(10 / ms_per_frame), int(30 / ms_per_frame))


def detect_palm_mute(S_db_t: np.ndarray, hop_length: int, sr: int,
                     duration_ms: float = 50.0) -> np.ndarray:
    T, n_mels = S_db_t.shape
    mid = n_mels // 2
    low = np.mean(S_db_t[:, :mid], axis=1)
    high = np.mean(S_db_t[:, mid:], axis=1)
    candidate = (low / (high + 1e-6)) > 2.0
    ms_per_frame = (hop_length / sr) * 1000.0
    return run_length_keep(candidate, 0, int(duration_ms / ms_per_frame))


def enhance_rake(S_db_t: np.ndarray, hop_length: int, sr: int,
                 rake_mask: np.ndarray) -> np.ndarray:
    T = S_db_t.shape[0]
    enhanced = rake_mask.copy()
    total = np.mean(S_db_t, axis=1)
    ediff = np.diff(total, prepend=total[0])
    ms_per_frame = (hop_length / sr) * 1000.0
    w = max(int(30 / ms_per_frame), 1)
    for i in range(1, T):
        if ediff[i] > 10 and i + w < T:
            if np.mean(ediff[i : i + w]) < 0:
                enhanced[i : i + w] = True
    return enhanced


def filter_subharmonic(f0: np.ndarray, voiced: np.ndarray,
                       fmin_hz: float = 82.4) -> Tuple[np.ndarray, np.ndarray]:
    new_f0 = f0.copy()
    new_voiced = voiced.copy()
    with np.errstate(invalid="ignore"):
        sub = f0 < fmin_hz
    new_f0[sub] = np.nan
    new_voiced[sub] = False
    for i in np.where(sub & ~np.isnan(f0))[0]:
        corrected = f0[i] * 2
        if fmin_hz <= corrected < fmin_hz * 4:
            new_f0[i] = corrected
            new_voiced[i] = True
    return new_f0, new_voiced


def distortion_score(S_db_t: np.ndarray) -> float:
    n_mels = S_db_t.shape[1]
    high = np.mean(S_db_t[:, int(n_mels * 0.7) :])
    total = np.mean(S_db_t)
    return float(high / (total + 1e-6))
