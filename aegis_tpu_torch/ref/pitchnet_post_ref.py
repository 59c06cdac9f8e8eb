"""NumPy oracle for the PitchNet post-processing (models/pitchnet.py:
smooth_f0_median and _onset_backfill) — the deterministic device-side
logic around the learned net keeps the repo's oracle+parity convention
even though the net itself is gated by accuracy tests instead.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from aegis_tpu_torch.models.pitchnet import FMIN_HZ


def smooth_f0_median_ref(f0: np.ndarray, voiced: np.ndarray,
                         smooth: int = 5) -> np.ndarray:
    cents = np.where(voiced, 1200.0 * np.log2(
        np.maximum(f0, 1e-12) / FMIN_HZ), np.nan)
    if smooth > 1:
        half = smooth // 2
        cp = np.pad(cents, half, constant_values=np.nan)
        out = cents.copy()
        for i in range(len(cents)):
            if np.isnan(cents[i]):
                continue
            win = cp[i:i + smooth]
            out[i] = np.nanmedian(win)
        cents = out
    return FMIN_HZ * np.exp2(cents / 1200.0)


def onset_backfill_ref(pitch: Dict[str, np.ndarray], onset_env: np.ndarray,
                       frames_per_second: float) -> Dict[str, np.ndarray]:
    k = max(int(round(0.14 * frames_per_second)), 1)
    max_fill = max(int(round(0.095 * frames_per_second)), 1)
    lock = max(int(round(0.045 * frames_per_second)), 0)  # pyin lock delay
    voiced = pitch["voiced_flag"].astype(bool)
    f0 = pitch["f0"].astype(np.float64)
    vprob = pitch["voiced_probs"].astype(np.float64)
    T = len(voiced)

    def next_voiced_within(i, width):
        for s in range(1, width + 1):
            if i + s < T and voiced[i + s]:
                return i + s
        return None

    prev = np.concatenate([onset_env[:1], onset_env[:-1]])
    nxt = np.concatenate([onset_env[1:], onset_env[-1:]])
    peak = (onset_env >= prev) & (onset_env >= nxt) & (
        onset_env > 0.2 * np.max(onset_env))

    out_f0 = f0.copy()
    out_v = voiced.copy()
    out_p = vprob.copy()
    for i in range(T):
        if voiced[i]:
            continue
        r = next_voiced_within(i, max_fill)
        if r is None:
            continue
        # an anchoring peak between `lock` (pyin's pitch-lock delay — fills
        # may not reach closer to the attack than pyin itself locks) and k
        # frames before i that leads into a voiced run within k frames
        anchored = False
        for s in range(lock, k + 1):
            j = i - s
            if j < 0:
                break
            if peak[j] and (voiced[j]
                            or next_voiced_within(j, k) is not None):
                anchored = True
                break
        if not anchored:
            continue
        out_f0[i] = f0[r]
        out_p[i] = vprob[r]
        out_v[i] = True
    return {"f0": out_f0, "voiced_flag": out_v, "voiced_probs": out_p}
