"""The part of the NumPy trend oracle (``aegis_tpu/ref/trend_ref.py``) that
the host side of the financial engine uses: the decision-code names, the
Wilder RSI of the ghost-note filter, the Savitzky-Golay kernel behind the
device taps, and the adaptive confidence threshold.
"""

from __future__ import annotations

import numpy as np

ARTIC_NONE, ARTIC_NORMAL, ARTIC_BEND, ARTIC_VIBRATO, ARTIC_NOISE = 0, 1, 2, 3, 4

ARTIC_NAMES = {0: None, 1: "normal", 2: "bend", 3: "vibrato", 4: "noise"}

SLIDE_NONE, SLIDE_UP, SLIDE_DOWN, SLIDE_NORMAL = 0, 1, 2, 3

SLIDE_NAMES = {0: None, 1: "slide_up", 2: "slide_down", 3: "normal"}


def rsi(data: np.ndarray, period: int = 14) -> np.ndarray:
    """Wilder-smoothed RSI, default 50 (financial_analysis.py:274-320)."""
    deltas = np.diff(data)
    gains = np.where(deltas > 0, deltas, 0.0)
    losses = np.where(deltas < 0, -deltas, 0.0)
    n = len(data)
    avg_g = np.full(n, np.nan)
    avg_l = np.full(n, np.nan)
    if len(gains) >= period:
        avg_g[period] = np.mean(gains[:period])
        avg_l[period] = np.mean(losses[:period])
        for i in range(period + 1, n):
            avg_g[i] = (avg_g[i - 1] * (period - 1) + gains[i - 1]) / period
            avg_l[i] = (avg_l[i - 1] * (period - 1) + losses[i - 1]) / period
    out = np.full(n, 50.0)
    for i in range(period, n):
        if avg_l[i] == 0:
            out[i] = 100.0
        else:
            out[i] = 100.0 - 100.0 / (1.0 + avg_g[i] / avg_l[i])
    return out


def _savgol_kernel(window: int, polyorder: int) -> np.ndarray:
    """Least-squares Savitzky-Golay smoothing kernel (center point)."""
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    # coefficients of the fitted value at x=0: first row of (A^T A)^-1 A^T
    coeffs = np.linalg.pinv(A)[0]
    return coeffs


def adaptive_confidence_threshold(conf: np.ndarray, method: str = "bollinger") -> float:
    """Data-driven confidence threshold (midi_logic_financial.py:78-114)."""
    valid = conf[conf > 0]
    if len(valid) == 0:
        return 0.5
    if method == "bollinger":
        thr = float(np.mean(valid) - np.std(valid))
    elif method == "percentile":
        thr = float(np.percentile(valid, 30))
    else:
        return 0.5
    return float(np.clip(thr, 0.3, 0.8))
