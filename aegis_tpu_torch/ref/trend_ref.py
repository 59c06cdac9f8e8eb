"""NumPy oracle for the "financial" trend/noise filters.

A whole copy of ``aegis_tpu/ref/trend_ref.py``.  Loop-style implementations
that mirror the reference modules (aegis_engine_core_v2/financial_filters.py
and financial_analysis.py): they define the CPU-side semantics; the fast
host twins of ``core/trend_fast.py`` are pinned byte for byte to them, and
the device scans of ``core/trend.py`` are parity-tested against them.  The
ATR, Ichimoku and stochastic filters are the reference's too; nothing else
in this package calls them.

Documented deviation from the reference repo: Savitzky-Golay there compacts
NaN gaps before filtering (financial_filters.py:41-55), which is inherently
ragged.  Here (both oracle and device) we forward-fill NaN gaps, convolve with
the SG kernel (mode="nearest" edges), and restore NaNs — same passband
behavior, fixed shapes.  If fewer than `window` values are valid the output is
all-NaN (matching the reference's guard).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------- moving avgs

def sma(data: np.ndarray, window: int = 5) -> np.ndarray:
    """Simple moving average; NaNs contribute zero (matching reference
    financial_analysis.py:45-69) and NaN positions are restored."""
    valid = np.where(np.isnan(data), 0.0, data)
    kernel = np.ones(window) / window
    out = np.convolve(valid, kernel, mode="same")
    out[np.isnan(data)] = np.nan
    return out


def ema(data: np.ndarray, span: int = 5) -> np.ndarray:
    """Exponential moving average; NaN gaps reset the filter
    (financial_analysis.py:71-107)."""
    alpha = 2.0 / (span + 1.0)
    out = np.full_like(data, np.nan, dtype=np.float64)
    prev = np.nan
    started = False
    for i, x in enumerate(data):
        if np.isnan(x):
            prev = np.nan if started else prev
            continue
        if not started:
            out[i] = x
            prev = x
            started = True
        else:
            out[i] = x if np.isnan(prev) else alpha * x + (1 - alpha) * prev
            prev = out[i]
    return out


def bollinger(data: np.ndarray, window: int = 20, num_std: float = 2.0):
    """(ma, upper, lower): SMA center, trailing-window NaN-aware std
    (financial_analysis.py:113-146).

    The per-window two-pass std runs as ONE sliding-window reduction —
    bit-identical to the per-frame ``np.std(valid)`` loop it replaces:
    NaN slots contribute EXACT zeros to the window sums, adding
    0.0 never rounds, and numpy's last-axis reduce is sequential below
    the 128-element pairwise blocksize, so the nonzero partial-sum order
    equals the compacted array's."""
    data = np.asarray(data, np.float64)
    ma = sma(data, window)
    T = len(data)
    std = np.full(T, np.nan, np.float64)
    if T:
        pad = np.concatenate([np.full(window - 1, np.nan), data])
        win = np.lib.stride_tricks.sliding_window_view(pad, window)
        mask = ~np.isnan(win)
        n = mask.sum(axis=1)
        ok = n > 1
        x0 = np.where(mask, win, 0.0)
        mean = np.divide(x0.sum(axis=1), n, out=np.zeros(T), where=ok)
        d = np.where(mask, win - mean[:, None], 0.0)
        var = np.divide((d * d).sum(axis=1), n, out=np.zeros(T), where=ok)
        std = np.where(ok, np.sqrt(var), np.nan)
    return ma, ma + num_std * std, ma - num_std * std


# -------------------------------------------------------------- articulations

ARTIC_NONE, ARTIC_NORMAL, ARTIC_BEND, ARTIC_VIBRATO, ARTIC_NOISE = 0, 1, 2, 3, 4
ARTIC_NAMES = {0: None, 1: "normal", 2: "bend", 3: "vibrato", 4: "noise"}


def detect_articulation_bollinger(
    f0: np.ndarray, window: int = 10, sensitivity: float = 2.0
) -> np.ndarray:
    """Per-frame articulation codes from Bollinger band position
    (financial_analysis.py:148-197).  Codes: 0 none(NaN), 1 normal, 2 bend,
    3 vibrato, 4 noise."""
    _, upper, lower = bollinger(f0, window, sensitivity)
    out = np.zeros(len(f0), dtype=np.int8)
    prev_state = 0  # 0 normal, 1 above, 2 below
    counter = 0
    for i in range(len(f0)):
        if np.isnan(f0[i]):
            out[i] = ARTIC_NONE
            continue
        if not np.isnan(upper[i]) and f0[i] > upper[i]:
            state = 1
        elif not np.isnan(lower[i]) and f0[i] < lower[i]:
            state = 2
        else:
            state = 0
        if prev_state != state and prev_state != 0:
            counter += 1
        else:
            counter = 0
        if counter >= 2:
            out[i] = ARTIC_VIBRATO
        elif state == 1:
            out[i] = ARTIC_BEND
        elif state == 2:
            out[i] = ARTIC_NOISE
        else:
            out[i] = ARTIC_NORMAL
        prev_state = state
    return out


# ---------------------------------------------------------------------- MACD

def macd(data: np.ndarray, fast: int = 12, slow: int = 26, signal: int = 9):
    macd_line = ema(data, fast) - ema(data, slow)
    signal_line = ema(macd_line, signal)
    return macd_line, signal_line, macd_line - signal_line


SLIDE_NONE, SLIDE_UP, SLIDE_DOWN, SLIDE_NORMAL = 0, 1, 2, 3
SLIDE_NAMES = {0: None, 1: "slide_up", 2: "slide_down", 3: "normal"}


def detect_slides_macd(f0: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """MACD(5,20,9) on semitone-converted f0 → slide codes
    (financial_analysis.py:228-268)."""
    semis = np.full_like(f0, np.nan, dtype=np.float64)
    valid = ~np.isnan(f0)
    semis[valid] = 12.0 * np.log2(f0[valid] / 440.0) + 69.0
    macd_line, _, hist = macd(semis, fast=5, slow=20, signal=9)
    out = np.zeros(len(f0), dtype=np.int8)
    for i in range(len(macd_line)):
        if np.isnan(macd_line[i]):
            out[i] = SLIDE_NONE
        elif macd_line[i] > threshold and hist[i] > 0:
            out[i] = SLIDE_UP
        elif macd_line[i] < -threshold and hist[i] < 0:
            out[i] = SLIDE_DOWN
        else:
            out[i] = SLIDE_NORMAL
    return out


# ----------------------------------------------------------------------- RSI

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


# -------------------------------------------------------------- noise filters

def kalman(data: np.ndarray, process_variance: float = 1e-5,
           measurement_variance: float = 1e-1) -> np.ndarray:
    """Scalar Kalman filter; NaN frames pass through without state update
    (financial_filters.py:61-99)."""
    valid = ~np.isnan(data)
    if not valid.any():
        return data.copy()
    out = np.full_like(data, np.nan, dtype=np.float64)
    first = int(np.argmax(valid))
    x_est, p_est = data[first], 1.0
    for i in range(len(data)):
        if not valid[i]:
            continue
        p_pred = p_est + process_variance
        k = p_pred / (p_pred + measurement_variance)
        x_est = x_est + k * (data[i] - x_est)
        p_est = (1 - k) * p_pred
        out[i] = x_est
    return out


def holt_winters(data: np.ndarray, alpha: float = 0.3, beta: float = 0.1) -> np.ndarray:
    """Level+trend exponential smoothing; initialized from the first two valid
    samples (financial_filters.py:101-141)."""
    valid = ~np.isnan(data)
    fv = np.where(valid)[0]
    if len(fv) < 2:
        return data.copy()
    out = np.full_like(data, np.nan, dtype=np.float64)
    level = data[fv[0]]
    trend = data[fv[1]] - data[fv[0]]
    for i in range(len(data)):
        if not valid[i]:
            continue
        forecast = level + trend
        level_new = alpha * data[i] + (1 - alpha) * forecast
        trend = beta * (level_new - level) + (1 - beta) * trend
        level = level_new
        out[i] = level
    return out


def _savgol_kernel(window: int, polyorder: int) -> np.ndarray:
    """Least-squares Savitzky-Golay smoothing kernel (center point)."""
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    # coefficients of the fitted value at x=0: first row of (A^T A)^-1 A^T
    coeffs = np.linalg.pinv(A)[0]
    return coeffs


def forward_fill(data: np.ndarray) -> np.ndarray:
    out = data.copy()
    last = np.nan
    for i in range(len(out)):
        if np.isnan(out[i]):
            out[i] = last
        else:
            last = out[i]
    return out


def savgol(data: np.ndarray, window: int = 11, polyorder: int = 3) -> np.ndarray:
    """NaN-aware Savitzky-Golay (see module docstring for the forward-fill
    deviation)."""
    valid = ~np.isnan(data)
    if valid.sum() <= window:
        return np.full_like(data, np.nan, dtype=np.float64)
    filled = forward_fill(data)
    # leading NaNs: back-fill with first valid value ("nearest" edge behavior)
    first = int(np.argmax(valid))
    filled[:first] = data[first]
    half = window // 2
    padded = np.pad(filled, half, mode="edge")
    kernel = _savgol_kernel(window, polyorder)
    out = np.convolve(padded, kernel[::-1], mode="valid")
    out[~valid] = np.nan
    return out


def atr_filter(data: np.ndarray, window: int = 14, threshold: float = 2.0):
    """(filtered, noise_mask): spikes beyond ATR*threshold replaced by the
    previous kept value (financial_filters.py:143-180)."""
    n = len(data)
    tr = np.abs(np.diff(data))
    atr = np.full(n, np.nan)
    for i in range(window, len(tr)):
        w = tr[max(0, i - window) : i]
        if (~np.isnan(w)).any():
            atr[i] = np.nanmean(w)
    noise = np.zeros(n, dtype=bool)
    for i in range(1, n):
        if not np.isnan(atr[i]) and not np.isnan(data[i]):
            if np.abs(data[i] - data[i - 1]) > atr[i] * threshold:
                noise[i] = True
    filtered = data.copy()
    for i in range(n):
        if noise[i]:
            filtered[i] = filtered[i - 1] if i > 0 else data[i]
    return filtered, noise


def ichimoku_baseline(data: np.ndarray, kijun: int = 26) -> np.ndarray:
    """Kijun-sen baseline: trailing-window (max+min)/2
    (financial_filters.py:182-213)."""
    out = np.full_like(data, np.nan, dtype=np.float64)
    for i in range(kijun, len(data)):
        w = data[max(0, i - kijun) : i]
        v = w[~np.isnan(w)]
        if len(v) > 0:
            out[i] = (np.max(v) + np.min(v)) / 2
    return out


def stochastic(data: np.ndarray, k_period: int = 14, smooth: int = 3) -> np.ndarray:
    """%D stochastic oscillator, default 50 (financial_filters.py:215-249)."""
    n = len(data)
    if not (~np.isnan(data)).any():
        return np.full(n, 50.0)
    k_values = np.full(n, 50.0)
    for i in range(k_period, n):
        w = data[max(0, i - k_period) : i + 1]
        v = w[~np.isnan(w)]
        if len(v) > 0:
            low, high = np.min(v), np.max(v)
            if high - low > 0:
                k_values[i] = (data[i] - low) / (high - low) * 100.0
    d_values = np.full(n, 50.0)
    for i in range(smooth, n):
        d_values[i] = np.mean(k_values[max(0, i - smooth) : i + 1])
    return d_values


# ------------------------------------------------------------------ consensus

def multi_filter_consensus(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Median consensus of {savgol, kalman, holt} with confidence
    1/(1+std-across-filters) (financial_filters.py:256-298)."""
    stacked = np.stack([savgol(data), kalman(data), holt_winters(data)])
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        consensus = np.nanmedian(stacked, axis=0)
        std = np.nanstd(stacked, axis=0)
    return consensus, 1.0 / (1.0 + std)


def bollinger_confidence(f0: np.ndarray, window: int = 10) -> np.ndarray:
    """Narrow Bollinger band => high confidence
    (financial_analysis.py:404-416)."""
    _, upper, lower = bollinger(f0, window)
    bw = upper - lower
    conf = np.zeros(len(f0))
    for i in range(len(f0)):
        if not np.isnan(f0[i]) and not np.isnan(bw[i]):
            conf[i] = 1.0 / (1.0 + bw[i]) if bw[i] > 0 else 1.0
    return conf


def analyze_pitch_financial(f0_clean: np.ndarray) -> dict:
    """Integrated financial pitch analysis (financial_analysis.py:368-423)."""
    trend, filter_conf = multi_filter_consensus(f0_clean)
    return {
        "trend": trend,
        "filter_confidence": filter_conf,
        "articulations": detect_articulation_bollinger(f0_clean, window=10),
        "slides": detect_slides_macd(f0_clean, threshold=0.3),
        "confidence": bollinger_confidence(f0_clean, window=10),
    }


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
