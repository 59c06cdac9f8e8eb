"""Fast host twins of the financial trend oracle (``ref/trend_ref.py``).

A copy of ``aegis_tpu/core/trend_fast.py``.  The live financial poll re-runs
the trend stack over its incremental window
(engine/realtime.py::_trend_incremental) and ``finalize()`` re-runs it over
the whole session; the oracle's Python loops take an interpreter step per
frame and filter.  This module is the drop-in fast path:

* the strictly sequential recurrences (ema, kalman, holt, the articulation
  state machine, Wilder's RSI smoothing) run in the C++ native core
  (native/trend_core.cpp) — same float64 values, same expression shapes,
  no FMA/reassociation, so the outputs are bit-identical;
* everything else (convolutions, the sliding-window Bollinger std, NaN
  medians, decision ladders) is either already vectorized in the oracle or
  vectorized here with copy/compare-only transforms that cannot round.

``ref/trend_ref.py`` remains the SPEC and the oracle; every function here
falls back to it when the native library is unavailable or on an input
dtype without an exact mirror.  float64 AND float32 both ride the fast
path: the live engine feeds float32 f0 (matching the device program's
dtype), under which numpy's weak promotion runs the kalman/holt
recurrences in float32 — mirrored exactly by the _f32 native variants.
Bit-identity is pinned buffer-for-buffer by
tests/test_torch_realtime_copies.py; AEGIS_NATIVE=0 disables the fast paths.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np

from aegis_tpu_torch import native as _nat
from aegis_tpu_torch.ref import trend_ref as R

# decision codes are the oracle's (single source of truth)
from aegis_tpu_torch.ref.trend_ref import (ARTIC_NAMES, ARTIC_NONE,  # noqa: F401
                                     SLIDE_DOWN, SLIDE_NAMES, SLIDE_NONE,
                                     SLIDE_NORMAL, SLIDE_UP)


def _fast_ok(data: np.ndarray) -> bool:
    return data.dtype == np.float64 and _nat.get_lib() is not None


#: NumPy >= 2 promotes ``python_float * np.float32`` to float32 (NEP 50);
#: under 1.x's value-based promotion the oracle's kalman / holt recurrences
#: run in float64 on a float32 input, and the float32 C++ mirrors diverge
_WEAK_PROMOTION = int(np.__version__.split(".")[0]) >= 2


def _fast_ok32(data: np.ndarray) -> bool:
    # the live engine feeds the trend stack float32 f0 (matching the device
    # program's dtype); kalman/holt have float32-exact native variants and
    # the vectorized pieces are dtype-transparent, so float32 rides the
    # fast path too, where NumPy's promotion is the one those variants
    # mirror.  Anything else falls back to the oracle (numpy's promotion
    # rules would diverge from the C++ mirror).
    if data.dtype == np.float32 and not _WEAK_PROMOTION:
        return False
    return (data.dtype in (np.float32, np.float64)
            and _nat.get_lib() is not None)


# ------------------------------------------------------------- recurrences

def ema(data: np.ndarray, span: int = 5) -> np.ndarray:
    """ref/trend_ref.py::ema (NaN-gap reset), native recurrence."""
    data = np.asarray(data)
    if not _fast_ok(data):
        return R.ema(data, span)
    return _nat.trend_ema_native(data, 2.0 / (span + 1.0))


def kalman(data: np.ndarray, process_variance: float = 1e-5,
           measurement_variance: float = 1e-1) -> np.ndarray:
    """ref/trend_ref.py::kalman, native recurrence."""
    data = np.asarray(data)
    if not _fast_ok32(data):
        return R.kalman(data, process_variance, measurement_variance)
    valid = ~np.isnan(data)
    if not valid.any():
        return data.copy()
    x0 = float(data[int(np.argmax(valid))])
    if data.dtype == np.float32:
        return _nat.trend_kalman_f32_native(data, process_variance,
                                            measurement_variance, x0)
    return _nat.trend_kalman_native(data, process_variance,
                                    measurement_variance, x0)


def holt_winters(data: np.ndarray, alpha: float = 0.3,
                 beta: float = 0.1) -> np.ndarray:
    """ref/trend_ref.py::holt_winters, native recurrence."""
    data = np.asarray(data)
    if not _fast_ok32(data):
        return R.holt_winters(data, alpha, beta)
    fv = np.where(~np.isnan(data))[0]
    if len(fv) < 2:
        return data.copy()
    level0 = float(data[fv[0]])
    # for float32 input the subtraction rounds in float32 (weak promotion)
    trend0 = float(data[fv[1]] - data[fv[0]])
    if data.dtype == np.float32:
        return _nat.trend_holt_f32_native(data, alpha, beta, level0, trend0)
    return _nat.trend_holt_native(data, alpha, beta, level0, trend0)


# ------------------------------------------------- copy-only vectorizations

def forward_fill(data: np.ndarray) -> np.ndarray:
    """ref/trend_ref.py::forward_fill as one gather (it only MOVES values —
    no arithmetic — so the vectorized form is bit-identical by
    construction; no native code needed)."""
    data = np.asarray(data)
    n = len(data)
    valid = ~np.isnan(data)
    idx = np.where(valid, np.arange(n), -1)
    np.maximum.accumulate(idx, out=idx)
    return np.where(idx >= 0, data[np.maximum(idx, 0)], np.nan)


def savgol(data: np.ndarray, window: int = 11,
           polyorder: int = 3) -> np.ndarray:
    """ref/trend_ref.py::savgol with the vectorized forward fill; the
    convolution itself is the same np.convolve call on the same values."""
    data = np.asarray(data)
    valid = ~np.isnan(data)
    if valid.sum() <= window:
        return np.full_like(data, np.nan, dtype=np.float64)
    filled = forward_fill(data)
    first = int(np.argmax(valid))
    filled[:first] = data[first]
    half = window // 2
    padded = np.pad(filled, half, mode="edge")
    kernel = R._savgol_kernel(window, polyorder)
    out = np.convolve(padded, kernel[::-1], mode="valid")
    out[~valid] = np.nan
    return out


# --------------------------------------------------------- composite stacks

def macd(data: np.ndarray, fast: int = 12, slow: int = 26, signal: int = 9):
    macd_line = ema(data, fast) - ema(data, slow)
    signal_line = ema(macd_line, signal)
    return macd_line, signal_line, macd_line - signal_line


def detect_slides_macd(f0: np.ndarray,
                       threshold: float = 0.5) -> np.ndarray:
    """ref/trend_ref.py::detect_slides_macd; the per-frame decision ladder
    is comparisons only (NaN compares False, exactly like the elif
    chain)."""
    f0 = np.asarray(f0)
    if not _fast_ok32(f0):
        return R.detect_slides_macd(f0, threshold)
    semis = np.full_like(f0, np.nan, dtype=np.float64)
    valid = ~np.isnan(f0)
    semis[valid] = 12.0 * np.log2(f0[valid] / 440.0) + 69.0
    macd_line, _, hist = macd(semis, fast=5, slow=20, signal=9)
    return np.where(
        np.isnan(macd_line), SLIDE_NONE,
        np.where((macd_line > threshold) & (hist > 0), SLIDE_UP,
                 np.where((macd_line < -threshold) & (hist < 0),
                          SLIDE_DOWN, SLIDE_NORMAL))).astype(np.int8)


def detect_articulation_bollinger(f0: np.ndarray, window: int = 10,
                                  sensitivity: float = 2.0) -> np.ndarray:
    """ref/trend_ref.py::detect_articulation_bollinger; bands from the
    oracle's (already vectorized) bollinger, state machine in C++."""
    f0 = np.asarray(f0)
    if not _fast_ok32(f0):
        return R.detect_articulation_bollinger(f0, window, sensitivity)
    _, upper, lower = R.bollinger(f0, window, sensitivity)
    return _nat.trend_artic_native(f0, upper, lower)


def bollinger_confidence(f0: np.ndarray, window: int = 10) -> np.ndarray:
    """ref/trend_ref.py::bollinger_confidence; the loop is elementwise
    (same 1/(1+bw) doubles, same zeros elsewhere)."""
    f0 = np.asarray(f0)
    if f0.dtype not in (np.float32, np.float64):
        return R.bollinger_confidence(f0, window)
    _, upper, lower = R.bollinger(f0, window)
    bw = upper - lower
    conf = np.zeros(len(f0))
    ok = ~np.isnan(f0) & ~np.isnan(bw)
    if ok.any():
        b = bw[ok]
        with np.errstate(divide="ignore", over="ignore"):
            conf[ok] = np.where(b > 0, 1.0 / (1.0 + b), 1.0)
    return conf


def rsi(data: np.ndarray, period: int = 14) -> np.ndarray:
    """ref/trend_ref.py::rsi; np.mean seeds stay in numpy (pairwise sum not
    replicated), the Wilder recurrence runs native, the output ladder is
    elementwise."""
    data = np.asarray(data)
    if not _fast_ok(data):
        return R.rsi(data, period)
    deltas = np.diff(data)
    gains = np.where(deltas > 0, deltas, 0.0)
    losses = np.where(deltas < 0, -deltas, 0.0)
    n = len(data)
    avg_g = np.full(n, np.nan)
    avg_l = np.full(n, np.nan)
    if len(gains) >= period:
        avg_g[period] = np.mean(gains[:period])
        avg_l[period] = np.mean(losses[:period])
        _nat.trend_wilder_native(gains, losses, n, period,
                                 float(avg_g[period]), float(avg_l[period]),
                                 avg_g, avg_l)
    out = np.full(n, 50.0)
    if n > period:
        g, l = avg_g[period:], avg_l[period:]
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = 100.0 - 100.0 / (1.0 + g / l)
        out[period:] = np.where(l == 0, 100.0, vals)
    return out


def multi_filter_consensus(
        data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ref/trend_ref.py::multi_filter_consensus over the fast filters
    (same nanmedian/nanstd calls on the same stacked values)."""
    data = np.asarray(data)
    if not _fast_ok32(data):
        return R.multi_filter_consensus(data)
    stacked = np.stack([savgol(data), kalman(data), holt_winters(data)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        consensus = np.nanmedian(stacked, axis=0)
        std = np.nanstd(stacked, axis=0)
    return consensus, 1.0 / (1.0 + std)


def analyze_pitch_financial(f0_clean: np.ndarray) -> dict:
    """Drop-in fast twin of ref/trend_ref.py::analyze_pitch_financial."""
    f0_clean = np.asarray(f0_clean)
    if not _fast_ok32(f0_clean):
        return R.analyze_pitch_financial(f0_clean)
    trend, filter_conf = multi_filter_consensus(f0_clean)
    return {
        "trend": trend,
        "filter_confidence": filter_conf,
        "articulations": detect_articulation_bollinger(f0_clean, window=10),
        "slides": detect_slides_macd(f0_clean, threshold=0.3),
        "confidence": bollinger_confidence(f0_clean, window=10),
    }
