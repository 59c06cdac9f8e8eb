"""Fast host twin of the RSI in ``ref/trend_ref.py``, the part of
``aegis_tpu/core/trend_fast.py`` that the ghost-note filter of the
financial event extraction calls.

The Wilder recurrence runs in the C++ native core (native/trend_core.cpp)
on the same float64 values with the same expression shapes, so the output
is bit-identical to the Python loop; ``ref/trend_ref.py`` remains the spec,
and ``rsi`` runs it when the native library is unavailable or the input is
not float64.  AEGIS_NATIVE=0 disables the fast path.
"""

from __future__ import annotations

import numpy as np

from aegis_tpu_torch import native as _nat
from aegis_tpu_torch.ref import trend_ref as R


def _fast_ok(data: np.ndarray) -> bool:
    return data.dtype == np.float64 and _nat.get_lib() is not None


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
