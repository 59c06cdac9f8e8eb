"""Native (C++) host components, loaded via ctypes.

A copy of the part of ``aegis_tpu/native`` that the v1 and financial event
extraction and the live financial transcriber reach: the v1 per-frame
segmentation (events_core.cpp) and the trend-filter recurrences
(trend_core.cpp).  The build is a plain ``g++ -O3 -ffp-contract=off -shared
-fPIC`` into the user cache (keyed by a source hash) and the binding is
ctypes; ``-ffp-contract=off`` keeps the recurrences free of fused
multiply-adds on a host whose baseline ISA has them (aarch64), which their
bit-identity with the NumPy oracle needs.  These are host loops with NumPy twins of equal
output: if no compiler is present or the build fails, callers run the NumPy
implementations (tests/test_torch_engine.py holds the two equal).

The library is ``aegis_torch_native_<hash>.so`` under
``~/.cache/aegis_tpu_torch`` (or ``$AEGIS_CACHE_DIR``), so it never collides
with the JAX package's ``aegis_native_<hash>.so``.

Set ``AEGIS_NATIVE=0`` to disable the native paths entirely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "events_core.cpp"),
         os.path.join(_HERE, "trend_core.cpp")]
_LIB = None
_TRIED = False


def _cache_dir() -> str:
    d = os.environ.get("AEGIS_CACHE_DIR",
                       os.path.expanduser("~/.cache/aegis_tpu_torch"))
    return os.path.join(d, "native")


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (once, cached by source hash) and load the native library."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("AEGIS_NATIVE", "1") == "0":
        return None
    try:
        hasher = hashlib.sha256()
        for src in _SRCS:
            with open(src, "rb") as f:
                hasher.update(f.read())
        digest = hasher.hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"aegis_torch_native_{digest}.so")
        if not os.path.exists(so_path):
            os.makedirs(_cache_dir(), exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
                 "-std=c++17",
                 *_SRCS, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.aegis_segment_v1.restype = ctypes.c_long
        for name in ("ema", "kalman", "holt", "artic", "kalman_f32",
                     "holt_f32", "wilder"):
            getattr(lib, f"aegis_trend_{name}").restype = None
        _LIB = lib
    except Exception as e:  # no compiler / failed build: numpy fallback
        print(f"[aegis_torch.native] build unavailable ({e}); NumPy fallback",
              file=sys.stderr)
        _LIB = None
    return _LIB


_TECH_NAMES = {0: None, 1: "vibrato", 2: "bend", 3: "slide"}


def segment_events_v1_native(
    f0_smooth: np.ndarray,
    voiced: np.ndarray,
    probs: np.ndarray,
    rms_db: np.ndarray,
    rake: np.ndarray,
    confidence_threshold: float,
    noise_gate_db: float,
    min_frames: int,
    sustain_frames: int,
) -> Optional[List[dict]]:
    """C++ fast path for the v1 per-frame segmentation (active mask ->
    constant-note segments -> articulation -> min-duration -> sustain
    merge).  Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    T = len(f0_smooth)
    f0_c = np.ascontiguousarray(f0_smooth, np.float64)
    v_c = np.ascontiguousarray(voiced, np.uint8)
    p_c = np.ascontiguousarray(probs, np.float64)
    r_c = np.ascontiguousarray(rms_db, np.float64)
    k_c = np.ascontiguousarray(rake, np.uint8)

    cap = max(64, T // max(min_frames, 1) + 8)
    while True:
        start = np.empty(cap, np.int64)
        end = np.empty(cap, np.int64)
        note = np.empty(cap, np.int64)
        vel = np.empty(cap, np.int64)
        track = np.empty(cap, np.int64)
        tech = np.empty(cap, np.int64)
        conf = np.empty(cap, np.float64)
        rms_e = np.empty(cap, np.float64)
        slope = np.empty(cap, np.float64)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        n = lib.aegis_segment_v1(
            ptr(f0_c, ctypes.c_double), ptr(v_c, ctypes.c_uint8),
            ptr(p_c, ctypes.c_double), ptr(r_c, ctypes.c_double),
            ptr(k_c, ctypes.c_uint8), ctypes.c_long(T),
            ctypes.c_double(confidence_threshold),
            ctypes.c_double(noise_gate_db),
            ctypes.c_long(min_frames), ctypes.c_long(sustain_frames),
            ctypes.c_long(cap),
            ptr(start, ctypes.c_long), ptr(end, ctypes.c_long),
            ptr(note, ctypes.c_long), ptr(vel, ctypes.c_long),
            ptr(track, ctypes.c_long), ptr(tech, ctypes.c_long),
            ptr(conf, ctypes.c_double), ptr(rms_e, ctypes.c_double),
            ptr(slope, ctypes.c_double))
        if n < 0:
            cap = -n + 16
            continue
        return [
            {
                "note": int(note[i]),
                "start": int(start[i]),
                "end": int(end[i]),
                "confidence": float(conf[i]),
                "velocity": int(vel[i]),
                "track": "main" if track[i] else "safe",
                "rms_energy": float(rms_e[i]),
                "technique": _TECH_NAMES[int(tech[i])],
                "slope": float(slope[i]),
            }
            for i in range(n)
        ]


# --------------------------------------------------------------------------
# trend-filter recurrences (trend_core.cpp) — the strictly sequential loops
# of the financial noise-filter stack.  core/trend_fast.py routes through
# these (bit-identical to ref/trend_ref.py's Python loops; pinned
# buffer-for-buffer by tests/test_torch_realtime_copies.py); reductions and
# elementwise steps stay in numpy on the caller side.

def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def trend_ema_native(data: np.ndarray, alpha: float) -> np.ndarray:
    """ref/trend_ref.py::ema's loop (NaN-gap reset)."""
    lib = get_lib()
    x = _f64(data)
    out = np.empty(len(x), np.float64)
    lib.aegis_trend_ema(_ptr(x, ctypes.c_double), ctypes.c_long(len(x)),
                        ctypes.c_double(alpha), _ptr(out, ctypes.c_double))
    return out


def trend_kalman_native(data: np.ndarray, process_variance: float,
                        measurement_variance: float,
                        x0: float) -> np.ndarray:
    """ref/trend_ref.py::kalman's loop; ``x0`` is data[argmax(valid)]
    (the caller guarantees a valid sample exists)."""
    lib = get_lib()
    x = _f64(data)
    out = np.empty(len(x), np.float64)
    lib.aegis_trend_kalman(
        _ptr(x, ctypes.c_double), ctypes.c_long(len(x)),
        ctypes.c_double(process_variance),
        ctypes.c_double(measurement_variance), ctypes.c_double(x0),
        _ptr(out, ctypes.c_double))
    return out


def trend_holt_native(data: np.ndarray, alpha: float, beta: float,
                      level0: float, trend0: float) -> np.ndarray:
    """ref/trend_ref.py::holt_winters's loop; init values from the first
    two valid samples (the caller guarantees >= 2)."""
    lib = get_lib()
    x = _f64(data)
    out = np.empty(len(x), np.float64)
    lib.aegis_trend_holt(
        _ptr(x, ctypes.c_double), ctypes.c_long(len(x)),
        ctypes.c_double(alpha), ctypes.c_double(beta),
        ctypes.c_double(level0), ctypes.c_double(trend0),
        _ptr(out, ctypes.c_double))
    return out


def trend_artic_native(f0: np.ndarray, upper: np.ndarray,
                       lower: np.ndarray) -> np.ndarray:
    """ref/trend_ref.py::detect_articulation_bollinger's state machine."""
    lib = get_lib()
    f = _f64(f0)
    out = np.empty(len(f), np.int8)
    lib.aegis_trend_artic(
        _ptr(f, ctypes.c_double), _ptr(_f64(upper), ctypes.c_double),
        _ptr(_f64(lower), ctypes.c_double), ctypes.c_long(len(f)),
        _ptr(out, ctypes.c_byte))
    return out


def trend_wilder_native(gains: np.ndarray, losses: np.ndarray, n: int,
                        period: int, seed_g: float, seed_l: float,
                        avg_g: np.ndarray, avg_l: np.ndarray) -> None:
    """ref/trend_ref.py::rsi's Wilder recurrence, filling avg_g/avg_l
    in-place for i in [period+1, n) (seeds at index ``period`` and the
    leading NaNs are the caller's)."""
    lib = get_lib()
    lib.aegis_trend_wilder(
        _ptr(_f64(gains), ctypes.c_double),
        _ptr(_f64(losses), ctypes.c_double),
        ctypes.c_long(n), ctypes.c_long(period),
        ctypes.c_double(seed_g), ctypes.c_double(seed_l),
        _ptr(avg_g, ctypes.c_double), _ptr(avg_l, ctypes.c_double))


def trend_kalman_f32_native(data: np.ndarray, process_variance: float,
                            measurement_variance: float,
                            x0: float) -> np.ndarray:
    """ref/trend_ref.py::kalman on a FLOAT32 input (the recurrence runs in
    float32 under numpy's weak promotion; see trend_core.cpp)."""
    lib = get_lib()
    x = np.ascontiguousarray(data, np.float32)
    out = np.empty(len(x), np.float64)
    lib.aegis_trend_kalman_f32(
        _ptr(x, ctypes.c_float), ctypes.c_long(len(x)),
        ctypes.c_double(process_variance),
        ctypes.c_double(measurement_variance), ctypes.c_float(x0),
        _ptr(out, ctypes.c_double))
    return out


def trend_holt_f32_native(data: np.ndarray, alpha: float, beta: float,
                          level0: float, trend0: float) -> np.ndarray:
    """ref/trend_ref.py::holt_winters on a FLOAT32 input (float32
    recurrence, see trend_core.cpp)."""
    lib = get_lib()
    x = np.ascontiguousarray(data, np.float32)
    out = np.empty(len(x), np.float64)
    lib.aegis_trend_holt_f32(
        _ptr(x, ctypes.c_float), ctypes.c_long(len(x)),
        ctypes.c_double(alpha), ctypes.c_double(beta),
        ctypes.c_float(level0), ctypes.c_float(trend0),
        _ptr(out, ctypes.c_double))
    return out
