"""Native (C++) host components, loaded via ctypes.

A copy of ``aegis_tpu/native``: the v1 per-frame segmentation
(events_core.cpp), the polyphonic recovery chain (poly_recover.cpp: the
envelope-statistics cache and the raw-CQT passes of ``core/poly.py``) and
the trend-filter recurrences (trend_core.cpp).  The build is a plain ``g++ -O3 -ffp-contract=off -shared
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

The build runs once a process, under a lock: a thread that asks while
another builds waits and gets the finished library (the REST server's
request threads reach it together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "events_core.cpp"),
         os.path.join(_HERE, "poly_recover.cpp"),
         os.path.join(_HERE, "trend_core.cpp")]
_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def _cache_dir() -> str:
    d = os.environ.get("AEGIS_CACHE_DIR",
                       os.path.expanduser("~/.cache/aegis_tpu_torch"))
    return os.path.join(d, "native")


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (once, cached by source hash) and load the native library."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _load()
            _TRIED = True   # after _LIB: a reader that sees it sees the library
    return _LIB


def _load() -> Optional[ctypes.CDLL]:
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
            tmp = so_path + f".tmp{os.getpid()}.{threading.get_ident()}"
            subprocess.run(
                ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
                 "-std=c++17",
                 *_SRCS, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.aegis_segment_v1.restype = ctypes.c_long
        lib.aegis_env_new_f32.restype = ctypes.c_void_p
        lib.aegis_env_new_f64.restype = ctypes.c_void_p
        lib.aegis_env_free.argtypes = [ctypes.c_void_p]
        lib.aegis_env_med.restype = ctypes.c_double
        lib.aegis_poly_rescue.restype = ctypes.c_long
        lib.aegis_poly_recover_octaves.restype = ctypes.c_long
        lib.aegis_poly_recover_fifths.restype = ctypes.c_long
        lib.aegis_poly_roll_runs.restype = ctypes.c_long
        for name in ("ema", "kalman", "holt", "artic", "kalman_f32",
                     "holt_f32", "wilder"):
            getattr(lib, f"aegis_trend_{name}").restype = None
        return lib
    except Exception as e:  # no compiler / failed build: numpy fallback
        print(f"[aegis_torch.native] build unavailable ({e}); NumPy fallback",
              file=sys.stderr)
        return None


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
# poly recovery-chain natives (poly_recover.cpp) — the envelope-statistics
# cache plus the four heavy raw-CQT passes.  core/poly.py routes through
# these when the library is available; the Python implementations remain the
# spec (decision parity on the truth corpora: tests/test_torch_poly_copies.py).

def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _soa(events, key, dtype, default=None):
    if default is None:
        it = (e[key] for e in events)
    else:
        it = (e.get(key, default) for e in events)
    return np.fromiter(it, dtype, len(events))


class EnvHandle:
    """Owns a native EnvCache over one dB plane (medians + shape fits are
    memoized C++-side and shared by every native pass and scalar query)."""

    def __init__(self, db: np.ndarray, fps: float):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.T, self.B = db.shape
        self.is_f32 = db.dtype == np.float32
        if self.is_f32:
            self._db = np.ascontiguousarray(db, np.float32)
            self._h = lib.aegis_env_new_f32(
                _ptr(self._db, ctypes.c_float), ctypes.c_long(self.T),
                ctypes.c_long(self.B), ctypes.c_double(fps))
        else:
            self._db = np.ascontiguousarray(db, np.float64)
            self._h = lib.aegis_env_new_f64(
                _ptr(self._db, ctypes.c_double), ctypes.c_long(self.T),
                ctypes.c_long(self.B), ctypes.c_double(fps))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.aegis_env_free(ctypes.c_void_p(h))
            self._h = None

    def med_row(self, lo: int, hi: int) -> np.ndarray:
        out = np.empty(self.B, np.float64)
        self._lib.aegis_env_med_row(
            ctypes.c_void_p(self._h), ctypes.c_long(lo), ctypes.c_long(hi),
            _ptr(out, ctypes.c_double))
        # medians of a float32 plane are float32 values (exact widenings);
        # narrowing back is lossless and matches the numpy row dtype
        return out.astype(np.float32) if self.is_f32 else out

    def shape(self, lo: int, hi: int, b: int) -> tuple:
        out = np.empty(2, np.float64)
        self._lib.aegis_env_shape(
            ctypes.c_void_p(self._h), ctypes.c_long(lo), ctypes.c_long(hi),
            ctypes.c_long(b), _ptr(out, ctypes.c_double))
        return float(out[0]), float(out[1])


def _event_arrays(events):
    note = _soa(events, "note", np.int64)
    start = _soa(events, "start", np.int64)
    end = _soa(events, "end", np.int64)
    sal = _soa(events, "salience", np.float64, 0.0)
    return note, start, end, sal


def poly_rescue_native(h: EnvHandle, events, binw, fmin, n_bins,
                       track_max_db, live_floor_db, max_resid, max_curv,
                       max_slope, leak_bins, attack_skip_s, min_frames):
    """Mint list [(src_index, note, salience)] mirroring
    core/poly.py::rescue_dead_fundamentals's discovery order."""
    note, start, end, sal = _event_arrays(events)
    cap = max(64, len(events))
    while True:
        out_src = np.empty(cap, np.int64)
        out_note = np.empty(cap, np.int64)
        out_sal = np.empty(cap, np.float64)
        m = h._lib.aegis_poly_rescue(
            ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
            _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
            _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
            ctypes.c_double(binw), ctypes.c_long(fmin),
            ctypes.c_long(n_bins), ctypes.c_double(track_max_db),
            ctypes.c_double(live_floor_db), ctypes.c_double(max_resid),
            ctypes.c_double(max_curv), ctypes.c_double(max_slope),
            ctypes.c_double(leak_bins), ctypes.c_double(attack_skip_s),
            ctypes.c_long(min_frames), ctypes.c_long(cap),
            _ptr(out_src, ctypes.c_long), _ptr(out_note, ctypes.c_long),
            _ptr(out_sal, ctypes.c_double))
        if m < 0:
            cap = -m + 16
            continue
        return [(int(out_src[i]), int(out_note[i]), float(out_sal[i]))
                for i in range(m)]


def poly_recover_octaves_native(h: EnvHandle, events, fmin, n_bins,
                                track_max_db, sr, resid_thr, curv_thr,
                                rel_factor, attack_skip_s, min_frames,
                                level_floor_db, parent_ghost_ratio,
                                feeder_floor_db):
    """(mints [(parent_index, salience)], uncertain bool array) mirroring
    core/poly.py::recover_octave_doublings."""
    note, start, end, sal = _event_arrays(events)
    rescued = _soa(events, "rescued_root", np.uint8, False)
    cap = max(64, len(events))
    while True:
        out_parent = np.empty(cap, np.int64)
        out_sal = np.empty(cap, np.float64)
        out_unc = np.zeros(max(len(events), 1), np.uint8)
        m = h._lib.aegis_poly_recover_octaves(
            ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
            _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
            _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
            _ptr(rescued, ctypes.c_uint8),
            ctypes.c_long(fmin), ctypes.c_long(n_bins),
            ctypes.c_double(track_max_db), ctypes.c_long(sr),
            ctypes.c_double(resid_thr), ctypes.c_double(curv_thr),
            ctypes.c_double(rel_factor), ctypes.c_double(attack_skip_s),
            ctypes.c_long(min_frames), ctypes.c_double(level_floor_db),
            ctypes.c_double(parent_ghost_ratio),
            ctypes.c_double(feeder_floor_db), ctypes.c_long(cap),
            _ptr(out_parent, ctypes.c_long), _ptr(out_sal, ctypes.c_double),
            _ptr(out_unc, ctypes.c_uint8))
        if m < 0:
            cap = -m + 16
            continue
        mints = [(int(out_parent[i]), float(out_sal[i])) for i in range(m)]
        return mints, out_unc[: len(events)].astype(bool)


def poly_drop_leakage_native(h: EnvHandle, events, binw, fmin, n_bins,
                             leak_bins, margin_db, attack_skip_s,
                             min_frames):
    """Keep mask mirroring core/poly.py::drop_leakage_ghosts."""
    note, start, end, _sal = _event_arrays(events)
    exempt = np.fromiter(
        (bool(e.get("recovered_octave") or e.get("recovered_fifth")
              or e.get("repitched_octave") or e.get("rescued_root"))
         for e in events), np.uint8, len(events))
    keep = np.zeros(max(len(events), 1), np.uint8)
    h._lib.aegis_poly_drop_leakage(
        ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long), _ptr(exempt, ctypes.c_uint8),
        ctypes.c_double(binw), ctypes.c_long(fmin), ctypes.c_long(n_bins),
        ctypes.c_double(leak_bins), ctypes.c_double(margin_db),
        ctypes.c_double(attack_skip_s), ctypes.c_long(min_frames),
        _ptr(keep, ctypes.c_uint8))
    return keep[: len(events)].astype(bool)


def poly_drop_straight_native(h: EnvHandle, events, fmin, n_bins,
                              track_max_db, intervals, resid_thr, curv_thr,
                              rel_factor, attack_skip_s, min_frames,
                              sal_guard, line_harmonics, line_tol_semis,
                              beat_scan, beat_floor_db):
    """Keep mask mirroring core/poly.py::drop_straight_harmonic_ghosts.
    ``sal_guard=None`` and ``line_harmonics=None`` follow the Python
    signature (None disables the guard / selects interval mode)."""
    note, start, end, sal = _event_arrays(events)
    rescued = _soa(events, "rescued_root", np.uint8, False)
    iv = np.asarray(sorted(intervals), np.int64)
    lh = (np.asarray(line_harmonics, np.int64)
          if line_harmonics is not None else np.empty(0, np.int64))
    keep = np.zeros(max(len(events), 1), np.uint8)
    h._lib.aegis_poly_drop_straight(
        ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
        _ptr(rescued, ctypes.c_uint8),
        ctypes.c_long(fmin), ctypes.c_long(n_bins),
        ctypes.c_double(track_max_db),
        _ptr(iv, ctypes.c_long), ctypes.c_long(len(iv)),
        ctypes.c_double(resid_thr), ctypes.c_double(curv_thr),
        ctypes.c_double(rel_factor), ctypes.c_double(attack_skip_s),
        ctypes.c_long(min_frames),
        ctypes.c_double(-1.0 if sal_guard is None else sal_guard),
        _ptr(lh, ctypes.c_long), ctypes.c_long(len(lh)),
        ctypes.c_double(line_tol_semis), ctypes.c_long(int(beat_scan)),
        ctypes.c_double(beat_floor_db), _ptr(keep, ctypes.c_uint8))
    return keep[: len(events)].astype(bool)


def poly_snap_starts_native(events_sorted, onsets, rms_db, back_frames):
    """New starts for (note, start)-sorted events, mirroring
    core/poly.py::snap_starts_poly's sorted-onsets path (dtype-faithful
    diff/argmax).  Returns an int64 array aligned with events_sorted."""
    lib = get_lib()
    note, start, end, _ = _event_arrays(events_sorted)
    ons = np.ascontiguousarray(onsets, np.int64)
    rms = np.ascontiguousarray(rms_db)
    is_f32 = rms.dtype == np.float32
    if not is_f32:
        rms = np.ascontiguousarray(rms_db, np.float64)
    out = np.empty(max(len(events_sorted), 1), np.int64)
    lib.aegis_poly_snap_starts(
        ctypes.c_long(len(events_sorted)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long),
        _ptr(ons, ctypes.c_long), ctypes.c_long(len(ons)),
        rms.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(rms)),
        ctypes.c_long(int(is_f32)), ctypes.c_long(back_frames),
        _ptr(out, ctypes.c_long))
    return out[: len(events_sorted)]


def poly_decay_prune_native(events, onsets_sorted, frac, total_frames,
                            concurrent_tol):
    """Keep mask mirroring core/poly.py::decay_prune."""
    lib = get_lib()
    _, start, end, _ = _event_arrays(events)
    order = np.argsort(start, kind="stable").astype(np.int64)
    sorted_starts = start[order].copy()
    ons = np.ascontiguousarray(onsets_sorted, np.int64)
    keep = np.zeros(max(len(events), 1), np.uint8)
    lib.aegis_poly_decay_prune(
        ctypes.c_long(len(events)),
        _ptr(start, ctypes.c_long), _ptr(end, ctypes.c_long),
        _ptr(order, ctypes.c_long), _ptr(sorted_starts, ctypes.c_long),
        _ptr(ons, ctypes.c_long), ctypes.c_long(len(ons)),
        ctypes.c_double(frac),
        ctypes.c_long(-1 if total_frames is None else total_frames),
        ctypes.c_long(concurrent_tol), _ptr(keep, ctypes.c_uint8))
    return keep[: len(events)].astype(bool)


def poly_drop_composite_native(events, line_harmonics, sal_guard,
                               line_tol_semis):
    """Keep mask mirroring core/poly.py::drop_composite_harmonic_ghosts."""
    lib = get_lib()
    note, start, end, sal = _event_arrays(events)
    lh = np.asarray(line_harmonics, np.int64)
    keep = np.zeros(max(len(events), 1), np.uint8)
    lib.aegis_poly_drop_composite(
        ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
        _ptr(lh, ctypes.c_long), ctypes.c_long(len(lh)),
        ctypes.c_double(sal_guard), ctypes.c_double(line_tol_semis),
        _ptr(keep, ctypes.c_uint8))
    return keep[: len(events)].astype(bool)


def poly_attach_salience_native(events, salience_T):
    """Per-event mean salience mirroring core/poly.py::attach_salience
    (float32 pairwise sum, bit-identical to seg.mean()).  salience_T is the
    transposed-contiguous float32 plane (notes, T)."""
    lib = get_lib()
    note, start, end, _ = _event_arrays(events)
    out = np.empty(max(len(events), 1), np.float64)
    lib.aegis_poly_attach_salience(
        ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long),
        _ptr(salience_T, ctypes.c_float),
        ctypes.c_long(salience_T.shape[1]),
        ctypes.c_long(salience_T.shape[0]),
        _ptr(out, ctypes.c_double))
    return out[: len(events)]


def poly_harmonic_dedup_native(events, sal_ratio, start_tol):
    """Keep mask mirroring core/poly.py::harmonic_dedup."""
    lib = get_lib()
    note, start, end, sal = _event_arrays(events)
    rescued = _soa(events, "rescued_root", np.uint8, False)
    keep = np.zeros(max(len(events), 1), np.uint8)
    lib.aegis_poly_harmonic_dedup(
        ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
        _ptr(rescued, ctypes.c_uint8),
        ctypes.c_double(sal_ratio), ctypes.c_long(start_tol),
        _ptr(keep, ctypes.c_uint8))
    return keep[: len(events)].astype(bool)


def poly_repitch_native(h: EnvHandle, events, binw, fmin, n_bins,
                        track_max_db, margin_db, abs_floor_db,
                        attack_skip_s, min_frames, leak_bins,
                        leak_margin_db):
    """Action codes (0 keep, 1 drop, 2 re-pitch +12) mirroring
    core/poly.py::repitch_suboctave_ghosts."""
    note, start, end, _ = _event_arrays(events)
    rescued = _soa(events, "rescued_root", np.uint8, False)
    action = np.zeros(max(len(events), 1), np.uint8)
    h._lib.aegis_poly_repitch(
        ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
        _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
        _ptr(end, ctypes.c_long), _ptr(rescued, ctypes.c_uint8),
        ctypes.c_double(binw), ctypes.c_long(fmin), ctypes.c_long(n_bins),
        ctypes.c_double(track_max_db), ctypes.c_double(margin_db),
        ctypes.c_double(abs_floor_db), ctypes.c_double(attack_skip_s),
        ctypes.c_long(min_frames), ctypes.c_double(leak_bins),
        ctypes.c_double(leak_margin_db), _ptr(action, ctypes.c_uint8))
    return action[: len(events)]


def poly_recover_fifths_native(h: EnvHandle, events, fmin, n_bins,
                               track_max_db, level_floor_db, rel_parent_db,
                               max_resid, attack_skip_s, min_frames):
    """Mint list [(parent_index, salience)] mirroring
    core/poly.py::recover_missing_fifths (appended-tail walk included)."""
    note, start, end, sal = _event_arrays(events)
    cap = max(64, len(events))
    while True:
        out_parent = np.empty(cap, np.int64)
        out_sal = np.empty(cap, np.float64)
        m = h._lib.aegis_poly_recover_fifths(
            ctypes.c_void_p(h._h), ctypes.c_long(len(events)),
            _ptr(note, ctypes.c_long), _ptr(start, ctypes.c_long),
            _ptr(end, ctypes.c_long), _ptr(sal, ctypes.c_double),
            ctypes.c_long(fmin), ctypes.c_long(n_bins),
            ctypes.c_double(track_max_db), ctypes.c_double(level_floor_db),
            ctypes.c_double(rel_parent_db), ctypes.c_double(max_resid),
            ctypes.c_double(attack_skip_s), ctypes.c_long(min_frames),
            ctypes.c_long(cap),
            _ptr(out_parent, ctypes.c_long), _ptr(out_sal, ctypes.c_double))
        if m < 0:
            cap = -m + 16
            continue
        return [(int(out_parent[i]), float(out_sal[i])) for i in range(m)]


def poly_roll_runs_native(roll_u8, conf_f32, min_frames, gap_frames):
    """(starts, ends, notes, conf_maxes) run arrays mirroring
    core/poly.py::roll_to_events's note-major scan (gap merge + min-duration
    + full-span confidence max)."""
    lib = get_lib()
    T, n_notes = roll_u8.shape
    cap = max(64, T // max(min_frames, 1) + 8)
    while True:
        out_s = np.empty(cap, np.int64)
        out_e = np.empty(cap, np.int64)
        out_n = np.empty(cap, np.int64)
        out_c = np.empty(cap, np.float64)
        m = lib.aegis_poly_roll_runs(
            _ptr(roll_u8, ctypes.c_uint8), _ptr(conf_f32, ctypes.c_float),
            ctypes.c_long(T), ctypes.c_long(n_notes),
            ctypes.c_long(min_frames), ctypes.c_long(gap_frames),
            ctypes.c_long(cap),
            _ptr(out_s, ctypes.c_long), _ptr(out_e, ctypes.c_long),
            _ptr(out_n, ctypes.c_long), _ptr(out_c, ctypes.c_double))
        if m < 0:
            cap = -m + 16
            continue
        return out_s[:m], out_e[:m], out_n[:m], out_c[:m]


# --------------------------------------------------------------------------
# trend-filter recurrences (trend_core.cpp) — the strictly sequential loops
# of the financial noise-filter stack.  core/trend_fast.py routes through
# these (bit-identical to ref/trend_ref.py's Python loops; pinned
# buffer-for-buffer by tests/test_torch_realtime_copies.py); reductions and
# elementwise steps stay in numpy on the caller side.

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
