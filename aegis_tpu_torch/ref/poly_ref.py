"""NumPy oracle for the polyphonic salience-peeling device core.

Mirrors aegis_tpu_torch/core/poly.py's device functions (peel_voices,
roll_and_confidence) with plain NumPy in float32: a copy of
``aegis_tpu/ref/poly_ref.py`` that takes the comb matrices and
COMB_NORM_FLOOR from this package's core/poly.py.  It is the host's unpack
path (core.poly.unpack_poly_voices rebuilds the roll / confidence /
salience planes through roll_and_confidence_ref), not only a test oracle.
Unlike pyin_ref / trend_ref it mirrors this project's own spec, not
librosa's; its ground-truth anchor is the generator-truth F1 gate on the
chord progressions of tools/signal_gen.py.

Keep in lockstep with core/poly.py when changing semantics.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from aegis_tpu_torch.core.cqt import CQT_FMIN_MIDI
from aegis_tpu_torch.core import poly as _poly
from aegis_tpu_torch.core.poly import (MIDI_BINS,
                                       harmonic_subtraction_matrix,
                                       harmonic_suppression_matrix)

__all__ = ["peel_voices_ref", "roll_and_confidence_ref",
           "harmonic_suppression_matrix", "harmonic_subtraction_matrix"]


def peel_voices_ref(cqt_power: np.ndarray, supp: np.ndarray,
                    sub: np.ndarray | None = None,
                    max_voices: int = 6,
                    over_subtract: float = 1.33,
                    alpha: float = 0.6,
                    gamma19: float = 0.5,
                    gamma12: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy twin of core.poly.peel_voices (same argument semantics)."""
    cqt_power = np.asarray(cqt_power, np.float32)
    supp = np.asarray(supp, np.float32)
    if sub is None:
        sub = harmonic_subtraction_matrix(cqt_power.shape[1])
    sub = np.asarray(sub, np.float32)
    T, n_bins = cqt_power.shape
    mag = np.sqrt(np.maximum(cqt_power, 0.0))
    # floored comb normalization, in lockstep with core/poly.py::
    # peel_voices: out-of-range harmonics count as zero support below the
    # floor (kills the 44.1 kHz high-bin ghost inflation; see the device
    # kernel's comment)
    row = supp.sum(axis=1)
    rowsum = np.maximum(
        np.maximum(row, np.float32(_poly.COMB_NORM_FLOOR) * row.max()),
        np.float32(1e-10))
    rows = np.arange(T)
    bins_out: List[np.ndarray] = []
    sal_out: List[np.ndarray] = []
    for _ in range(max_voices):
        combavg = (mag @ supp.T) / rowsum[None, :]
        sal_map = (np.maximum(mag, 0.0) ** np.float32(alpha)
                   * np.maximum(combavg, 0.0) ** np.float32(1.0 - alpha))
        peak = np.argmax(sal_map, axis=1).astype(np.int32)
        for off, gamma in ((19, gamma19), (12, gamma12)):
            cand = np.clip(peak - off, 0, n_bins - 1)
            take = (peak >= off) & (sal_map[rows, cand]
                                    >= np.float32(gamma)
                                    * sal_map[rows, peak])
            peak = np.where(take, cand, peak).astype(np.int32)
        sal = sal_map[rows, peak]
        bins_out.append(peak)
        sal_out.append(sal.astype(np.float32))
        comb = sub[peak]  # (T, n_bins) gather = the device's one-hot matmul
        mag = mag * (1.0 - np.clip(np.float32(over_subtract) * comb,
                                   0.0, 1.0))
    return np.stack(bins_out, axis=1), np.stack(sal_out, axis=1)


def roll_and_confidence_ref(bins: np.ndarray, sals: np.ndarray,
                            bins_per_octave: int = 12,
                            rel_threshold: float = 0.12,
                            abs_threshold: float = 0.02,
                            global_peak: float | None = None,
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy twin of core.poly.roll_and_confidence."""
    bins = np.asarray(bins)
    sals = np.asarray(sals, np.float32)
    T, V = bins.shape
    lead = np.maximum(sals.max(axis=1, keepdims=True), np.float32(1e-10))
    if global_peak is None:
        global_peak = float(sals.max())
    keep = (sals >= np.float32(rel_threshold) * lead) & (
        sals >= np.float32(abs_threshold)
        * np.float32(max(global_peak, 1e-10)))
    midi = np.clip(np.round(CQT_FMIN_MIDI
                            + 12.0 * bins.astype(np.float32)
                            / bins_per_octave).astype(np.int32),
                   0, MIDI_BINS - 1)
    roll = np.zeros((T, MIDI_BINS), bool)
    conf = np.zeros((T, MIDI_BINS), np.float32)
    salience = np.zeros((T, MIDI_BINS), np.float32)
    rows = np.arange(T)
    for v in range(V):
        m = midi[:, v]
        roll[rows, m] |= keep[:, v]
        conf[rows, m] = np.maximum(conf[rows, m], sals[:, v] / lead[:, 0])
        salience[rows, m] = np.maximum(salience[rows, m],
                                       np.maximum(sals[:, v], 0.0))
    return roll, conf, salience
