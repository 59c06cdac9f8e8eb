"""NumPy dB scaling and pitch conversion, the part of
``aegis_tpu/ref/dsp_ref.py`` that the event extraction uses.

power_to_db follows librosa's contract: ref=max and top_db=80.
"""

from __future__ import annotations

import numpy as np


def power_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(max(amin, abs(ref)))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.astype(np.float32)


def amplitude_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-5,
                    top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    return power_to_db(S**2, ref=ref**2, amin=amin**2, top_db=top_db)


def hz_to_midi(hz):
    return 12.0 * np.log2(np.asanyarray(hz) / 440.0) + 69.0
