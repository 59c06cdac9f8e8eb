"""The two NumPy functions of the pYIN oracle
(``aegis_tpu/ref/pyin_ref.py``) that the decode's constant tables come from:
the Beta(2, 18) threshold prior and the banded triangular pitch transition.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import special as _special

from aegis_tpu_torch.config import PyinConfig


def beta_threshold_probs(cfg: PyinConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(thresholds[1:], beta interval probabilities), each length n_thresholds."""
    thresholds = np.linspace(0.0, 1.0, cfg.n_thresholds + 1)
    beta_cdf = _special.betainc(cfg.beta_a, cfg.beta_b, thresholds)
    return thresholds[1:], np.diff(beta_cdf)


def local_transition(n_bins: int, half_width: int) -> np.ndarray:
    """Banded triangular pitch-transition matrix (n_bins, n_bins), rows
    normalized."""
    offs = np.arange(-half_width, half_width + 1)
    tri = (half_width + 1 - np.abs(offs)).astype(np.float64)
    trans = np.zeros((n_bins, n_bins))
    idx = np.arange(n_bins)
    for o, w in zip(offs, tri):
        j = idx + o
        valid = (j >= 0) & (j < n_bins)
        trans[idx[valid], j[valid]] = w
    trans /= trans.sum(axis=1, keepdims=True)
    return trans
