"""Test signals for the port.

The gating clips are re-exported from ``aegis_tpu/tools/signal_gen.py``
(pure NumPy/SciPy), so the port's checks name only this package;
``wandering_pitch_obs`` makes the synthetic Viterbi observations.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from aegis_tpu.tools.signal_gen import (  # noqa: F401
    generate_bench_track,
    generate_scale_benchmark,
    generate_test_track,
)


def wandering_pitch_obs(T: int, n_bins: int, seed: int, center: int,
                        step: int, spread: Sequence[int], jumps: bool
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse pYIN observations (T, n_bins) and voiced probabilities (T,):
    trough mass on ``spread`` bins around a pitch that wanders by up to
    ``step`` bins a frame, plus, with ``jumps``, a strong far bin every 13
    frames that exercises the out-of-band transitions.  The observations
    of tests/test_pyin_parity.py, extended to any T."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((T, n_bins), np.float32)
    for t in range(T):
        center = int(np.clip(center + rng.integers(-step, step + 1),
                             5, n_bins - 6))
        for d in spread:
            obs[t, center + d] = rng.random() * (0.4 if jumps else 0.5)
        if jumps and t % 13 == 7:
            obs[t, (center + 230) % n_bins] = 0.9
    return obs, np.clip(obs.sum(axis=1), 0.0, 1.0).astype(np.float32)
