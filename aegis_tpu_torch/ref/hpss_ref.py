"""NumPy oracle for core/hpss.py (exact-semantics mirror, parity-tested);
a copy of ``aegis_tpu/ref/hpss_ref.py``.

Same algorithm expressed with np.fft + scipy-free median filtering: centered
Hann STFT, time/frequency median filters with edge padding, soft Wiener
masks with power 2, window-sum-square-normalized inverse STFT.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from aegis_tpu_torch.core.filters import hann_window


def _frames(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    y_p = np.pad(y, pad)
    T = 1 + len(y) // hop
    need = (T - 1) * hop + n_fft
    if len(y_p) < need:
        y_p = np.pad(y_p, (0, need - len(y_p)))
    idx = np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]
    return y_p[idx]


def _median_along(x: np.ndarray, size: int, axis: int) -> np.ndarray:
    half = size // 2
    pads = [(0, 0), (0, 0)]
    pads[axis] = (half, half)
    xp = np.pad(x, pads, mode="edge")
    n = x.shape[axis]
    stack = [np.take(xp, np.arange(j, j + n), axis=axis) for j in range(size)]
    return np.median(np.stack(stack, axis=-1), axis=-1)


def hpss_ref(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
             kernel_time: int = 17, kernel_freq: int = 17,
             power: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    y = np.asarray(y, np.float32)
    n = len(y)
    win = hann_window(n_fft).astype(np.float64)
    fw = _frames(y, n_fft, hop_length).astype(np.float64) * win[None, :]
    Z = np.fft.rfft(fw, axis=1)  # (T, F)
    S = np.abs(Z)

    H = _median_along(S, kernel_time, axis=0)
    P = _median_along(S, kernel_freq, axis=1)
    Hp = H ** power
    Pp = P ** power
    denom = Hp + Pp + 1e-10
    mh = Hp / denom
    mp = Pp / denom

    def inv(Zm: np.ndarray) -> np.ndarray:
        frames = np.fft.irfft(Zm, n=n_fft, axis=1) * win[None, :]
        T = frames.shape[0]
        out_len = T * hop_length + n_fft
        out = np.zeros(out_len)
        wss = np.zeros(out_len)
        w2 = win * win
        for t in range(T):
            out[t * hop_length: t * hop_length + n_fft] += frames[t]
            wss[t * hop_length: t * hop_length + n_fft] += w2
        out /= np.maximum(wss, 1e-8)
        pad = n_fft // 2
        return out[pad: pad + n].astype(np.float32)

    return inv(Z * mh), inv(Z * mp)
