"""Constant tables of the v1 analyze path, built once per (config, device).

Every table comes from the same NumPy builder the JAX package calls
(``aegis_tpu/core/filters.py`` and ``aegis_tpu/ref/pyin_ref.py``) in
float32, so both packages compute from bit-identical constants.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core.filters import dft_matrices, hann_window, mel_filterbank
from aegis_tpu.ref.pyin_ref import beta_threshold_probs, local_transition

# log(0 + 1e-30): the dense decode's out-of-band transition score
# (aegis_tpu/core/pyin.py applies log(trans + 1e-30) to the whole matrix)
LOG_FLOOR = np.float32(np.log(1e-30))


@dataclasses.dataclass(frozen=True)
class Tables:
    window: torch.Tensor       # (n_fft,) periodic Hann
    dft_cos: torch.Tensor      # (n_fft, 1 + n_fft//2)
    dft_sin: torch.Tensor      # (n_fft, 1 + n_fft//2)
    mel_fb_t: torch.Tensor     # (1 + n_fft//2, n_mels)
    thresholds: torch.Tensor   # (n_thresholds,)
    beta_probs: torch.Tensor   # (n_thresholds,)
    band: torch.Tensor         # (n_bins, 2w+1), see log_transition_band
    half_width: int            # w
    bin_hz: torch.Tensor       # (n_bins,) pitch of each bin, see bin_frequencies


def log_transition_band(n: int, w: int) -> np.ndarray:
    """(n, 2w+1) float32: band[j, k] = log(trans[i, j] + 1e-30) for the
    source state i = j - w + k of destination state j, where trans is
    ``local_transition(n, w)``.  Entries whose source lies outside [0, n)
    hold LOG_FLOOR and are never read by the decode."""
    log_t = np.log(local_transition(n, w) + 1e-30).astype(np.float32)
    band = np.full((n, 2 * w + 1), LOG_FLOOR, np.float32)
    j = np.arange(n)[:, None]
    i = j - w + np.arange(2 * w + 1)[None, :]
    ok = (i >= 0) & (i < n)
    band[ok] = log_t[i[ok], np.broadcast_to(j, i.shape)[ok]]
    return band


def bin_frequencies(cfg: PyinConfig) -> torch.Tensor:
    """(n_bins,) float32 Hz of each pitch bin, fmin * 2^(b / (12 * nbps)).

    Built once on the host so every device decodes a bin to the same f0.
    XLA evaluates the JAX package's division by 12 * nbps as a product with
    the float32 reciprocal; computing it the same way keeps every bin that
    sits exactly on a half semitone on the same side of the note rounding in
    extract_events as the JAX package (a true division moves five such bins
    across it)."""
    b = torch.arange(cfg.n_pitch_bins, dtype=torch.float32)
    return cfg.fmin * 2.0 ** (b * (1.0 / (12.0 * cfg.n_bins_per_semitone)))


@functools.lru_cache(maxsize=8)
def tables_from_numpy(audio: AudioConfig, pyin_cfg: PyinConfig,
                      device: torch.device) -> Tables:
    """All constant tables for one (AudioConfig, PyinConfig, device)."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    cos_m, sin_m = dft_matrices(audio.n_fft)
    thresholds, beta = beta_threshold_probs(pyin_cfg)
    w = pyin_cfg.transition_width(audio.sample_rate, audio.hop_length)
    return Tables(
        window=dev(hann_window(audio.n_fft)),
        dft_cos=dev(cos_m),
        dft_sin=dev(sin_m),
        mel_fb_t=dev(mel_filterbank(audio.sample_rate, audio.n_fft,
                                    audio.n_mels).T),
        thresholds=dev(thresholds),
        beta_probs=dev(beta),
        band=dev(log_transition_band(pyin_cfg.n_pitch_bins, w)),
        half_width=w,
        bin_hz=bin_frequencies(pyin_cfg).to(device),
    )
