"""NumPy reference implementation of pYIN probabilistic pitch tracking.

The CPU oracle of the port's pYIN (a copy of ``aegis_tpu/ref/pyin_ref.py``;
the decode's constant tables come from ``beta_threshold_probs`` and
``local_transition``, and ``tools/validate_device.py`` scores the card
against ``pyin`` through ``ref/pipeline_ref.py``).  It implements the published
pYIN algorithm (Mauch & Dixon, "pYIN: A fundamental frequency estimator using
probabilistic threshold distributions", ICASSP 2014) with the same parameter
defaults the reference engine passes to librosa.pyin (reference:
aegis_engine_core/worker.py:9-15 — fmin=E2, fmax=C6, hop=512).

Pipeline:
  1. centered zero-padded frames (frame_length=2048)
  2. YIN difference function via FFT autocorrelation + cumulative energies
  3. cumulative-mean-normalized difference (CMNDF) over candidate lags
  4. trough detection + parabolic interpolation
  5. probabilistic thresholding: Beta(2, 18) prior over 100 thresholds,
     Boltzmann weighting over trough ranks, no-trough mass to global min
  6. observation matrix over 0.1-semitone pitch bins
  7. Viterbi over (voiced, unvoiced) x pitch-bin states with a banded
     triangular pitch transition and voicing switch probability

Everything is expressed with *fixed-shape* arrays (masks over the full lag
axis instead of ragged trough lists) so the device implementation in
``core/pyin.py`` is line-for-line the same math.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import special as _special

from aegis_tpu_torch.config import PyinConfig


# --------------------------------------------------------------------------
# Stage helpers (shared math, mirrored by the JAX implementation)
# --------------------------------------------------------------------------

def cmndf_frames(
    frames: np.ndarray, win_length: int, min_period: int, max_period: int
) -> np.ndarray:
    """Cumulative-mean-normalized difference function for each frame.

    Parameters
    ----------
    frames : (T, frame_length) float array
    Returns
    -------
    (T, L) with L = max_period - min_period + 1, lags min_period..max_period.
    """
    frames = frames.astype(np.float64)
    T, frame_length = frames.shape
    n_fft = 2 * frame_length

    # autocorrelation term c(tau) = sum_j x_j x_{j+tau}, j in [0, win_length)
    head = np.zeros_like(frames)
    head[:, :win_length] = frames[:, :win_length]
    F = np.fft.rfft(frames, n_fft, axis=-1)
    G = np.fft.rfft(head, n_fft, axis=-1)
    corr = np.fft.irfft(F * np.conj(G), n_fft, axis=-1)[:, : max_period + 1]

    # energy terms
    sq = frames**2
    cum = np.concatenate(
        [np.zeros((T, 1)), np.cumsum(sq, axis=-1)], axis=-1
    )  # cum[:, k] = sum of first k squares
    taus = np.arange(max_period + 1)
    e_tau = cum[:, taus + win_length] - cum[:, taus]  # energy of x[tau:tau+W]
    e0 = e_tau[:, :1]

    diff = e0 + e_tau - 2.0 * corr  # d(tau), tau = 0..max_period
    diff = np.maximum(diff, 0.0)

    # cumulative mean normalization: d'(tau) = d(tau) * tau / sum_{j<=tau} d(j)
    tau_range = np.arange(1, max_period + 1)
    cumulative = np.cumsum(diff[:, 1:], axis=-1)
    tiny = np.finfo(np.float64).tiny
    cmndf = diff[:, 1:] * tau_range[None, :] / np.maximum(cumulative, tiny)
    # prepend tau=0 (defined as 1)
    cmndf = np.concatenate([np.ones((T, 1)), cmndf], axis=-1)
    return cmndf[:, min_period : max_period + 1]


def parabolic_shifts(yin: np.ndarray) -> np.ndarray:
    """Per-lag parabolic interpolation shift of local minima (zero at edges).
    yin: (T, L) -> shifts (T, L) in fractional lag units, clipped to [-0.5, 0.5]."""
    T, L = yin.shape
    shifts = np.zeros_like(yin)
    if L < 3:
        return shifts
    a = yin[:, :-2]
    b = yin[:, 1:-1]
    c = yin[:, 2:]
    denom = a - 2.0 * b + c
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(np.abs(denom) > 0, (a - c) / (2.0 * denom), 0.0)
    shifts[:, 1:-1] = np.clip(np.nan_to_num(s), -0.5, 0.5)
    return shifts


def trough_mask(yin: np.ndarray) -> np.ndarray:
    """Local minima mask over the lag axis (T, L).  First lag counts as a
    trough when it is below its right neighbor (matching the boundary rule of
    the published algorithm)."""
    T, L = yin.shape
    mask = np.zeros(yin.shape, dtype=bool)
    if L < 2:
        return mask
    mask[:, 1:-1] = (yin[:, 1:-1] < yin[:, :-2]) & (yin[:, 1:-1] <= yin[:, 2:])
    mask[:, 0] = yin[:, 0] < yin[:, 1]
    return mask


def beta_threshold_probs(cfg: PyinConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(thresholds[1:], beta interval probabilities), each length n_thresholds."""
    thresholds = np.linspace(0.0, 1.0, cfg.n_thresholds + 1)
    beta_cdf = _special.betainc(cfg.beta_a, cfg.beta_b, thresholds)
    return thresholds[1:], np.diff(beta_cdf)


def trough_probabilities(
    yin: np.ndarray, mask: np.ndarray, cfg: PyinConfig
) -> np.ndarray:
    """Per-lag trough probability (T, L): Beta-weighted Boltzmann ranking.

    For each threshold s_i with prior beta_i, troughs with height < s_i get a
    Boltzmann weight exp(-lam*rank) normalized over the count below s_i; if no
    trough is below s_i, mass beta_i * no_trough_prob goes to the global
    minimum trough.
    """
    T, L = yin.shape
    thresholds, beta_probs = beta_threshold_probs(cfg)
    lam = cfg.boltzmann_parameter

    heights = np.where(mask, yin, np.inf)
    any_trough = mask.any(axis=1)
    global_min = np.argmin(heights, axis=1)  # (T,)

    probs = np.zeros((T, L))
    one_m = -np.expm1(-lam)  # 1 - exp(-lam)
    for thr, beta_p in zip(thresholds, beta_probs):
        below = mask & (yin < thr)  # (T, L)
        n_below = below.sum(axis=1)  # (T,)
        rank = np.cumsum(below, axis=1) - 1  # rank among below-troughs
        denom = -np.expm1(-lam * np.maximum(n_below, 1))  # 1 - exp(-lam*N)
        pmf = np.exp(-lam * rank) * one_m / denom[:, None]
        probs += np.where(below, beta_p * pmf, 0.0)
        # thresholds with no troughs below: mass to global minimum
        no_trough = (~below.any(axis=1)) & any_trough
        probs[np.arange(T), global_min] += np.where(
            no_trough, beta_p * cfg.no_trough_prob, 0.0
        )
    return probs


def observations(
    probs: np.ndarray,
    shifts: np.ndarray,
    sr: int,
    min_period: int,
    cfg: PyinConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate trough probabilities into pitch-bin observations.

    Returns (obs (T, n_pitch_bins), voiced_prob (T,)).
    """
    T, L = probs.shape
    n_bins = cfg.n_pitch_bins
    nbps = cfg.n_bins_per_semitone

    periods = min_period + np.arange(L)[None, :] + shifts  # (T, L)
    freqs = sr / np.maximum(periods, 1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        bins = np.round(12 * nbps * np.log2(np.maximum(freqs, 1e-6) / cfg.fmin))
    bins = np.clip(bins, 0, n_bins - 1).astype(np.int64)

    obs = np.zeros((T, n_bins))
    np.add.at(obs, (np.repeat(np.arange(T), L), bins.ravel()), probs.ravel())
    voiced_prob = np.clip(obs.sum(axis=1), 0.0, 1.0)
    return obs, voiced_prob


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


def viterbi_decode(
    obs: np.ndarray,
    voiced_prob: np.ndarray,
    trans_local: np.ndarray,
    switch_prob: float,
) -> np.ndarray:
    """Max-product decoding over 2*n_bins states ([0,n)=voiced, [n,2n)=unvoiced).

    Returns the state sequence (T,).
    """
    T, n = obs.shape
    eps = 1e-30
    log_obs_v = np.log(obs + eps)
    log_obs_u = np.log((1.0 - voiced_prob[:, None]) / n + eps)

    log_local = np.log(trans_local + eps)  # (n, n)
    log_stay = np.log1p(-switch_prob)
    log_switch = np.log(switch_prob)

    delta_v = np.full(n, np.log(1.0 / (2 * n))) + log_obs_v[0]
    delta_u = np.full(n, np.log(1.0 / (2 * n))) + log_obs_u[0]
    psi_v = np.zeros((T, n), dtype=np.int32)
    psi_u = np.zeros((T, n), dtype=np.int32)

    for t in range(1, T):
        # max-plus through the banded pitch transition, per source voicing
        scores_v = delta_v[:, None] + log_local  # (i, j)
        scores_u = delta_u[:, None] + log_local
        best_v = scores_v.argmax(axis=0)
        best_u = scores_u.argmax(axis=0)
        m_v = scores_v[best_v, np.arange(n)]  # best over voiced sources
        m_u = scores_u[best_u, np.arange(n)]

        # voiced target: stay voiced vs switch from unvoiced
        stay = m_v + log_stay
        switch = m_u + log_switch
        take_stay = stay >= switch
        delta_v_new = np.where(take_stay, stay, switch) + log_obs_v[t]
        psi_v[t] = np.where(take_stay, best_v, best_u + n)

        # unvoiced target: switch from voiced vs stay unvoiced
        sw = m_v + log_switch
        st = m_u + log_stay
        take_sw = sw >= st
        delta_u_new = np.where(take_sw, sw, st) + log_obs_u[t]
        psi_u[t] = np.where(take_sw, best_v, best_u + n)

        delta_v, delta_u = delta_v_new, delta_u_new

    states = np.zeros(T, dtype=np.int64)
    full_delta = np.concatenate([delta_v, delta_u])
    states[-1] = int(np.argmax(full_delta))
    for t in range(T - 1, 0, -1):
        s = states[t]
        states[t - 1] = psi_v[t, s] if s < n else psi_u[t, s - n]
    return states


# --------------------------------------------------------------------------
# Public entry point
# --------------------------------------------------------------------------

def pyin(
    y: np.ndarray,
    sr: int,
    hop_length: int = 512,
    cfg: PyinConfig | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Probabilistic YIN pitch tracking.

    Returns (f0, voiced_flag, voiced_prob) per frame; f0 is NaN on unvoiced
    frames (matching librosa.pyin's fill_na=np.nan contract that the reference
    relies on at midi_logic_financial.py:157-158).
    """
    if cfg is None:
        cfg = PyinConfig()
    min_p, max_p = cfg.min_period(sr), cfg.max_period(sr)

    pad = cfg.frame_length // 2
    y_p = np.pad(np.asarray(y, dtype=np.float64), pad, mode="constant")
    n_frames = 1 + len(y) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length
        + np.arange(cfg.frame_length)[None, :]
    )
    frames = y_p[idx]

    yin = cmndf_frames(frames, cfg.win_length, min_p, max_p)
    shifts = parabolic_shifts(yin)
    mask = trough_mask(yin)
    probs = trough_probabilities(yin, mask, cfg)
    obs, voiced_prob = observations(probs, shifts, sr, min_p, cfg)

    trans = local_transition(cfg.n_pitch_bins, cfg.transition_width(sr, hop_length))
    states = viterbi_decode(obs, voiced_prob, trans, cfg.switch_prob)

    n = cfg.n_pitch_bins
    bin_idx = states % n
    voiced_flag = states < n
    freqs = cfg.fmin * 2.0 ** (bin_idx / (12.0 * cfg.n_bins_per_semitone))
    f0 = np.where(voiced_flag, freqs, np.nan)
    return f0.astype(np.float64), voiced_flag, voiced_prob.astype(np.float64)
