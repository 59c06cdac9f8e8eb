"""pYIN probabilistic pitch tracking (PyTorch).

Counterpart of ``aegis_tpu/core/pyin.py``, stage for stage: batched-FFT
CMNDF, parabolic shifts, trough mask, the 100-threshold Beta/Boltzmann
trough probabilities, the scatter into 0.1-semitone pitch bins, and the
Viterbi decode — on a CUDA tensor the hand kernels of ``pyin_cuda``, on a
CPU tensor their plain versions.

The entry points take a leading batch of N sequences (one track, or the N
haloed tiles of the tiled program).  Every stage before the decode works
per frame, so it runs over the N*T frames flattened into one row batch;
only the decode sees (N, T, n_bins), as ONE launch of each kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import dsp, pyin_cuda
from aegis_tpu_torch.core.tables import Tables, tables_from_numpy

EPS = 1e-30


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def cmndf_frames(frames: torch.Tensor, win_length: int, min_period: int,
                 max_period: int) -> torch.Tensor:
    """Cumulative-mean-normalized difference function, (T, L)."""
    T, frame_length = frames.shape
    n_fft = 2 * frame_length
    F = torch.fft.rfft(frames, n_fft, dim=-1)
    G = torch.fft.rfft(frames[:, :win_length], n_fft, dim=-1)
    corr = torch.fft.irfft(F * torch.conj(G), n_fft, dim=-1)[:, : max_period + 1]

    zeros = torch.zeros((T, 1), dtype=frames.dtype, device=frames.device)
    cum = torch.cat([zeros, torch.cumsum(frames * frames, dim=-1)], dim=-1)
    taus = torch.arange(max_period + 1, device=frames.device)
    e_tau = cum[:, taus + win_length] - cum[:, taus]
    e0 = e_tau[:, :1]

    diff = torch.clamp_min(e0 + e_tau - 2.0 * corr, 0.0)

    tau_range = torch.arange(1, max_period + 1, dtype=frames.dtype,
                             device=frames.device)
    cumulative = torch.cumsum(diff[:, 1:], dim=-1)
    tiny = float(np.finfo(np.float32).tiny)
    cmndf = diff[:, 1:] * tau_range[None, :] / torch.clamp_min(cumulative, tiny)
    cmndf = torch.cat([torch.ones_like(zeros), cmndf], dim=-1)
    return cmndf[:, min_period: max_period + 1]


def parabolic_shifts(yin: torch.Tensor) -> torch.Tensor:
    T, L = yin.shape
    if L < 3:
        return torch.zeros_like(yin)
    a, b, c = yin[:, :-2], yin[:, 1:-1], yin[:, 2:]
    denom = a - 2.0 * b + c
    s = torch.where(torch.abs(denom) > 0, (a - c) / (2.0 * denom),
                    torch.zeros_like(denom))
    s = torch.clamp(torch.nan_to_num(s), -0.5, 0.5)
    return torch.nn.functional.pad(s, (1, 1))


def trough_mask(yin: torch.Tensor) -> torch.Tensor:
    T, L = yin.shape
    inner = (yin[:, 1:-1] < yin[:, :-2]) & (yin[:, 1:-1] <= yin[:, 2:])
    first = (yin[:, 0] < yin[:, 1])[:, None]
    last = torch.zeros((T, 1), dtype=torch.bool, device=yin.device)
    return torch.cat([first, inner, last], dim=-1)


def trough_probabilities(yin: torch.Tensor, mask: torch.Tensor,
                         cfg: PyinConfig, tables: Tables) -> torch.Tensor:
    """(T, L) Beta-weighted Boltzmann trough probabilities."""
    T, L = yin.shape
    lam = cfg.boltzmann_parameter
    one_m = float(-np.expm1(-lam))

    heights = torch.where(mask, yin, torch.full_like(yin, float("inf")))
    any_trough = mask.any(dim=1)
    gmin_onehot = torch.nn.functional.one_hot(
        torch.argmin(heights, dim=1), L).to(yin.dtype)

    acc = torch.zeros((T, L), dtype=yin.dtype, device=yin.device)
    for i in range(tables.thresholds.shape[0]):
        thr, bp = tables.thresholds[i], tables.beta_probs[i]
        below = mask & (yin < thr)
        n_below = below.sum(dim=1)
        rank = torch.cumsum(below, dim=1) - 1
        denom = -torch.expm1(-lam * torch.clamp_min(n_below, 1).to(yin.dtype))
        pmf = torch.exp(-lam * rank.to(yin.dtype)) * one_m / denom[:, None]
        acc = acc + torch.where(below, bp * pmf, torch.zeros_like(pmf))
        no_trough = (~below.any(dim=1)) & any_trough
        bump = torch.where(no_trough, bp * cfg.no_trough_prob,
                           torch.zeros_like(bp))
        acc = acc + bump[:, None] * gmin_onehot
    return acc


def observations(probs: torch.Tensor, shifts: torch.Tensor, sr: int,
                 min_period: int, cfg: PyinConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter trough probabilities into pitch bins.  (T, n_bins), (T,).

    Deterministic: one scatter per lag, in lag order, so no row sees two
    adds in one call and each bin sums its lags in the same order on every
    run and device (atomics over the whole plane would reorder the float
    sums, and the Viterbi argmax sits right behind them)."""
    T, L = probs.shape
    n_bins = cfg.n_pitch_bins
    nbps = cfg.n_bins_per_semitone

    lags = torch.arange(L, dtype=probs.dtype, device=probs.device)
    periods = min_period + lags[None, :] + shifts
    freqs = sr / torch.clamp_min(periods, 1e-6)
    bins = torch.round(12 * nbps * torch.log2(torch.clamp_min(freqs, 1e-6)
                                               / cfg.fmin))
    bins = torch.clamp(bins, 0, n_bins - 1).to(torch.int64)

    obs = torch.zeros((T, n_bins), dtype=probs.dtype, device=probs.device)
    for lag in range(L):
        obs.scatter_add_(1, bins[:, lag: lag + 1], probs[:, lag: lag + 1])
    voiced_prob = torch.clamp(obs.sum(dim=1), 0.0, 1.0)
    return obs, voiced_prob


def viterbi_decode(obs: torch.Tensor, voiced_prob: torch.Tensor,
                   log_local: torch.Tensor, switch_prob: float) -> torch.Tensor:
    """Plain max-product decode over 2*n states with the dense (n, n) log
    transition: states[t] in [0, 2n).  The signature and every step of
    aegis_tpu/core/pyin.py::viterbi_decode."""
    psi_v, psi_u, delta_last = pyin_cuda.viterbi_fwd_plain(
        *decode_inputs(obs[None], voiced_prob[None]), log_local,
        float(np.log1p(-switch_prob)), float(np.log(switch_prob)))
    return pyin_cuda.viterbi_back_plain(delta_last, psi_v, psi_u)[0]


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def decode_inputs(obs: torch.Tensor, voiced_prob: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode's log observations of N sequences: voiced (N, T, n) from
    obs (N, T, n), and unvoiced (N, T), uniform over the n unvoiced
    states."""
    n = obs.shape[-1]
    log_obs_v = torch.log(obs + EPS)
    log_obs_u = torch.log((1.0 - voiced_prob) / n + EPS)
    return log_obs_v.contiguous(), log_obs_u.contiguous()


def _decode_states(obs: torch.Tensor, voiced_prob: torch.Tensor,
                   tables: Tables, cfg: PyinConfig) -> torch.Tensor:
    """Viterbi decode of N sequences, obs (N, T, n) -> states (N, T): the
    CUDA kernels on a CUDA tensor (one launch each, one CTA a sequence),
    their plain versions on a CPU tensor.  Any width w and length T; a
    shape the kernels cannot take raises."""
    return pyin_cuda.viterbi_decode_cuda(
        *decode_inputs(obs, voiced_prob), tables.band, cfg.n_pitch_bins,
        tables.half_width, float(np.log1p(-cfg.switch_prob)),
        float(np.log(cfg.switch_prob)), tables.band_tab)


def frame_observations(frames: torch.Tensor, sr: int, cfg: PyinConfig,
                       tables: Tables) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stages before the decode: frames (..., frame_length) ->
    observations (..., n_bins) and voiced probabilities (...), every
    frame of every sequence as one row batch."""
    lead = frames.shape[:-1]
    min_p, max_p = cfg.min_period(sr), cfg.max_period(sr)
    yin = cmndf_frames(frames.reshape(-1, frames.shape[-1]).to(torch.float32),
                       cfg.win_length, min_p, max_p)
    shifts = parabolic_shifts(yin)
    mask = trough_mask(yin)
    probs = trough_probabilities(yin, mask, cfg, tables)
    obs, voiced_prob = observations(probs, shifts, sr, min_p, cfg)
    return obs.reshape(lead + obs.shape[-1:]), voiced_prob.reshape(lead)


def pyin_from_frames(frames: torch.Tensor, sr: int, cfg: PyinConfig,
                     tables: Tables
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pYIN core over pre-extracted frames (N, T, frame_length) of N
    sequences.

    Returns (f0, voiced_flag, voiced_prob), each (N, T); f0 is NaN on
    unvoiced frames.
    """
    obs, voiced_prob = frame_observations(frames, sr, cfg, tables)
    states = _decode_states(obs, voiced_prob, tables, cfg)

    n = cfg.n_pitch_bins
    voiced_flag = states < n
    freqs = tables.bin_hz[(states % n).long()]
    f0 = torch.where(voiced_flag, freqs, torch.full_like(freqs, float("nan")))
    return f0, voiced_flag, voiced_prob


def extract_pyin_frames(y: torch.Tensor, hop_length: int,
                        cfg: PyinConfig) -> torch.Tensor:
    """Centered zero-padded frames for pYIN, (T, frame_length)."""
    return dsp.frame_signal(y, cfg.frame_length, hop_length, "constant")


def pyin(y, sr: int, hop_length: int = 512, cfg: PyinConfig | None = None,
         device="cuda"):
    """Full pYIN from a 1-D signal (host convenience wrapper)."""
    if cfg is None:
        cfg = PyinConfig()
    device = resolve_device(device)
    tables = tables_from_numpy(
        AudioConfig(sample_rate=sr, hop_length=hop_length,
                    n_fft=cfg.frame_length), cfg, device)
    y_t = torch.as_tensor(np.asarray(y, np.float32), device=device)
    frames = extract_pyin_frames(y_t, hop_length, cfg)
    return tuple(a[0] for a in pyin_from_frames(frames[None], sr, cfg, tables))
