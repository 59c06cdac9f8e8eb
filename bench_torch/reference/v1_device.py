"""The device half of the v1 reference: plain PyTorch in float64.

What the v1 configuration states, computed the obvious way: the int8
block-float ingest of the bucket-padded track, the power mel spectrogram
(centered reflect frames, periodic Hann, ``torch.fft.rfft``, the Slaney
filterbank), its dB with ref = max and top_db 80, the rake mask, the
spectral-flux onset envelope, the RMS, and pYIN (Mauch & Dixon 2014: the
YIN difference function by FFT, the cumulative-mean normalization, troughs
with parabolic shifts, the Beta(2, 18) threshold prior with Boltzmann rank
weights, the scatter into pitch bins, and the max-product Viterbi decode
over voiced and unvoiced pitch states with the dense banded transition).
Every table is built here from its formula; nothing comes from the
program.  Rows are cut to the true frame count, as the program returns
them.

``ingest(..., "int4")`` reads the audio through the int4 block-float
transport instead: the poly check's control, the precision below the one
its configuration states.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from scipy import special

F64 = torch.float64


# ------------------------------------------------------------------ ingest

def bucket_length(n: int, min_bucket: int) -> int:
    """The padded length the configuration states: ``min_bucket`` up to it,
    else the next multiple of 2^(bits(n - 1) - 6), at least 2^12."""
    if n <= min_bucket:
        return min_bucket
    g = 1 << max((n - 1).bit_length() - 6, 12)
    return -(-n // g) * g


def block_float(y: torch.Tensor, block: int, levels: int) -> torch.Tensor:
    """Quantize and dequantize through a block-float transport: one float32
    peak scale a block, samples rounded to +-``levels`` (127 for int8, 7
    for int4), in float32 as the transport states; returned as float64."""
    b = y.to(torch.float32).reshape(-1, block)
    peak = b.abs().amax(dim=1)
    q = torch.round(b * (np.float32(levels) / torch.clamp_min(peak[:, None],
                                                               1e-30)))
    scale = (peak / np.float32(levels)).to(torch.float32)
    return (q.to(F64) * scale[:, None].to(F64)).reshape(-1)


def ingest(pcm: np.ndarray, cfg: Dict, device, transport: str) -> torch.Tensor:
    """int16 samples of a take -> the padded float64 track the analysis
    sees: x / 32768 (the WAV decode), zero-padded to its bucket, through
    the block-float transport."""
    ing = cfg["ingest"]
    y = torch.as_tensor(np.asarray(pcm, np.int16).astype(np.float32) / 32768.0,
                        device=device)
    n = bucket_length(y.shape[0], ing["min_bucket"])
    y = torch.nn.functional.pad(y, (0, n - y.shape[0]))
    if transport == "int8":
        return block_float(y, ing["block"], 127)
    if transport == "int4":
        return block_float(y, ing["int4_block"], 7)
    raise ValueError(f"unknown transport {transport!r}")


# --------------------------------------------------------------- spectrum

def frames(y: torch.Tensor, frame_length: int, hop: int,
           reflect: bool) -> torch.Tensor:
    """Centered frames (1 + len // hop, frame_length), the pad frame//2 on
    each side by reflection or by zeros."""
    pad = frame_length // 2
    if reflect:
        yp = torch.nn.functional.pad(y[None, None], (pad, pad),
                                     mode="reflect")[0, 0]
    else:
        yp = torch.nn.functional.pad(y, (pad, pad))
    n = 1 + y.shape[0] // hop
    idx = (torch.arange(n, device=y.device)[:, None] * hop
           + torch.arange(frame_length, device=y.device)[None, :])
    return yp[idx]


def hann(n: int, device) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n, dtype=F64,
                                                            device=device) / n)


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel)
                                                   - min_log_mel)),
                    f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular filters over 0 .. sr/2, (n_mels, bins)."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(np.float64(0.0)),
                                _hz_to_mel(np.float64(sr / 2.0)), n_mels + 2))
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / np.diff(hz)[:-1, None]
    upper = ramps[2:] / np.diff(hz)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def power_to_db(S: torch.Tensor, amin: float = 1e-10,
                top_db: float = 80.0) -> torch.Tensor:
    db = 10.0 * torch.log10(torch.clamp_min(S, amin))
    db = db - 10.0 * torch.log10(torch.clamp_min(S.max(), amin))
    return torch.maximum(db, db.max() - top_db)


def run_length_keep(mask: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Keep the True runs whose length lies in [lo, hi]."""
    out = np.zeros_like(mask)
    padded = np.concatenate([mask, [False]])
    start = -1
    for i, m in enumerate(padded):
        if m and start < 0:
            start = i
        elif not m and start >= 0:
            if lo <= i - start <= hi:
                out[start:i] = True
            start = -1
    return out


def rake_mask(mel_db: np.ndarray, hop: int, sr: int, ratio: float) -> np.ndarray:
    """Broadband columns (more than ``ratio`` of the bands within 20 dB of
    the column's max, that max at least -60 dB) in runs of 10-30 ms."""
    col_max = mel_db.max(axis=1)
    share = (mel_db > col_max[:, None] - 20.0).sum(axis=1) / mel_db.shape[1]
    cand = (share > ratio) & (col_max >= -60.0)
    ms = hop / sr * 1000.0
    return run_length_keep(cand, int(10.0 / ms), int(30.0 / ms))


# -------------------------------------------------------------------- pYIN

def pyin_grid(p: Dict, sr: int, hop: int):
    nbps = int(round(1.0 / p["resolution"]))
    n = int(math.floor(12 * nbps * math.log2(p["fmax"] / p["fmin"]))) + 1
    w = int(round(p["max_transition_rate"] * 12 * nbps * hop / sr)) + 1
    min_p = max(int(math.floor(sr / p["fmax"])), 1)
    max_p = min(int(math.ceil(sr / p["fmin"])),
                p["frame_length"] - p["win_length"] - 1)
    return nbps, n, w, min_p, max_p


def cmndf(fr: torch.Tensor, win: int, min_p: int, max_p: int) -> torch.Tensor:
    """(T, max_p - min_p + 1) cumulative-mean-normalized difference."""
    T, L = fr.shape
    n_fft = 2 * L
    head = torch.zeros_like(fr)
    head[:, :win] = fr[:, :win]
    corr = torch.fft.irfft(torch.fft.rfft(fr, n_fft)
                           * torch.conj(torch.fft.rfft(head, n_fft)),
                           n_fft)[:, :max_p + 1]
    cum = torch.cat([torch.zeros((T, 1), dtype=F64, device=fr.device),
                     torch.cumsum(fr * fr, dim=1)], dim=1)
    taus = torch.arange(max_p + 1, device=fr.device)
    e = cum[:, taus + win] - cum[:, taus]
    d = torch.clamp_min(e[:, :1] + e - 2.0 * corr, 0.0)
    tau = torch.arange(1, max_p + 1, dtype=F64, device=fr.device)
    c = d[:, 1:] * tau / torch.clamp_min(torch.cumsum(d[:, 1:], dim=1),
                                         float(np.finfo(np.float64).tiny))
    c = torch.cat([torch.ones((T, 1), dtype=F64, device=fr.device), c], dim=1)
    return c[:, min_p:max_p + 1]


def observations(yin: torch.Tensor, p: Dict, sr: int, n: int, nbps: int,
                 min_p: int):
    """Trough probabilities scattered into the n pitch bins: (T, n) and the
    voiced probability (T,)."""
    T, L = yin.shape
    a, b, c = yin[:, :-2], yin[:, 1:-1], yin[:, 2:]
    den = a - 2.0 * b + c
    s = torch.where(den.abs() > 0, (a - c) / (2.0 * den), torch.zeros_like(den))
    shifts = torch.nn.functional.pad(torch.clamp(torch.nan_to_num(s), -0.5, 0.5),
                                     (1, 1))
    mask = torch.zeros_like(yin, dtype=torch.bool)
    mask[:, 1:-1] = (b < a) & (b <= c)
    mask[:, 0] = yin[:, 0] < yin[:, 1]

    lam = p["boltzmann_parameter"]
    edges = np.linspace(0.0, 1.0, p["n_thresholds"] + 1)
    prior = np.diff(special.betainc(p["beta_a"], p["beta_b"], edges))
    heights = torch.where(mask, yin, torch.full_like(yin, math.inf))
    any_trough = mask.any(dim=1)
    gmin = torch.argmin(heights, dim=1)
    rows = torch.arange(T, device=yin.device)
    probs = torch.zeros_like(yin)
    one_m = -math.expm1(-lam)
    for thr, bp in zip(edges[1:], prior):
        below = mask & (yin < thr)
        n_below = below.sum(dim=1)
        rank = torch.cumsum(below.to(torch.int64), dim=1) - 1
        den_b = -torch.expm1(-lam * torch.clamp_min(n_below, 1).to(F64))
        pmf = torch.exp(-lam * rank.to(F64)) * one_m / den_b[:, None]
        probs = probs + torch.where(below, bp * pmf, torch.zeros_like(pmf))
        none = (~below.any(dim=1)) & any_trough
        probs[rows, gmin] += torch.where(none, bp * p["no_trough_prob"], 0.0)

    periods = min_p + torch.arange(L, dtype=F64, device=yin.device) + shifts
    freqs = sr / torch.clamp_min(periods, 1e-6)
    bins = torch.round(12 * nbps * torch.log2(torch.clamp_min(freqs, 1e-6)
                                              / p["fmin"]))
    bins = torch.clamp(bins, 0, n - 1).to(torch.int64)
    obs = torch.zeros((T, n), dtype=F64, device=yin.device)
    obs.scatter_add_(1, bins, probs)
    return obs, torch.clamp(obs.sum(dim=1), 0.0, 1.0)


def local_transition(n: int, w: int) -> np.ndarray:
    """Row-normalized triangular band of half-width w, (n, n)."""
    i = np.arange(n)
    d = np.abs(i[:, None] - i[None, :])
    t = np.where(d <= w, w + 1 - d, 0).astype(np.float64)
    return t / t.sum(axis=1, keepdims=True)


def viterbi(obs: torch.Tensor, vp: torch.Tensor, n: int, w: int,
            switch: float) -> np.ndarray:
    """Max-product decode of B sequences, obs (B, T, n) and vp (B, T), over
    [0, n) voiced and [n, 2n) unvoiced states; ties go to the first source,
    and to staying over switching.  States (B, T)."""
    B, T = vp.shape
    dev = obs.device
    log_v = torch.log(obs + 1e-30)
    log_u = torch.log((1.0 - vp) / n + 1e-30)
    log_t = torch.as_tensor(np.log(local_transition(n, w) + 1e-30), device=dev)
    stay, sw = math.log1p(-switch), math.log(switch)
    dv = math.log(1.0 / (2 * n)) + log_v[:, 0]
    du = math.log(1.0 / (2 * n)) + log_u[:, 0, None].expand(B, n)
    psi = torch.zeros((T, B, 2, n), dtype=torch.int32, device=dev)
    for t in range(1, T):
        m, arg = torch.max(torch.stack([dv, du], dim=1)[:, :, :, None]
                           + log_t, dim=2)            # (B, 2, n) over sources
        m_v, m_u = m[:, 0], m[:, 1]
        a_v, a_u = arg[:, 0].to(torch.int32), arg[:, 1].to(torch.int32) + n
        keep_v = m_v + stay >= m_u + sw
        new_v = torch.where(keep_v, m_v + stay, m_u + sw) + log_v[:, t]
        psi[t, :, 0] = torch.where(keep_v, a_v, a_u)
        to_u = m_v + sw >= m_u + stay
        new_u = torch.where(to_u, m_v + sw, m_u + stay) + log_u[:, t, None]
        psi[t, :, 1] = torch.where(to_u, a_v, a_u)
        dv, du = new_v, new_u
    psi_h = psi.cpu().numpy()
    states = np.zeros((B, T), np.int64)
    states[:, -1] = torch.argmax(torch.cat([dv, du], dim=1), dim=1).cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 1, 0, -1):
        s = states[:, t]
        states[:, t - 1] = np.where(s < n, psi_h[t, rows, 0, np.minimum(s, n - 1)],
                                    psi_h[t, rows, 1, np.maximum(s - n, 0)])
    return states


def bin_hz(fmin: float, n: int, nbps: int) -> np.ndarray:
    """Hz of each pitch bin, fmin * 2^(b * (1 / (12 nbps))) in float32:
    the configuration states the bins in float32, the product by the
    rounded reciprocal, so a bin exactly on a half semitone rounds to the
    same note as the program's."""
    b = np.arange(n, dtype=np.float32)
    return (np.float32(fmin) * np.float32(2.0) ** (
        b * np.float32(1.0 / (12.0 * nbps)))).astype(np.float32)


# -------------------------------------------------------------- the whole

def analyze(pcm: np.ndarray, cfg: Dict, device) -> Dict[str, np.ndarray]:
    """The v1 rows of one take, as the program returns them: f0 (0 where
    unvoiced), voiced_flag, voiced_probs, rms, onset_env, rake_mask,
    mel_db."""
    a, p = cfg["audio"], cfg["pyin"]
    sr, hop, n_fft, n_mels = (a["sample_rate"], a["hop_length"], a["n_fft"],
                              a["n_mels"])
    true_frames = 1 + len(pcm) // hop
    y = ingest(pcm, cfg, device, cfg["ingest"]["transport"])

    spec = torch.fft.rfft(frames(y, n_fft, hop, True) * hann(n_fft, device),
                          dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=device)
    mel_db = power_to_db(power @ fb.T)
    flux = torch.clamp_min(mel_db[1:] - mel_db[:-1], 0.0).mean(dim=1)
    onset = torch.cat([torch.zeros(1, dtype=F64, device=device), flux])
    mel_db_h = mel_db.cpu().numpy()
    rake = rake_mask(mel_db_h, hop, sr, cfg["analysis"]["rake_sensitivity"])

    nbps, n, w, min_p, max_p = pyin_grid(p, sr, hop)
    fr = frames(y, p["frame_length"], hop, False)
    rms = torch.sqrt(torch.mean(fr * fr, dim=1))
    obs, vp = observations(cmndf(fr, p["win_length"], min_p, max_p), p, sr,
                           n, nbps, min_p)
    states = viterbi(obs[None], vp[None], n, w, p["switch_prob"])[0]
    voiced = states < n
    f0 = np.where(voiced, bin_hz(p["fmin"], n, nbps)[states % n], 0.0)
    cut = slice(0, true_frames)
    return {
        "f0": f0[cut].astype(np.float64),
        "voiced_flag": voiced[cut],
        "voiced_probs": vp.cpu().numpy()[cut],
        "rms": rms.cpu().numpy()[cut],
        "onset_env": onset.cpu().numpy()[cut],
        "rake_mask": rake[cut],
        "mel_db": mel_db_h[cut],
    }


def midi_hz(midi: float) -> float:
    """Hz of a MIDI note number (A4 = 69 = 440 Hz)."""
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)
