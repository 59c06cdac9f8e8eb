"""The device half of the poly reference: plain PyTorch in float64.

What the poly configuration states, computed the obvious way: the int8
block-float ingest of the bucket-padded track (``v1_device.ingest``), one
STFT (centered reflect frames, periodic Hann, ``torch.fft.rfft``) projected
on the pseudo-CQT filterbank (triangles between log-spaced centres from
C1, each normalized to unit sum) and on the mel filterbank for the onset
envelope, the RMS over the window, and the harmonic-salience peel: each
round the geometric mean of a bin's magnitude and its harmonic comb
average, the arg-max (the first of equal maxima), the preference for the
-19 then the -12 semitone bin when comparably salient, and the pick's
widened comb scaled out of the magnitudes.  The acceptance into the piano
roll is ``host_poly.roll_and_confidence_ref``; the CQT magnitudes reach the
host as float16, as the configuration states.  Nothing comes from the
program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from bench_torch.reference import host_poly, v1_device

F64 = torch.float64


def cqt_filterbank(sr: int, n_fft: int, n_bins: int, bpo: int,
                   fmin: float) -> np.ndarray:
    """(n_bins, 1 + n_fft // 2): triangles rising from the centre below to
    the bin's centre and falling to the one above, unit sum; a triangle
    that falls between two FFT bins takes the nearest FFT bin whole."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    c = fmin * 2.0 ** ((np.arange(n_bins + 2) - 1.0) / bpo)
    w = np.zeros((n_bins, freqs.size))
    for i in range(n_bins):
        up = (freqs - c[i]) / max(c[i + 1] - c[i], 1e-9)
        down = (c[i + 2] - freqs) / max(c[i + 2] - c[i + 1], 1e-9)
        w[i] = np.maximum(0.0, np.minimum(up, down))
        if w[i].sum() > 0:
            w[i] /= w[i].sum()
        else:
            w[i, int(np.argmin(np.abs(freqs - c[i + 1])))] = 1.0
    return w


def combs(n_bins: int, bpo: int, n_harm: int, decay: float, spread: int):
    """(suppression comb, subtraction comb), (n_bins, n_bins) each: row i
    weighs harmonic h of bin i by decay^(h - 1) at i + round(bpo log2 h),
    triangular over +-spread bins; the subtraction comb is that comb max-ed
    with its shifts by one bin either way."""
    supp = np.zeros((n_bins, n_bins))
    rows = np.arange(n_bins)
    for h in range(1, n_harm + 1):
        off = int(round(bpo * math.log2(h)))
        for d in range(-spread, spread + 1):
            wt = decay ** (h - 1) * (1.0 - abs(d) / (spread + 1))
            j = rows + off + d
            ok = (j >= 0) & (j < n_bins)
            supp[rows[ok], j[ok]] = np.maximum(supp[rows[ok], j[ok]], wt)
    sub = supp.copy()
    sub[:, 1:] = np.maximum(sub[:, 1:], supp[:, :-1])
    sub[:, :-1] = np.maximum(sub[:, :-1], supp[:, 1:])
    return supp, sub


def peel(cqt: torch.Tensor, pc: Dict):
    """(bins (T, V), saliences (T, V)) of the peel's rounds, in pick order."""
    n = cqt.shape[1]
    supp_np, sub_np = combs(n, pc["bins_per_octave"], pc["n_harmonics"],
                            pc["decay"], pc["spread"])
    supp = torch.as_tensor(supp_np, device=cqt.device)
    sub = torch.as_tensor(sub_np, device=cqt.device)
    row = supp.sum(dim=1)
    rowsum = torch.clamp_min(torch.maximum(row, pc["comb_norm_floor"]
                                           * row.max()), 1e-10)
    mag = torch.sqrt(torch.clamp_min(cqt, 0.0))
    alpha = pc["alpha"]
    t = torch.arange(cqt.shape[0], device=cqt.device)
    bins, sals = [], []
    for _ in range(pc["max_voices"]):
        sal = (torch.clamp_min(mag, 0.0) ** alpha
               * torch.clamp_min(mag @ supp.T / rowsum, 0.0) ** (1.0 - alpha))
        pick = torch.argmax(sal, dim=1)
        for off, gamma in ((19, pc["gamma19"]), (12, pc["gamma12"])):
            cand = torch.clamp(pick - off, 0, n - 1)
            take = (pick >= off) & (sal[t, cand] >= gamma * sal[t, pick])
            pick = torch.where(take, cand, pick)
        bins.append(pick)
        sals.append(sal[t, pick])
        mag = mag * (1.0 - torch.clamp(pc["over_subtract"] * sub[pick],
                                       0.0, 1.0))
    return torch.stack(bins, dim=1), torch.stack(sals, dim=1)


def analyze(pcm: np.ndarray, cfg: Dict, device, transport: str = "int8"
            ) -> Dict[str, np.ndarray]:
    """The poly analysis of one take as the program's host receives it:
    roll, confidence, salience (T, 128), rms, onset_env, cqt_mag (T, 84),
    and the peel's ``bins`` / ``sals`` (T, V)."""
    a, pc = cfg["audio"], cfg["peel"]
    sr, hop, n_fft = a["sample_rate"], a["hop_length"], a["n_fft"]
    true_frames = 1 + len(pcm) // hop
    y = v1_device.ingest(pcm, cfg, device, transport)
    spec = torch.fft.rfft(v1_device.frames(y, n_fft, hop, True)
                          * v1_device.hann(n_fft, device), dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(cqt_filterbank(sr, n_fft, pc["n_bins"],
                                        pc["bins_per_octave"],
                                        v1_device.midi_hz(pc["fmin_midi"])),
                         device=device)
    cqt = power @ fb.T
    mel = power @ torch.as_tensor(v1_device.mel_filterbank(sr, n_fft,
                                                           a["n_mels"]),
                                  device=device).T
    mel_db = v1_device.power_to_db(mel)
    flux = torch.clamp_min(mel_db[1:] - mel_db[:-1], 0.0).mean(dim=1)
    onset = torch.cat([torch.zeros(1, dtype=F64, device=device), flux])
    fr = v1_device.frames(y, n_fft, hop, False)
    rms = torch.sqrt(torch.mean(fr * fr, dim=1))
    bins, sals = peel(cqt, pc)
    cut = slice(0, true_frames)
    bins_h = bins.cpu().numpy()[cut].astype(np.int32)
    sals_h = sals.cpu().numpy()[cut]
    roll, conf, salience = host_poly.roll_and_confidence_ref(
        bins_h, sals_h.astype(np.float32), pc["bins_per_octave"])
    cqt_mag = torch.sqrt(torch.clamp_min(cqt, 0.0)).to(torch.float16)
    return {"roll": roll, "confidence": conf, "salience": salience,
            "rms": rms.cpu().numpy()[cut],
            "onset_env": onset.cpu().numpy()[cut],
            "cqt_mag": cqt_mag.cpu().numpy()[cut].astype(np.float32),
            "bins": bins_h, "sals": sals_h}
