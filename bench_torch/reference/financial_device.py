"""The device half of the financial reference: plain PyTorch and NumPy in
float64.

What the financial configuration states, computed the obvious way, over
the bucket-padded track as the program computes it (its tail sees the
padded frames, so the moving windows, the Kalman and Holt-Winters states
and the adaptive threshold near the true end do too), then cut to the
true frame count:

* the v1 rows (mel dB, rake mask, pYIN, RMS, onset envelope) from the
  building blocks of ``reference/v1_device.py``, uncut;
* the guitar filters of upstream ``aegis_engine_core_v2/guitar_specific.py``:
  the sub-E2 octave correction, the rake enhancement (a +10 dB jump
  followed by a decaying 30 ms window), the palm mute (low band over high
  band above 2 in runs of at most 50 ms), the distortion score;
* the trend stack of upstream ``financial_filters.py:256-298`` and
  ``financial_analysis.py:368-423`` from their textbook definitions:
  EMA, the scalar Kalman filter and Holt's linear trend as sequential
  loops over the frames on the CPU (the Wilder RSI of the ghost filter is
  the host chain's, ``host_financial.py``); the moving average, the
  Savitzky-Golay fit and the Bollinger bands as plain windows (a window's
  sum over its length, its variance about its own mean); the consensus as
  the median of the three filters; the Bollinger
  articulation state machine, MACD slides, the Bollinger confidence and
  the adaptive threshold (mean less one standard deviation of the
  positive combined confidences, clipped to [0.3, 0.8]).

Departures from upstream, each the program's own convention:

* f0 is NaN on unvoiced frames throughout (upstream passes librosa's NaN
  f0 to the filters too, but its SMA and Bollinger windows count a NaN
  frame as a zero sample: kept);
* Savitzky-Golay forward-fills NaN gaps (leading ones from the first
  valid sample), fits with edge padding and restores the NaNs, where
  upstream compacts the gaps (financial_filters.py:41-55); all NaN when
  no more than ``window`` frames are valid, as upstream's guard;
* the financial confidence and the combined confidence are computed on
  every frame of the padded track, and the adaptive threshold over them.

TF32 is off: no float32 product here may run at a lower precision.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from bench_torch.reference import v1_device

F64 = torch.float64

ARTIC_NONE, ARTIC_NORMAL, ARTIC_BEND, ARTIC_VIBRATO, ARTIC_NOISE = 0, 1, 2, 3, 4
SLIDE_NONE, SLIDE_UP, SLIDE_DOWN, SLIDE_NORMAL = 0, 1, 2, 3


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------ the v1 rows

def base(pcm: np.ndarray, cfg: Dict, device,
         transport: str) -> Dict[str, np.ndarray]:
    """The v1 rows over every frame of the padded track, as
    ``v1_device.analyze`` computes them but uncut, f0 NaN where unvoiced."""
    a, p = cfg["audio"], cfg["pyin"]
    sr, hop, n_fft, n_mels = (a["sample_rate"], a["hop_length"], a["n_fft"],
                              a["n_mels"])
    y = v1_device.ingest(pcm, cfg, device, transport)
    spec = torch.fft.rfft(v1_device.frames(y, n_fft, hop, True)
                          * v1_device.hann(n_fft, device), dim=1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(v1_device.mel_filterbank(sr, n_fft, n_mels),
                         device=device)
    mel_db = v1_device.power_to_db(power @ fb.T)
    flux = torch.clamp_min(mel_db[1:] - mel_db[:-1], 0.0).mean(dim=1)
    onset = torch.cat([torch.zeros(1, dtype=F64, device=device), flux])
    mel_db_h = mel_db.cpu().numpy()
    rake = v1_device.rake_mask(mel_db_h, hop, sr,
                               cfg["analysis"]["rake_sensitivity"])

    nbps, n, w, min_p, max_p = v1_device.pyin_grid(p, sr, hop)
    fr = v1_device.frames(y, p["frame_length"], hop, False)
    rms = torch.sqrt(torch.mean(fr * fr, dim=1))
    obs, vp = v1_device.observations(
        v1_device.cmndf(fr, p["win_length"], min_p, max_p), p, sr, n, nbps,
        min_p)
    states = v1_device.viterbi(obs[None], vp[None], n, w, p["switch_prob"])[0]
    voiced = states < n
    f0 = np.where(voiced, v1_device.bin_hz(p["fmin"], n, nbps)[states % n],
                  np.nan).astype(np.float64)
    return {"f0": f0, "voiced_flag": voiced,
            "voiced_probs": vp.cpu().numpy(), "rms": rms.cpu().numpy(),
            "onset_env": onset.cpu().numpy(), "rake_mask": rake,
            "mel_db": mel_db_h}


# ------------------------------------------------------- guitar filters

def filter_subharmonic(f0: np.ndarray, voiced: np.ndarray,
                       fmin_hz: float = 82.4):
    """A pitch under E2 is an octave error where twice it lies in
    [fmin, 4 fmin) (taken an octave up), else unvoiced."""
    new_f0, new_voiced = f0.copy(), voiced.copy()
    for i in range(len(f0)):
        if not f0[i] < fmin_hz:          # NaN compares False
            continue
        if fmin_hz <= 2.0 * f0[i] < 4.0 * fmin_hz:
            new_f0[i], new_voiced[i] = 2.0 * f0[i], True
        else:
            new_f0[i], new_voiced[i] = np.nan, False
    return new_f0, new_voiced


def _frames_of_ms(ms: float, hop: int, sr: int) -> int:
    return int(ms / (hop / sr * 1000.0))


def enhance_rake(mel_db: np.ndarray, hop: int, sr: int,
                 rake: np.ndarray) -> np.ndarray:
    """Frames i .. i + w - 1 join the mask where the mean level jumps by
    more than 10 dB at i and the mean of the jumps over [i, i + w) is
    negative (a decay), w the frames of 30 ms; the window must fit."""
    out = rake.copy()
    total = mel_db.mean(axis=1)
    ediff = np.diff(total, prepend=total[0])
    w = max(_frames_of_ms(30.0, hop, sr), 1)
    T = len(total)
    for i in range(1, T):
        if ediff[i] > 10.0 and i + w < T and ediff[i:i + w].mean() < 0.0:
            out[i:i + w] = True
    return out


def palm_mute(mel_db: np.ndarray, hop: int, sr: int) -> np.ndarray:
    """Runs of at most 50 ms where the low half of the bands over the high
    half exceeds 2."""
    mid = mel_db.shape[1] // 2
    low = mel_db[:, :mid].mean(axis=1)
    high = mel_db[:, mid:].mean(axis=1)
    return v1_device.run_length_keep(low / (high + 1e-6) > 2.0, 0,
                                     _frames_of_ms(50.0, hop, sr))


def distortion_score(mel_db: np.ndarray) -> float:
    high = mel_db[:, int(mel_db.shape[1] * 0.7):].mean()
    return float(high / (mel_db.mean() + 1e-6))


# ------------------------------------------------------------ the trend

def sma(x: np.ndarray, window: int) -> np.ndarray:
    """The centered moving average of np.convolve(..., "same"): frames
    [i - window // 2, i + (window - 1) // 2], a NaN or missing frame
    counting as 0, over ``window``; NaN where x is."""
    v = np.where(np.isnan(x), 0.0, x)
    left = window - 1 - (window - 1) // 2
    out = np.empty(len(x))
    for i in range(len(x)):
        out[i] = v[max(i - left, 0):i + window - left].sum() / window
    return np.where(np.isnan(x), np.nan, out)


def trailing_std(x: np.ndarray, window: int) -> np.ndarray:
    """The population standard deviation of the valid frames of
    [i - window + 1, i] about their own mean; NaN under two."""
    out = np.full(len(x), np.nan)
    for i in range(len(x)):
        v = x[max(i - window + 1, 0):i + 1]
        v = v[~np.isnan(v)]
        if len(v) > 1:
            out[i] = math.sqrt(((v - v.mean()) ** 2).mean())
    return out


def bollinger(x: np.ndarray, window: int, num_std: float = 2.0):
    ma = sma(x, window)
    sd = trailing_std(x, window)
    return ma, ma + num_std * sd, ma - num_std * sd


def articulation(f0: np.ndarray, window: int = 10,
                 sensitivity: float = 2.0) -> np.ndarray:
    """Bollinger state machine: above the band a bend, below it noise, a
    third change of side in a row vibrato; NaN frames none and hold the
    state."""
    _, upper, lower = bollinger(f0, window, sensitivity)
    out = np.zeros(len(f0), np.int8)
    prev, counter = 0, 0
    for i in range(len(f0)):
        if np.isnan(f0[i]):
            continue
        state = (1 if f0[i] > upper[i] else
                 2 if f0[i] < lower[i] else 0)   # NaN bands compare False
        counter = counter + 1 if (state != prev and prev != 0) else 0
        out[i] = (ARTIC_VIBRATO if counter >= 2 else ARTIC_BEND if state == 1
                  else ARTIC_NOISE if state == 2 else ARTIC_NORMAL)
        prev = state
    return out


# a band edge within this share of f0 is a tie: float32 moving sums and
# deviations of Hz values carry ~1e-7 of f0
TIE_REL = 1e-6


def articulation_ties(f0: np.ndarray, window: int = 10) -> np.ndarray:
    """The frames whose articulation code rounding decides: where f0 lies
    within ``TIE_REL`` of a band edge (above all a held pitch, whose band
    has no width and whose f0 is its center), the side f0 falls on is the
    last bits of the moving average's sum, which float32 and float64 round
    differently; the state machine carries that side into the next two
    valid frames' codes (a third change of side in a row is vibrato), so
    those are marked too."""
    _, upper, lower = bollinger(f0, window)
    with np.errstate(invalid="ignore"):
        tie = ((np.abs(f0 - upper) <= TIE_REL * f0)
               | (np.abs(f0 - lower) <= TIE_REL * f0))
    valid = np.flatnonzero(~np.isnan(f0))
    out = np.zeros(len(f0), bool)
    for r in np.flatnonzero(tie[valid]):
        out[valid[r:r + 3]] = True
    return out


def ema(x: np.ndarray, span: int) -> np.ndarray:
    """y = a x + (1 - a) y_prev, a = 2 / (span + 1); a NaN frame is NaN
    and the next valid frame starts again from itself."""
    alpha = 2.0 / (span + 1.0)
    out = np.full(len(x), np.nan)
    prev = np.nan
    for i in range(len(x)):
        if np.isnan(x[i]):
            prev = np.nan
            continue
        prev = x[i] if np.isnan(prev) else alpha * x[i] + (1 - alpha) * prev
        out[i] = prev
    return out


def slides(f0: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """MACD (5, 20, 9) of the pitch in semitones: up where the line is
    over ``threshold`` and the histogram positive, down where under
    -``threshold`` and negative; none where the line is NaN."""
    semis = 12.0 * np.log2(f0 / 440.0) + 69.0
    line = ema(semis, 5) - ema(semis, 20)
    hist = line - ema(line, 9)
    out = np.full(len(f0), SLIDE_NORMAL, np.int8)
    out[(line > threshold) & (hist > 0)] = SLIDE_UP
    out[(line < -threshold) & (hist < 0)] = SLIDE_DOWN
    out[np.isnan(line)] = SLIDE_NONE
    return out


def kalman(x: np.ndarray, q: float = 1e-5, r: float = 1e-1) -> np.ndarray:
    """Scalar Kalman filter from the first valid frame, P0 = 1; a NaN
    frame leaves the state and stays NaN."""
    valid = ~np.isnan(x)
    if not valid.any():
        return x.copy()
    out = np.full(len(x), np.nan)
    est, p = x[int(np.argmax(valid))], 1.0
    for i in range(len(x)):
        if valid[i]:
            p_pred = p + q
            k = p_pred / (p_pred + r)
            est = est + k * (x[i] - est)
            p = (1 - k) * p_pred
            out[i] = est
    return out


def holt_winters(x: np.ndarray, alpha: float = 0.3,
                 beta: float = 0.1) -> np.ndarray:
    """Holt's linear trend from the first two valid frames; a NaN frame
    leaves the state and stays NaN; fewer than two valid frames: x."""
    idx = np.flatnonzero(~np.isnan(x))
    if len(idx) < 2:
        return x.copy()
    out = np.full(len(x), np.nan)
    level, trend = x[idx[0]], x[idx[1]] - x[idx[0]]
    for i in range(len(x)):
        if np.isnan(x[i]):
            continue
        new_level = alpha * x[i] + (1 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1 - beta) * trend
        level = new_level
        out[i] = level
    return out


def savgol(x: np.ndarray, window: int = 11, polyorder: int = 3) -> np.ndarray:
    """The least-squares cubic over each ``window`` frames, evaluated at
    the middle one, on the forward-filled track with its edges repeated."""
    valid = ~np.isnan(x)
    if valid.sum() <= window:
        return np.full(len(x), np.nan)
    filled = x.copy()
    last = x[int(np.argmax(valid))]
    for i in range(len(x)):
        if valid[i]:
            last = x[i]
        else:
            filled[i] = last
    half = window // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    coef = np.linalg.pinv(np.vander(t, polyorder + 1, increasing=True))[0]
    padded = np.concatenate([np.full(half, filled[0]), filled,
                             np.full(half, filled[-1])])
    out = np.array([padded[i:i + window] @ coef for i in range(len(x))])
    return np.where(valid, out, np.nan)


def consensus(f0: np.ndarray) -> np.ndarray:
    """The median of Savitzky-Golay, Kalman and Holt-Winters over the
    filters valid at each frame; NaN where none is."""
    stacked = np.stack([savgol(f0), kalman(f0), holt_winters(f0)])
    med = np.full(len(f0), np.nan)
    for i in range(len(f0)):
        v = stacked[:, i][~np.isnan(stacked[:, i])]
        if len(v):
            med[i] = np.median(v)
    return med


def bollinger_confidence(f0: np.ndarray, window: int = 10) -> np.ndarray:
    """1 / (1 + band width), 1 where the band has no width, 0 where f0 or
    the band is NaN."""
    _, upper, lower = bollinger(f0, window)
    bw = upper - lower
    conf = np.where(bw > 0, 1.0 / (1.0 + bw), 1.0)
    return np.where(np.isnan(f0) | np.isnan(bw), 0.0, conf)


def adaptive_threshold(conf: np.ndarray) -> float:
    pos = conf[conf > 0]
    if not len(pos):
        return 0.5
    return float(np.clip(pos.mean() - math.sqrt(((pos - pos.mean()) ** 2)
                                                  .mean()), 0.3, 0.8))


def tail(rows: Dict[str, np.ndarray], cfg: Dict) -> Dict[str, np.ndarray]:
    """The guitar filters and the trend stack over base rows."""
    a = cfg["audio"]
    hop, sr = a["hop_length"], a["sample_rate"]
    mel_db = rows["mel_db"]
    f0, voiced = filter_subharmonic(rows["f0"], rows["voiced_flag"])
    rake = enhance_rake(mel_db, hop, sr, rows["rake_mask"])
    mute = palm_mute(mel_db, hop, sr)
    voiced = voiced & ~mute
    f0_clean = np.where(voiced, f0, np.nan)
    trend = consensus(f0_clean)
    conf = bollinger_confidence(f0_clean, 10)
    combined = rows["voiced_probs"] * 0.5 + conf * 0.5
    return dict(rows, f0=f0, voiced_flag=voiced, rake_mask=rake,
                mute_mask=mute, distortion_score=distortion_score(mel_db),
                trend=trend, artic_codes=articulation(f0_clean, 10),
                artic_ties=articulation_ties(f0_clean, 10),
                slide_codes=slides(f0_clean, 0.3),
                financial_confidence=conf, combined_confidence=combined,
                adaptive_threshold=adaptive_threshold(combined))


def analyze(pcm: np.ndarray, cfg: Dict, device) -> Dict[str, np.ndarray]:
    """The financial rows of one take as the folder fetches them (no mel),
    cut to the true frames; the per-track scalars as floats."""
    no_tf32()
    rows = tail(base(pcm, cfg, device, cfg["ingest"]["transport"]), cfg)
    T = 1 + len(pcm) // cfg["audio"]["hop_length"]
    return {k: (v[:T] if np.ndim(v) else float(v)) for k, v in rows.items()
            if k != "mel_db"}
