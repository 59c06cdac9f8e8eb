"""Device-side masks (PyTorch): rake detection, run-length gating, palm
mute, sub-harmonic correction, distortion score.  Counterpart of
``aegis_tpu/core/masks.py``.

Every function takes any leading batch dimensions: a row mask has time on
dim -1, a dB spectrogram is time-major ``(..., T, n_mels)``.  The tiled
program runs them on a batch of haloed tiles at once.
"""

from __future__ import annotations

from typing import Tuple

import torch


def run_length_keep(mask: torch.Tensor, min_len: int,
                    max_len: int) -> torch.Tensor:
    """Keep only True-runs whose length is within [min_len, max_len].

    Each run's start index propagates forward (cummax) and its end index
    backward (cummin over the flipped sequence); the run length gates it.
    """
    T = mask.shape[-1]
    idx = torch.arange(T, device=mask.device).expand(mask.shape)
    false = torch.zeros_like(mask[..., :1])
    prev = torch.cat([false, mask[..., :-1]], dim=-1)
    nxt = torch.cat([mask[..., 1:], false], dim=-1)
    starts = mask & ~prev
    ends = mask & ~nxt
    start_idx = torch.cummax(torch.where(starts, idx, -1), dim=-1).values
    end_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(ends, idx, T), [-1]), dim=-1).values, [-1])
    length = end_idx - start_idx + 1
    return mask & (length >= min_len) & (length <= max_len)


def detect_rake(S_db_t: torch.Tensor, hop_length: int, sr: int,
                broadband_threshold_ratio: float = 0.6) -> torch.Tensor:
    """Rake detection: broadband columns lasting 10-30 ms.

    A column is a candidate when the share of bins within 20 dB of its max
    exceeds the threshold and its max is at least -60 dB; candidates are
    then gated to 10-30 ms runs.
    """
    n_mels = S_db_t.shape[-1]
    col_max = torch.amax(S_db_t, dim=-1)
    active = torch.sum(S_db_t > (col_max[..., None] - 20.0), dim=-1)
    ratio = active.to(torch.float32) / n_mels
    candidate = (ratio > broadband_threshold_ratio) & (col_max >= -60.0)

    ms_per_frame = (hop_length / sr) * 1000.0
    min_frames = int(10.0 / ms_per_frame)
    max_frames = int(30.0 / ms_per_frame)
    return run_length_keep(candidate, min_frames, max_frames)


def detect_palm_mute(S_db_t: torch.Tensor, hop_length: int, sr: int,
                     duration_ms: float = 50.0) -> torch.Tensor:
    """Palm-mute mask: strong low band vs high band (ratio > 2) for runs no
    longer than duration_ms."""
    mid = S_db_t.shape[-1] // 2
    low = torch.mean(S_db_t[..., :mid], dim=-1)
    high = torch.mean(S_db_t[..., mid:], dim=-1)
    candidate = low / (high + 1e-6) > 2.0

    ms_per_frame = (hop_length / sr) * 1000.0
    return run_length_keep(candidate, 0, int(duration_ms / ms_per_frame))


def enhance_rake(S_db_t: torch.Tensor, hop_length: int, sr: int,
                 rake_mask: torch.Tensor) -> torch.Tensor:
    """Rake enhancement: a +10 dB energy jump followed by a (windowed-mean)
    decay extends the rake mask forward for the 30 ms window."""
    T = S_db_t.shape[-2]
    dev = S_db_t.device
    total = torch.mean(S_db_t, dim=-1)
    ediff = torch.diff(total, dim=-1, prepend=total[..., :1])

    ms_per_frame = (hop_length / sr) * 1000.0
    w = max(int(30.0 / ms_per_frame), 1)

    # windowed mean of ediff[i : i+w] via cumsum
    zero = torch.zeros_like(ediff[..., :1])
    cum = torch.cat([zero, torch.cumsum(ediff, dim=-1)], dim=-1)
    t = torch.arange(T, device=dev)
    has_window = t + w < T  # the reference requires the full window
    upper = torch.clamp_max(t + w, T)
    win_mean = (cum[..., upper] - cum[..., t]) / torch.clamp_min(upper - t, 1)

    trigger = (ediff > 10.0) & (win_mean < 0.0) & has_window
    # dilate each trigger forward by w frames: any trigger in (i-w, i]
    tcum = torch.cat([torch.zeros_like(trigger[..., :1], dtype=torch.int32),
                      torch.cumsum(trigger.to(torch.int32), dim=-1)], dim=-1)
    lower = torch.clamp_min(t + 1 - w, 0)
    dilated = (tcum[..., t + 1] - tcum[..., lower]) > 0
    return rake_mask | dilated


def filter_subharmonic(f0: torch.Tensor, voiced: torch.Tensor,
                       fmin_hz: float = 82.4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove sub-E2 pitches; attempt one-octave-up correction for plausible
    octave errors.  NaN f0 compares False throughout."""
    sub = f0 < fmin_hz
    corrected = f0 * 2.0
    correctable = sub & (corrected >= fmin_hz) & (corrected < fmin_hz * 4.0)
    nan = torch.full_like(f0, float("nan"))
    new_f0 = torch.where(correctable, corrected, torch.where(sub, nan, f0))
    return new_f0, correctable | (voiced & ~sub)


def distortion_score(S_db_t: torch.Tensor) -> torch.Tensor:
    """High-band energy ratio over the last two dims (T, n_mels), one value
    per leading index; thresholding to a label is classify_distortion."""
    high_start = int(S_db_t.shape[-1] * 0.7)
    high = torch.mean(S_db_t[..., high_start:], dim=(-2, -1))
    total = torch.mean(S_db_t, dim=(-2, -1))
    return high / (total + 1e-6)


def classify_distortion(ratio: float) -> str:
    if ratio > 0.4:
        return "heavy"
    if ratio > 0.25:
        return "light"
    return "clean"
