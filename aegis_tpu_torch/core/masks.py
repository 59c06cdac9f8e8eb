"""Rake detection and run-length gating (PyTorch), the v1 subset of
``aegis_tpu/core/masks.py``.  Spectrogram layout is time-major (T, n_mels).
"""

from __future__ import annotations

import torch


def run_length_keep(mask: torch.Tensor, min_len: int,
                    max_len: int) -> torch.Tensor:
    """Keep only True-runs whose length is within [min_len, max_len].

    Each run's start index propagates forward (cummax) and its end index
    backward (cummin over the flipped sequence); the run length gates it.
    """
    T = mask.shape[0]
    idx = torch.arange(T, device=mask.device)
    false = torch.zeros(1, dtype=torch.bool, device=mask.device)
    prev = torch.cat([false, mask[:-1]])
    nxt = torch.cat([mask[1:], false])
    starts = mask & ~prev
    ends = mask & ~nxt
    start_idx = torch.cummax(torch.where(starts, idx, -1), dim=0).values
    end_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(ends, idx, T), [0]), dim=0).values, [0])
    length = end_idx - start_idx + 1
    return mask & (length >= min_len) & (length <= max_len)


def detect_rake(S_db_t: torch.Tensor, hop_length: int, sr: int,
                broadband_threshold_ratio: float = 0.6) -> torch.Tensor:
    """Rake detection: broadband columns lasting 10-30 ms.

    A column is a candidate when the share of bins within 20 dB of its max
    exceeds the threshold and its max is at least -60 dB; candidates are
    then gated to 10-30 ms runs.
    """
    T, n_mels = S_db_t.shape
    col_max = torch.amax(S_db_t, dim=1)
    active = torch.sum(S_db_t > (col_max[:, None] - 20.0), dim=1)
    ratio = active.to(torch.float32) / n_mels
    candidate = (ratio > broadband_threshold_ratio) & (col_max >= -60.0)

    ms_per_frame = (hop_length / sr) * 1000.0
    min_frames = int(10.0 / ms_per_frame)
    max_frames = int(30.0 / ms_per_frame)
    return run_length_keep(candidate, min_frames, max_frames)
