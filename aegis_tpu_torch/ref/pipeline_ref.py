"""CPU oracle for the fused analyze step (mirror of core.analyze), a copy
of ``aegis_tpu/ref/pipeline_ref.py``.

The float64 NumPy rows that ``tools/validate_device.py`` and
``tools/benchmark.py`` score the card against (device-vs-oracle note-event
F1 >= 0.99, BASELINE.md).  The port's engines have no oracle fallback: the
tools call this explicitly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core.analyze import pad_to_bucket
from aegis_tpu_torch.ref import dsp_ref, masks_ref, pyin_ref, trend_ref


def run_analyze_ref(
    y: np.ndarray,
    audio: AudioConfig,
    pyin_cfg: PyinConfig,
    rake_sensitivity: float = 0.6,
    financial: bool = False,
    use_guitar_filters: bool = True,
) -> Dict[str, np.ndarray]:
    true_frames = audio.n_frames(len(y))
    y = pad_to_bucket(np.asarray(y, np.float32))

    mel = dsp_ref.melspectrogram(y, audio.sample_rate, audio.n_fft,
                                 audio.hop_length, audio.n_mels)  # (mels, T)
    mel_db_t = dsp_ref.power_to_db(mel).T  # (T, mels)
    rake = masks_ref.detect_rake(mel_db_t, audio.hop_length, audio.sample_rate,
                                 rake_sensitivity)
    f0, voiced, probs = pyin_ref.pyin(y, audio.sample_rate, audio.hop_length,
                                      pyin_cfg)
    rms_ = dsp_ref.rms(y, pyin_cfg.frame_length, audio.hop_length)

    diff = mel_db_t[1:] - mel_db_t[:-1]
    onset_env = np.concatenate(
        [[0.0], np.mean(np.maximum(diff, 0.0), axis=1)])

    out = {
        "mel_db": mel_db_t,
        "rake_mask": rake,
        "f0": f0,
        "voiced_flag": voiced,
        "voiced_probs": probs,
        "rms": rms_,
        "onset_env": onset_env,
    }

    if financial:
        if use_guitar_filters:
            f0, voiced = masks_ref.filter_subharmonic(f0, voiced, fmin_hz=82.4)
            rake = masks_ref.enhance_rake(mel_db_t, audio.hop_length,
                                          audio.sample_rate, rake)
            mute = masks_ref.detect_palm_mute(mel_db_t, audio.hop_length,
                                              audio.sample_rate)
            voiced = voiced & ~mute
            dist = masks_ref.distortion_score(mel_db_t)
        else:
            mute = np.zeros_like(rake)
            dist = 0.0
        f0_clean = np.where(voiced, f0, np.nan)
        fin = trend_ref.analyze_pitch_financial(f0_clean)
        combined = probs * 0.5 + fin["confidence"] * 0.5
        out.update(
            f0=f0,
            voiced_flag=voiced,
            rake_mask=rake,
            mute_mask=mute,
            distortion_score=dist,
            trend=fin["trend"],
            artic_codes=fin["articulations"],
            slide_codes=fin["slides"],
            financial_confidence=fin["confidence"],
            combined_confidence=combined,
            adaptive_threshold=trend_ref.adaptive_confidence_threshold(combined),
        )

    result = {}
    for k, v in out.items():
        v = np.asarray(v)
        result[k] = v[:true_frames] if v.ndim >= 1 and v.shape[0] > true_frames else v
    return result
