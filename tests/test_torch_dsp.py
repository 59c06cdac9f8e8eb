"""aegis_tpu_torch DSP stages vs the JAX package's, on the same inputs (CPU).

Tolerances are those of tests/test_dsp_parity.py (JAX vs the NumPy oracle).
"""

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import dsp as jdsp
from aegis_tpu_torch.core import dsp as tdsp
from aegis_tpu_torch.core.tables import tables_from_numpy

CPU = torch.device("cpu")


def _tables(sr):
    return tables_from_numpy(AudioConfig(sample_rate=sr), PyinConfig(), CPU)


@pytest.mark.parametrize("frame_length,hop,mode", [
    (2048, 512, "reflect"),    # slice+reshape path
    (2048, 512, "constant"),
    (2048, 500, "reflect"),    # gather path
    (1000, 300, "constant"),
])
def test_frame_signal_matches_jax(frame_length, hop, mode):
    y = np.random.default_rng(3).normal(size=12_345).astype(np.float32)
    ref = np.asarray(jdsp.frame_signal(y, frame_length, hop, mode))
    got = tdsp.frame_signal(torch.from_numpy(y), frame_length, hop, mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_frame_signal_reflect_pad_longer_than_signal_raises():
    with pytest.raises(ValueError, match="reflect pad"):
        tdsp.frame_signal(torch.zeros(100), 2048, 512, "reflect")


def test_stft_power_matches_jax(two_tone_22k):
    y, sr = two_tone_22k
    ref = np.asarray(jdsp.stft_power(y, 2048, 512))
    got = tdsp.stft_power(torch.from_numpy(y), 512, _tables(sr)).numpy()
    assert got.shape == ref.shape
    scale = np.max(ref)
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-3)


def test_melspectrogram_matches_jax(two_tone_22k):
    y, sr = two_tone_22k
    ref = np.asarray(jdsp.melspectrogram_t(y, sr, 2048, 512))
    got = tdsp.melspectrogram_t(torch.from_numpy(y), 512, _tables(sr)).numpy()
    assert got.shape == ref.shape
    scale = np.max(ref)
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-3)


def test_power_to_db_matches_jax(two_tone_22k):
    y, sr = two_tone_22k
    S = np.asarray(jdsp.melspectrogram_t(y, sr, 2048, 512))
    ref = np.asarray(jdsp.power_to_db(S))
    got = tdsp.power_to_db(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert abs(got.max()) < 1e-4  # ref=max convention
    assert got.min() >= -80.0 - 1e-6  # top_db clamp


def test_rms_matches_jax(two_tone_22k):
    y, _ = two_tone_22k
    ref = np.asarray(jdsp.rms(y))
    got = tdsp.rms(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
