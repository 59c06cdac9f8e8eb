"""aegis_tpu_torch DSP stages vs the JAX package's, on the same inputs (CPU).

Tolerances are those of tests/test_dsp_parity.py (JAX vs the NumPy oracle).
"""

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import dsp as jdsp
from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.core import dsp as tdsp
from aegis_tpu_torch.core.tables import tables_from_numpy

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _tables(sr):
    return tables_from_numpy(tconfig.AudioConfig(sample_rate=sr),
                             tconfig.PyinConfig(), CPU)


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


def test_rfft_stft_power_matches_jax_and_the_matmul_path(two_tone_22k):
    """use_matmul_dft=False: torch.fft.rfft against the JAX rfft path and
    against the port's own matmul path, each within test_dsp_parity.py's
    atol of the maximum; the mel spectrogram takes the same switch."""
    y, sr = two_tone_22k
    yt, tables = torch.from_numpy(y), _tables(sr)
    ref = np.asarray(jdsp.stft_power(y, 2048, 512, use_matmul_dft=False))
    got = tdsp.stft_power(yt, 512, tables, use_matmul_dft=False).numpy()
    matmul = tdsp.stft_power(yt, 512, tables).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == matmul.shape
    scale = np.max(ref)
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-3)
    np.testing.assert_allclose(matmul / scale, got / scale, atol=2e-3)
    mel_ref = np.asarray(jdsp.melspectrogram_t(y, sr, 2048, 512,
                                               use_matmul_dft=False))
    mel = tdsp.melspectrogram_t(yt, 512, tables, use_matmul_dft=False).numpy()
    np.testing.assert_allclose(mel / np.max(mel_ref), mel_ref / np.max(mel_ref),
                               atol=5e-3)


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


@pytest.mark.parametrize("name", ["amplitude_to_db", "hz_to_midi",
                                  "midi_to_hz"])
def test_db_and_pitch_helpers_match_jax(name):
    rng = np.random.default_rng(11)
    x = {"amplitude_to_db": rng.random((200, 64)).astype(np.float32) * 3.0,
         "hz_to_midi": rng.uniform(40.0, 2000.0, 500).astype(np.float32),
         "midi_to_hz": rng.uniform(20.0, 100.0, 500).astype(np.float32)}[name]
    if name == "amplitude_to_db":
        x[:3] = 0.0   # floored at amin
    ref = np.asarray(getattr(jdsp, name)(x))
    got = getattr(tdsp, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if name == "amplitude_to_db":   # power_to_db's tolerance, above
        np.testing.assert_allclose(got, ref, atol=1e-3)
        assert got.max() == 0.0 and got.min() >= -80.0 - 1e-6
    else:   # within two float32 ulps
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)


@pytest.mark.parametrize("kind", ["numpy", "float"])
def test_hz_to_midi_takes_numpy_arrays_and_floats(kind):
    """As the reference's (jnp.log2 takes both): the NumPy array or float
    gives what its tensor gives, within two float32 ulps of JAX."""
    x = (np.random.default_rng(12).uniform(40.0, 2000.0, 100).astype(np.float32)
         if kind == "numpy" else 196.0)
    got = tdsp.hz_to_midi(x)
    assert torch.equal(got, tdsp.hz_to_midi(torch.as_tensor(x)))
    ref = np.asarray(jdsp.hz_to_midi(x))
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-7, atol=0)
