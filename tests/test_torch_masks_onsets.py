"""aegis_tpu_torch masks and onsets vs the JAX package's, on the same inputs."""

import numpy as np
import pytest
import torch

from aegis_tpu.core import cqt as jcqt
from aegis_tpu.core import dsp as jdsp
from aegis_tpu.core import masks as jmasks
from aegis_tpu.tools.signal_gen import generate_test_track
from aegis_tpu_torch.core import cqt as tcqt
from aegis_tpu_torch.core import masks as tmasks

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

SR = 22050


@pytest.fixture(scope="module")
def ks_mel():
    """Mel power (T, n_mels) of the KS clip, which carries two rake bursts."""
    y, _ = generate_test_track(sr=SR)
    return np.asarray(jdsp.melspectrogram_t(y, SR, 2048, 512))


@pytest.mark.parametrize("min_len,max_len", [(1, 1), (2, 3), (1, 40)])
def test_run_length_keep_matches_jax(min_len, max_len):
    mask = np.random.default_rng(min_len * 7 + max_len).random(500) < 0.6
    ref = np.asarray(jmasks.run_length_keep(mask, min_len, max_len))
    got = tmasks.run_length_keep(torch.from_numpy(mask), min_len, max_len)
    np.testing.assert_array_equal(got.numpy(), ref)


def _burst_db(n_frames=300, n_mels=128, seed=4):
    """dB columns, mostly one strong bin over a -80 dB floor, with broadband
    bursts of 1, 2 and 5 frames (only the short ones are rakes)."""
    rng = np.random.default_rng(seed)
    S = -80.0 + rng.random((n_frames, n_mels)) * 5.0
    S[np.arange(n_frames), rng.integers(0, n_mels, n_frames)] = 0.0
    for start, length in ((40, 1), (90, 2), (150, 5), (220, 1)):
        S[start:start + length] = -6.0 + rng.random((length, n_mels)) * 4.0
    return S.astype(np.float32)


@pytest.mark.parametrize("sr", [22050, 44100])
@pytest.mark.parametrize("source", ["ks_clip", "bursts"])
def test_detect_rake_matches_jax(ks_mel, sr, source):
    mel_db = (np.asarray(jdsp.power_to_db(ks_mel)) if source == "ks_clip"
              else _burst_db())
    ref = np.asarray(jmasks.detect_rake(mel_db, 512, sr, 0.6))
    got = tmasks.detect_rake(torch.from_numpy(mel_db), 512, sr, 0.6).numpy()
    np.testing.assert_array_equal(got, ref)
    if source == "bursts":
        assert ref.any() and not ref.all()


def test_onset_strength_matches_jax(ks_mel):
    ref = np.asarray(jcqt.onset_strength_t(ks_mel))
    got = tcqt.onset_strength_t(torch.from_numpy(ks_mel)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_onsets_copy_identical(seed):
    rng = np.random.default_rng(seed)
    env = np.abs(rng.normal(size=700)) * (rng.random(700) < 0.2)
    for sr in (22050, 44100):
        np.testing.assert_array_equal(tcqt.pick_onsets(env, sr, 512),
                                      jcqt.pick_onsets(env, sr, 512))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_events_at_onsets_copy_identical(seed):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(900, 25, replace=False))
    events = [{"note": int(rng.integers(40, 80)), "start": int(s),
               "end": int(s + rng.integers(1, 60)), "velocity": 64}
              for s in starts]
    onsets = np.sort(rng.choice(1000, 60, replace=False)).astype(np.int64)
    for min_frames, tail in ((2, None), (4, 8)):
        got = tcqt.split_events_at_onsets([dict(e) for e in events], onsets,
                                          min_frames, tail)
        ref = jcqt.split_events_at_onsets([dict(e) for e in events], onsets,
                                          min_frames, tail)
        assert got == ref
        assert len(ref) > len(events)  # some events were split


@pytest.mark.parametrize("sr", [22050, 44100])
def test_onset_envelope_program_matches_jax(sr):
    """Audio -> mel -> onset envelope as one program on the tensor's
    device, against the jitted JAX program."""
    y, _ = generate_test_track(sr=sr)
    ref = np.asarray(jcqt.onset_envelope_program(y, sr))
    got = tcqt.onset_envelope_program(torch.from_numpy(y), sr).numpy()
    assert got.shape == ref.shape == (1 + len(y) // 512,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=7.7e-5)
