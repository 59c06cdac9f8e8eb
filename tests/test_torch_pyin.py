"""aegis_tpu_torch pYIN stages and Viterbi decode vs the JAX package's.

Every stage gets the same input on both sides (numpy, seeded), so each
comparison isolates one stage.  Tolerances follow tests/test_pyin_parity.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import pyin as jpyin
from aegis_tpu.core import pyin_pallas as vp
from aegis_tpu.ref.pyin_ref import local_transition
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.tables import log_transition_band, tables_from_numpy
from aegis_tpu_torch.tools.signal_gen import wandering_pitch_obs

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

CFG = PyinConfig()
N = CFG.n_pitch_bins
SR = 22050
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def yin_22k(two_tone_22k):
    y, sr = two_tone_22k
    frames = np.asarray(jpyin.extract_pyin_frames(jnp.asarray(y), 512, CFG))
    yin = np.asarray(jpyin.cmndf_frames(jnp.asarray(frames), CFG.win_length,
                                        CFG.min_period(sr), CFG.max_period(sr)))
    return frames, yin


def _wandering_obs(T, seed, center, step, spread, jumps):
    return wandering_pitch_obs(T, N, seed, center, step, spread, jumps)


# the two synthetic cases of tests/test_pyin_parity.py, at their T
SYNTH = {
    "w101": (CFG.transition_width(22050, 512),
             _wandering_obs(40, 11, 200, 8, (-2, -1, 0, 1, 2), True)),
    "w51": (CFG.transition_width(44100, 512),
            _wandering_obs(32, 21, 150, 4, (0,), False)),
}


def _jax_scan(obs, vprob, width):
    log_local = jnp.asarray(np.log(local_transition(N, width) + 1e-30),
                            jnp.float32)
    return np.asarray(jpyin.viterbi_decode(jnp.asarray(obs), jnp.asarray(vprob),
                                           log_local, CFG.switch_prob))


# --------------------------------------------------------------- the stages

def test_frames_match_jax(two_tone_22k, yin_22k):
    y, _ = two_tone_22k
    got = tpyin.extract_pyin_frames(_t(y), 512, CFG).numpy()
    np.testing.assert_array_equal(got, yin_22k[0])


def test_cmndf_matches_jax(yin_22k):
    frames, yin = yin_22k
    got = tpyin.cmndf_frames(_t(frames), CFG.win_length, CFG.min_period(SR),
                             CFG.max_period(SR)).numpy()
    assert got.shape == yin.shape
    np.testing.assert_allclose(got, yin, atol=1e-4)


def test_shifts_and_trough_mask_match_jax(yin_22k):
    _, yin = yin_22k
    np.testing.assert_allclose(tpyin.parabolic_shifts(_t(yin)).numpy(),
                               np.asarray(jpyin.parabolic_shifts(yin)),
                               atol=1e-6)
    np.testing.assert_array_equal(tpyin.trough_mask(_t(yin)).numpy(),
                                  np.asarray(jpyin.trough_mask(yin)))


def test_trough_probabilities_match_jax(yin_22k):
    _, yin = yin_22k
    mask = np.asarray(jpyin.trough_mask(yin))
    ref = np.asarray(jpyin.trough_probabilities(yin, mask, CFG))
    tables = tables_from_numpy(AudioConfig(sample_rate=SR), CFG, CPU)
    got = tpyin.trough_probabilities(_t(yin), _t(mask), CFG, tables).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _trough_inputs(yin):
    mask = np.asarray(jpyin.trough_mask(yin))
    probs = np.asarray(jpyin.trough_probabilities(yin, mask, CFG))
    shifts = np.asarray(jpyin.parabolic_shifts(yin))
    return probs, shifts


def test_observations_match_jax(yin_22k):
    probs, shifts = _trough_inputs(yin_22k[1])
    ref_obs, ref_vp = (np.asarray(a) for a in jpyin.observations(
        probs, shifts, SR, CFG.min_period(SR), CFG))
    obs, vprob = tpyin.observations(_t(probs), _t(shifts), SR,
                                    CFG.min_period(SR), CFG)
    np.testing.assert_allclose(obs.numpy(), ref_obs, atol=1e-6)
    np.testing.assert_allclose(vprob.numpy(), ref_vp, atol=1e-6)


def test_observations_deterministic(yin_22k):
    probs, shifts = _trough_inputs(yin_22k[1])
    runs = [tpyin.observations(_t(probs), _t(shifts), SR, CFG.min_period(SR),
                               CFG) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ Viterbi

@pytest.mark.parametrize("case", sorted(SYNTH))
def test_viterbi_plain_equals_jax_scan(case):
    width, (obs, vprob) = SYNTH[case]
    ref = _jax_scan(obs, vprob, width)
    log_local = _t(np.log(local_transition(N, width) + 1e-30).astype(np.float32))
    got = tpyin.viterbi_decode(_t(obs), _t(vprob), log_local,
                               CFG.switch_prob).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(SYNTH))
def test_viterbi_plain_vs_jax_pallas_interpret(case):
    width, (obs, vprob) = SYNTH[case]
    trans = local_transition(N, width)
    band = jnp.asarray(vp.build_banded_log_transition(trans, width))
    pallas = np.asarray(vp.viterbi_decode_pallas(
        jnp.log(jnp.asarray(obs) + 1e-30),
        jnp.log((1.0 - jnp.asarray(vprob)) / N + 1e-30),
        band, N, width,
        float(np.log1p(-CFG.switch_prob)), float(np.log(CFG.switch_prob)),
        interpret=True))
    got = tpyin.viterbi_decode(
        _t(obs), _t(vprob), _t(np.log(trans + 1e-30).astype(np.float32)),
        CFG.switch_prob).numpy()
    assert (got == pallas).mean() > 0.99


@pytest.mark.parametrize("width", [51, 101, 150])
def test_band_table_is_the_dense_matrix(width):
    dense = np.log(local_transition(N, width) + 1e-30).astype(np.float32)
    band = _t(log_transition_band(N, width))
    np.testing.assert_array_equal(
        pyin_cuda.dense_from_band(band, N, width).numpy(), dense)


def test_decode_states_wide_band_equals_jax_scan():
    """w = 150 > 127: a band the TPU kernel could not take (its Hankel rows
    stop at 256); the port's decode takes any w."""
    width = 150
    obs, vprob = _wandering_obs(48, 5, 220, 20, (-1, 0, 1), True)
    with pytest.raises(ValueError):
        vp.build_banded_log_transition(local_transition(N, width), width)
    ref = _jax_scan(obs, vprob, width)
    tables = tables_from_numpy(AudioConfig(sample_rate=SR), CFG, CPU)
    wide = dataclasses.replace(tables, band=_t(log_transition_band(N, width)),
                               half_width=width)
    got = tpyin._decode_states(_t(obs)[None], _t(vprob)[None], wide,
                               CFG)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_batched_plain_decode_equals_per_sequence():
    width, (obs_a, vp_a) = SYNTH["w51"]
    obs_b, vp_b = _wandering_obs(32, 99, 300, 6, (0, 1), True)
    band = _t(log_transition_band(N, width))
    lo_v = torch.log(_t(np.stack([obs_a, obs_b])) + 1e-30)
    lo_u = torch.log((1.0 - _t(np.stack([vp_a, vp_b]))) / N + 1e-30)
    args = (band, N, width, float(np.log1p(-CFG.switch_prob)),
            float(np.log(CFG.switch_prob)))
    both = pyin_cuda.viterbi_decode_cuda(lo_v, lo_u, *args)
    for b in range(2):
        one = pyin_cuda.viterbi_decode_cuda(lo_v[b:b + 1], lo_u[b:b + 1], *args)
        assert torch.equal(both[b], one[0])


# -------------------------------------------------------------- whole pYIN

def test_pyin_matches_jax(two_tone_22k):
    y, sr = two_tone_22k
    f0j, vfj, vpj = (np.asarray(a) for a in jpyin.pyin(y, sr))
    f0t, vft, vpt = (a.numpy() for a in tpyin.pyin(y, sr))
    assert (vfj == vft).mean() == 1.0
    m = vfj & vft
    assert np.max(np.abs(f0j[m] - f0t[m]) / f0j[m]) < 1e-4
    assert np.all(np.isnan(f0t[~vft]))
    assert np.max(np.abs(vpj - vpt)) < 1e-4
