"""aegis_tpu_torch's financial (v2) path vs the JAX package's on the CPU:
the guitar masks, the fused financial rows of ``run_analyze(financial=True)``
and the ``AegisFinancialEngine`` events, on the KS and scale clips."""

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core import dsp as jdsp
from aegis_tpu.core import masks as jmasks
from aegis_tpu.core.analyze import run_analyze as jax_run_analyze
from aegis_tpu.engine.financial import AegisFinancialEngine as JaxFinancial
from aegis_tpu.midi.decode import midi_to_notes
from aegis_tpu.ref.pipeline_ref import run_analyze_ref
from aegis_tpu.tools.signal_gen import generate_scale_benchmark, generate_test_track
from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.core import masks as tmasks
from aegis_tpu_torch.core.analyze import _FIN_ROWS, run_analyze
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from test_torch_engine import assert_same_events

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

SR = 22050
AUDIO, CFG = AudioConfig(sample_rate=SR), PyinConfig()
# the port is handed its own config classes
TAUDIO, TCFG = tconfig.AudioConfig(sample_rate=SR), tconfig.PyinConfig()
CLIPS = {"ks": lambda: generate_test_track(sr=SR)[0],
         "scale": lambda: generate_scale_benchmark(sr=SR)[0]}


@pytest.fixture(scope="module")
def clip():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = CLIPS[name]()
        return cache[name]
    return get


@pytest.fixture(scope="module")
def mel_db(clip):
    """dB mel (T, n_mels) of each clip, from the JAX package."""
    return {name: np.asarray(jdsp.power_to_db(jdsp.melspectrogram_t(
        clip(name), SR, 2048, 512))) for name in CLIPS}


# ------------------------------------------------------------ guitar masks

@pytest.mark.parametrize("name", sorted(CLIPS))
def test_guitar_masks_match_jax(mel_db, name):
    S = mel_db[name]
    St = torch.from_numpy(S)
    np.testing.assert_array_equal(
        tmasks.detect_palm_mute(St, 512, SR).numpy(),
        np.asarray(jmasks.detect_palm_mute(S, 512, SR)))
    rake = np.asarray(jmasks.detect_rake(S, 512, SR, 0.6))
    np.testing.assert_array_equal(
        tmasks.enhance_rake(St, 512, SR, torch.from_numpy(rake)).numpy(),
        np.asarray(jmasks.enhance_rake(S, 512, SR, rake)))
    got = float(tmasks.distortion_score(St))
    ref = float(jmasks.distortion_score(S))
    assert abs(got - ref) < 1e-5
    assert tmasks.classify_distortion(got) == jmasks.classify_distortion(ref)


def test_enhance_rake_fires_on_a_jump():
    """A +10 dB broadband jump followed by a steeper drop extends the mask
    (at 44 100 Hz: the 30 ms window is 2 frames, at 22 050 Hz only 1, where
    the window mean is the jump itself and never negative)."""
    S = np.full((80, 128), -70.0, np.float32)
    S[30] = -5.0
    S[31:40] = -80.0
    rake = np.zeros(80, bool)
    ref = np.asarray(jmasks.enhance_rake(S, 512, 44100, rake))
    got = tmasks.enhance_rake(torch.from_numpy(S), 512, 44100,
                              torch.from_numpy(rake)).numpy()
    assert ref.any()
    np.testing.assert_array_equal(got, ref)


def test_filter_subharmonic_matches_jax():
    f0 = np.array([60.0, 41.0, 20.0, 90.0, np.nan, 82.3, 500.0], np.float32)
    voiced = np.array([1, 1, 1, 0, 0, 1, 1], bool)
    jf, jv = jmasks.filter_subharmonic(f0, voiced)
    tf, tv = tmasks.filter_subharmonic(torch.from_numpy(f0),
                                       torch.from_numpy(voiced))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_masks_take_a_leading_batch(mel_db):
    """(B, T, n_mels) tiles give each tile's own result."""
    n = min(len(mel_db["ks"]), len(mel_db["scale"])) // 2
    S = np.stack([mel_db["ks"][:n], mel_db["scale"][:n],
                  mel_db["ks"][n:2 * n]])
    St = torch.from_numpy(S)
    rake = tmasks.detect_rake(St, 512, SR, 0.6)
    batched = {"rake": rake,
               "mute": tmasks.detect_palm_mute(St, 512, SR),
               "enhanced": tmasks.enhance_rake(St, 512, SR, rake),
               "dist": tmasks.distortion_score(St)}
    for i in range(len(S)):
        Si = St[i]
        ri = tmasks.detect_rake(Si, 512, SR, 0.6)
        single = {"rake": ri, "mute": tmasks.detect_palm_mute(Si, 512, SR),
                  "enhanced": tmasks.enhance_rake(Si, 512, SR, ri),
                  "dist": tmasks.distortion_score(Si)}
        for k, v in single.items():
            torch.testing.assert_close(batched[k][i], v, rtol=0, atol=0)


# --------------------------------------------------- fused financial rows

@pytest.mark.parametrize("transport,filters", [("int8", True),
                                               ("float32", True),
                                               ("float32", False)])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_financial_rows_match_jax(clip, name, transport, filters):
    y = clip(name)
    ref = jax_run_analyze(y, AUDIO, CFG, financial=True, transport=transport,
                          use_guitar_filters=filters)
    got = run_analyze(y, TAUDIO, TCFG, financial=True, transport=transport,
                      use_guitar_filters=filters, device="cpu")
    for k in _FIN_ROWS:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in ("artic_codes", "slide_codes"):
            assert g.dtype == np.int8
            assert (g == r).mean() >= 0.99, k
        elif k == "f0":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            m = ~np.isnan(r)
            assert np.max(np.abs(g[m] - r[m]) / r[m]) < 1e-4
        elif k == "trend":  # Hz: relative, like f0
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
            m = ~np.isnan(r)
            assert np.max(np.abs(g[m] - r[m]) / r[m]) < 1e-4
        else:
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=k)


def test_distortion_score_of_silence():
    """On silence the dB mel is 0 up to rounding, and the score
    high / (total + 1e-6) divides two such roundings: the port's dB is
    exactly 0 and its score 0; the float64 oracle's dB is ~-7e-6 and its
    score 1.15, the JAX program's -3.7e-6 and 1.37 (ROADMAP Queue 3)."""
    y = np.zeros(30000, np.float32)
    got = run_analyze(y, TAUDIO, TCFG, financial=True, device="cpu")
    ref = run_analyze_ref(y, AUDIO, CFG, financial=True)
    assert (got["mel_db"] == 0.0).all()
    assert float(got["distortion_score"]) == 0.0
    assert np.abs(ref["mel_db"]).max() < 1e-5
    assert float(ref["distortion_score"]) > 1.0


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def analyses(clip):
    cache = {}

    def get(name):
        if name not in cache:
            y = clip(name)
            cache[name] = (
                JaxFinancial(sample_rate=SR, backend="device").analyze(y),
                AegisFinancialEngine(sample_rate=SR, device="cpu").analyze(y))
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_financial_engine_events_equal_jax(analyses, name):
    a_j, a_t = analyses(name)
    ev_j, info_j = JaxFinancial(sample_rate=SR, backend="device"
                                ).extract_events(a_j)
    ev_t, info_t = AegisFinancialEngine(sample_rate=SR, device="cpu"
                                        ).extract_events(a_t)
    assert ev_t
    assert_same_events(ev_t, ev_j)
    assert abs(info_t["threshold"] - info_j["threshold"]) <= 1e-4
    assert info_t["key_info"] == info_j["key_info"]


def test_audio_to_midi_financial_writes_midi(tmp_path, clip):
    out = str(tmp_path / "fin.mid")
    eng = AegisFinancialEngine(sample_rate=SR, device="cpu")
    assert eng.audio_to_midi_financial(clip("ks"), out) == out
    assert {40, 45, 50} <= {n["note"] for n in midi_to_notes(out)}
    silent = np.zeros(SR, np.float32)
    assert eng.audio_to_midi_financial(silent, str(tmp_path / "s.mid")) is None
