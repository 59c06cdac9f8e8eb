"""The polyphonic stack of the port against the JAX package, on the CPU.

The same inputs, made from a NumPy seed, go through the JAX function and its
PyTorch counterpart: the pseudo-CQT and chroma, the voice peel (also against
the port's own NumPy oracle), the roll / confidence scatter, the f16 plane
packing, the packed fused program for both transports, the tiled program on
a one-device mesh, the `AegisPolyEngine` facade's events, the folder sweep
and the `poly` / `tabs` commands.  One JAX analysis a clip is shared through
a module fixture.  Tolerances are stated at each comparison.
"""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from aegis_tpu.core import cqt as jcqt
from aegis_tpu.core import poly as jpoly
from aegis_tpu.core.analyze import quantize_pcm8 as j_quantize_pcm8
from aegis_tpu.core.analyze import quantize_pcm16 as j_quantize_pcm16
from aegis_tpu.engine import turbo as jturbo
from aegis_tpu.engine.poly import AegisPolyEngine as JaxPolyEngine
from aegis_tpu.engine.poly import transcribe_folder as jax_transcribe_folder
from aegis_tpu.config import TurboConfig as JaxTurboConfig

from aegis_tpu_torch.config import TurboConfig
from aegis_tpu_torch.core import cqt as tcqt
from aegis_tpu_torch.core import poly as tpoly
from aegis_tpu_torch.core.analyze import (pad_to_bucket, quantize_pcm8,
                                          quantize_pcm16)
from aegis_tpu_torch.core.tables import poly_tables
from aegis_tpu_torch.engine import turbo as tturbo
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.engine.poly import (AegisPolyEngine,
                                         dispatch_analyze_poly,
                                         fetch_analyze_poly)
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.ref.poly_ref import (peel_voices_ref,
                                          roll_and_confidence_ref)
from aegis_tpu_torch.tools.signal_gen import (generate_chord_progression,
                                              karplus_strong)
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

CPU = torch.device("cpu")
NBINS = 84
# the one-device mesh the port is compared on: on the suite's 8-device CPU
# mesh the JAX package pads the tile count to a multiple of 8
ONE = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "time"))

CLIPS = [(22050, 1), (22050, 3), (22050, 7), (44100, 7)]


def window_of(sr):
    scale = max(1, round(sr / 22050))
    return 2048 * scale, 512 * scale


def tables_of(sr):
    return poly_tables(sr, window_of(sr)[0], NBINS, 12, 128, CPU)


@pytest.fixture(scope="module")
def clip():
    """(y, truth, JAX analysis, JAX events) of a chord clip, computed once."""
    cache = {}

    def get(sr, seed):
        if (sr, seed) not in cache:
            y, truth = generate_chord_progression(seed, sr)
            eng = JaxPolyEngine(sample_rate=sr)
            analysis = eng.analyze(y)
            analysis["cqt_mag"] = np.asarray(analysis["cqt_mag"])
            cache[sr, seed] = (y, truth, analysis,
                               eng.extract_events(analysis))
        return cache[sr, seed]
    return get


def assert_same_events(got, want, float_tol=1e-5):
    """Dict for dict: every discrete field equal, float fields to
    ``float_tol`` (relative, with the same absolute floor)."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=float_tol,
                                             abs=float_tol), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


def discrete(events):
    return [{k: v for k, v in e.items() if not isinstance(v, float)}
            for e in events]


# ------------------------------------------------------------------ the CQT

@pytest.mark.parametrize("sr", [22050, 44100])
def test_pseudo_cqt_and_chroma_match_jax(sr):
    """rtol 1e-4 of each row's peak (the DFT matmuls sum in another
    order)."""
    n_fft, hop = window_of(sr)
    y = generate_chord_progression(7, sr)[0][: sr]
    tb = tables_of(sr)
    got = tcqt.pseudo_cqt_t(torch.from_numpy(y), hop, tb).numpy()
    want = np.asarray(jcqt.pseudo_cqt_t(jnp.asarray(y), sr, n_fft, hop,
                                        NBINS, 12))
    assert got.shape == want.shape == (1 + len(y) // hop, NBINS)
    peak = want.max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-4 * peak + 1e-12)
    ch = tcqt.chroma_cqt_t(torch.from_numpy(y), hop, tb).numpy()
    ch_j = np.asarray(jcqt.chroma_cqt_t(jnp.asarray(y), sr, n_fft, hop,
                                        NBINS, 12))
    assert ch.shape == (got.shape[0], 12)
    np.testing.assert_allclose(ch, ch_j, atol=1e-4)
    assert tcqt.CQT_FMIN_MIDI == jcqt.CQT_FMIN_MIDI


def test_comb_matrices_equal_the_originals():
    for n_bins, bpo in ((84, 12), (60, 12), (96, 24)):
        np.testing.assert_array_equal(
            tpoly.harmonic_suppression_matrix(n_bins, bpo),
            jpoly.harmonic_suppression_matrix(n_bins, bpo))
        np.testing.assert_array_equal(
            tpoly.harmonic_subtraction_matrix(n_bins, bpo),
            jpoly.harmonic_subtraction_matrix(n_bins, bpo))
    assert tpoly.COMB_NORM_FLOOR == jpoly.COMB_NORM_FLOOR
    tb = tables_of(22050)
    np.testing.assert_array_equal(tb.supp.numpy(),
                                  jpoly.harmonic_suppression_matrix(84))
    np.testing.assert_array_equal(tb.sub.numpy(),
                                  jpoly.harmonic_subtraction_matrix(84))


# ----------------------------------------------------------------- the peel

def _peel_all(cqt):
    supp = jpoly.harmonic_suppression_matrix(NBINS)
    sub = jpoly.harmonic_subtraction_matrix(NBINS)
    b_t, s_t = tpoly.peel_voices(torch.from_numpy(cqt),
                                 torch.from_numpy(supp),
                                 torch.from_numpy(sub))
    b_j, s_j = jpoly.peel_voices(jnp.asarray(cqt), jnp.asarray(supp),
                                 jnp.asarray(sub))
    b_r, s_r = peel_voices_ref(cqt, supp, sub)
    return (b_t.numpy(), s_t.numpy()), (np.asarray(b_j), np.asarray(s_j)), \
        (b_r, s_r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peel_on_random_power_equals_jax_and_oracle(seed):
    """Picks equal; saliences rtol 2e-4, atol 1e-5."""
    rng = np.random.default_rng(seed)
    cqt = (rng.random((64, NBINS)) ** 3).astype(np.float32)
    (b_t, s_t), (b_j, s_j), (b_r, s_r) = _peel_all(cqt)
    assert b_t.dtype == np.int32 and b_t.shape == (64, 6)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(b_t, b_r)
    np.testing.assert_allclose(s_t, s_j, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(s_t, s_r, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("sr", [22050, 44100])
def test_peel_on_the_chord_clip(sr, clip):
    """On real plucked-chord CQT a genuine tie may break differently: picks
    agree on >= 0.999 of entries, saliences rtol 5e-4, atol 1e-4 (the JAX
    package's own limits against its oracle)."""
    y = clip(sr, 7)[0]
    n_fft, hop = window_of(sr)
    cqt = np.array(jcqt.pseudo_cqt_t(jnp.asarray(y), sr, n_fft, hop,
                                     NBINS, 12))
    (b_t, s_t), (b_j, s_j), (b_r, s_r) = _peel_all(cqt)
    for b, s in ((b_j, s_j), (b_r, s_r)):
        assert float(np.mean(b_t == b)) >= 0.999
        same = (b_t == b).all(axis=1)
        np.testing.assert_allclose(s_t[same], s[same], rtol=5e-4, atol=1e-4)


def test_peel_takes_a_leading_batch():
    rng = np.random.default_rng(5)
    cqt = torch.from_numpy((rng.random((3, 2, 20, NBINS)) ** 3)
                           .astype(np.float32))
    tb = tables_of(22050)
    b, s = tpoly.peel_voices(cqt, tb.supp, tb.sub, 4)
    assert b.shape == s.shape == (3, 2, 20, 4)
    b1, s1 = tpoly.peel_voices(cqt[2, 1], tb.supp, tb.sub, 4)
    np.testing.assert_array_equal(b[2, 1].numpy(), b1.numpy())
    np.testing.assert_allclose(s[2, 1].numpy(), s1.numpy(), rtol=1e-6)
    # sub=None builds the default subtraction matrix
    b2, _ = tpoly.peel_voices(cqt[2, 1], tb.supp, None, 4)
    np.testing.assert_array_equal(b2.numpy(), b1.numpy())


# ------------------------------------------------------ roll and confidence

def _voices(seed, T=50, V=6):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, NBINS, (T, V)).astype(np.int32)
    bins[::3, 1] = bins[::3, 0]          # two voices on one MIDI bin
    sals = (rng.random((T, V)) ** 2).astype(np.float32)
    sals[5] = 0.0                        # a silent frame
    return bins, sals


@pytest.mark.parametrize("global_peak", [None, 2.5])
def test_roll_and_confidence_matches_jax_and_oracle(global_peak):
    """Roll equal, planes rtol 1e-5."""
    bins, sals = _voices(3)
    gp_t = None if global_peak is None else torch.tensor(global_peak)
    gp_j = None if global_peak is None else jnp.float32(global_peak)
    got = [a.numpy() for a in tpoly.roll_and_confidence(
        torch.from_numpy(bins), torch.from_numpy(sals), global_peak=gp_t)]
    want = [np.asarray(a) for a in jpoly.roll_and_confidence(
        jnp.asarray(bins), jnp.asarray(sals), global_peak=gp_j)]
    ref = roll_and_confidence_ref(bins, sals, global_peak=global_peak)
    assert got[0].dtype == bool and got[0].shape == (50, 128)
    for other in (want, ref):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_allclose(got[1], other[1], rtol=1e-5)
        np.testing.assert_allclose(got[2], other[2], rtol=1e-5)
    np.testing.assert_array_equal(
        tpoly.voices_to_piano_roll(torch.from_numpy(bins),
                                   torch.from_numpy(sals)).numpy(), want[0])
    np.testing.assert_allclose(tpoly.reconstruct_confidence(got[2]),
                               jpoly.reconstruct_confidence(want[2]),
                               rtol=1e-5)


def test_roll_and_confidence_takes_a_leading_batch():
    b0, s0 = _voices(1)
    b1, s1 = _voices(2)
    roll, conf, sal = tpoly.roll_and_confidence(
        torch.from_numpy(np.stack([b0, b1])),
        torch.from_numpy(np.stack([s0, s1])))
    gp = torch.tensor(max(s0.max(), s1.max()))
    for i, (b, s) in enumerate(((b0, s0), (b1, s1))):
        r1, c1, a1 = tpoly.roll_and_confidence(
            torch.from_numpy(b), torch.from_numpy(s), global_peak=gp)
        np.testing.assert_array_equal(roll[i].numpy(), r1.numpy())
        np.testing.assert_array_equal(conf[i].numpy(), c1.numpy())
        np.testing.assert_array_equal(sal[i].numpy(), a1.numpy())


def test_every_cqt_bin_lands_on_its_midi_note():
    """12 * bin / bins_per_octave is a product with float32(1/12) in XLA;
    it is followed by a round, and every bin 0..83 lands on 24 + bin in
    both packages and the oracle."""
    bins = np.arange(NBINS, dtype=np.int32)[:, None]
    sals = np.ones((NBINS, 1), np.float32)
    want = np.zeros((NBINS, 128), bool)
    want[np.arange(NBINS), 24 + np.arange(NBINS)] = True
    np.testing.assert_array_equal(
        tpoly.roll_and_confidence(torch.from_numpy(bins),
                                  torch.from_numpy(sals))[0].numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jpoly.roll_and_confidence(jnp.asarray(bins),
                                             jnp.asarray(sals))[0]), want)
    np.testing.assert_array_equal(roll_and_confidence_ref(bins, sals)[0],
                                  want)


# ------------------------------------------------------------ the f16 plane

@pytest.mark.parametrize("n_bins", [84, 7])
def test_pack_cqt_f16_bytes(n_bins):
    """Bytes, not values: a packed column may read as a NaN pattern."""
    rng = np.random.default_rng(4)
    mag = (rng.random((2, 9, n_bins)) * 70000 ** rng.random((2, 9, n_bins))
           ).astype(np.float32)      # some values past the f16 range
    got = tpoly.pack_cqt_f16(torch.from_numpy(mag)).numpy()
    want = np.asarray(jpoly.pack_cqt_f16(jnp.asarray(mag)))
    assert got.shape == want.shape == (2, 9, tpoly.cqt_plane_cols(n_bins))
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert tpoly.cqt_plane_cols(n_bins) == jpoly.cqt_plane_cols(n_bins)
    back = tpoly.unpack_cqt_f16(got[0], n_bins)
    np.testing.assert_array_equal(back, jpoly.unpack_cqt_f16(want[0], n_bins))
    np.testing.assert_array_equal(back,
                                  mag[0].astype(np.float16).astype(np.float32))


# -------------------------------------------------------- the fused program

@pytest.mark.parametrize("transport", ["int8", "int16"])
def test_packed_program_matches_jax(transport, clip):
    """Bins equal; saliences rtol 5e-4 / atol 1e-4; rms 1e-6; the onset
    envelope 1e-3 (dB near the -80 floor); the f16 plane within one f16
    step of the JAX plane."""
    sr = 22050
    y = clip(sr, 7)[0]
    n_fft, hop = window_of(sr)
    y_pad = pad_to_bucket(y)
    if transport == "int8":
        q, s = quantize_pcm8(y_pad)
        qj, sj = j_quantize_pcm8(y_pad)
        np.testing.assert_array_equal(s, sj)
        args_t = (torch.from_numpy(q), torch.from_numpy(s))
        args_j = (jnp.asarray(qj), jnp.asarray(sj))
    else:
        q, s = quantize_pcm16(y_pad)
        qj, sj = j_quantize_pcm16(y_pad)
        assert s == sj
        args_t = (torch.from_numpy(q), torch.tensor(s, dtype=torch.float32))
        args_j = (jnp.asarray(qj), jnp.float32(sj))
    np.testing.assert_array_equal(q, qj)
    got = tpoly.analyze_poly_program_packed(*args_t, hop, tables_of(sr)).numpy()
    want = np.asarray(jpoly.analyze_poly_program_packed(
        *args_j, sr, n_fft, hop, NBINS, 12, 6))
    assert got.shape == want.shape == (1 + len(y_pad) // hop, 14 + 42)
    V = 6
    assert float(np.mean(got[:, :V] == want[:, :V])) >= 0.999
    same = (got[:, :V] == want[:, :V]).all(axis=1)
    np.testing.assert_allclose(got[same, V:2 * V], want[same, V:2 * V],
                               rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, 2 * V], want[:, 2 * V], atol=1e-6)
    np.testing.assert_allclose(got[:, 2 * V + 1], want[:, 2 * V + 1],
                               atol=1e-3)
    a = tpoly.unpack_cqt_f16(got[:, 2 * V + 2:], NBINS)
    b = jpoly.unpack_cqt_f16(want[:, 2 * V + 2:], NBINS)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-4)
    # the host twin of the layout is the same function in both packages
    u_t = tpoly.unpack_poly_voices(want)
    u_j = jpoly.unpack_poly_voices(want)
    assert u_t.keys() == u_j.keys()
    for k in u_j:
        np.testing.assert_array_equal(u_t[k], u_j[k])
    assert "cqt_mag" not in tpoly.unpack_poly_voices(want[:, :2 * V + 2])


def test_plane_program_matches_jax(clip):
    """analyze_poly_program (the planes built on the device): roll equal on
    >= 0.9999 of cells, planes to 1e-4."""
    sr = 22050
    y = clip(sr, 3)[0]
    n_fft, hop = window_of(sr)
    got = tpoly.analyze_poly_program(torch.from_numpy(y), hop, tables_of(sr))
    want = jpoly.analyze_poly_program(jnp.asarray(y), sr, n_fft, hop)
    assert got.keys() == want.keys()
    assert float(np.mean(got["roll"].numpy() == np.asarray(want["roll"]))) \
        >= 0.9999
    for k in ("confidence", "salience", "rms", "cqt_mag"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["onset_env"].numpy(),
                               np.asarray(want["onset_env"]), atol=1e-3)


# --------------------------------------------------------------- the facade

@pytest.mark.parametrize("sr,seed", CLIPS)
def test_events_equal_jax_engine(sr, seed, clip):
    """The port's events, dict for dict, are the JAX engine's (float fields
    to 1e-5), and score truth F1 1.0 where the JAX engine does."""
    y, truth, j_analysis, j_events = clip(sr, seed)
    eng = AegisPolyEngine(sample_rate=sr, device="cpu")
    assert (eng.n_fft, eng.hop_length) == window_of(sr)
    analysis = eng.analyze(y)
    assert set(analysis) == {"roll", "confidence", "salience", "rms",
                             "onset_env", "cqt_mag", "y"}
    np.testing.assert_array_equal(analysis["roll"], j_analysis["roll"])
    events = eng.extract_events(analysis)
    assert events
    assert_same_events(events, j_events)
    f1 = [note_event_f1(truth, events_to_seconds(ev, sr, eng.hop_length),
                        onset_tolerance=0.06)["f1"]
          for ev in (events, j_events)]
    assert f1[0] == f1[1]
    if sr == 22050:
        assert f1[0] == 1.0


def test_extraction_options_and_midi(clip, tmp_path):
    """use_onsets=False, a cached analysis without the CQT plane, the int16
    transport, label_chords, generate_tabs and the MIDI bytes: each equal to
    the JAX engine's on the same analysis."""
    sr = 22050
    y, _, j_analysis, j_events = clip(sr, 7)
    jeng = JaxPolyEngine(sample_rate=sr)
    eng = AegisPolyEngine(sample_rate=sr, device="cpu")
    for kw in ({"use_onsets": False}, {"confidence_threshold": 0.8},
               {"sustain_ms": 60.0, "snap_back_ms": 100.0}):
        assert eng.extract_events(j_analysis, **kw) == \
            jeng.extract_events(j_analysis, **kw), kw
    no_plane = {k: v for k, v in j_analysis.items() if k != "cqt_mag"}
    assert eng.extract_events(no_plane) == jeng.extract_events(no_plane)
    assert eng.label_chords(j_events) == jeng.label_chords(j_events)
    assert eng.generate_tabs(j_events) == jeng.generate_tabs(j_events)
    a, b = io.BytesIO(), io.BytesIO()
    eng.extract_events(j_analysis, a, bpm="auto")
    jeng.extract_events(j_analysis, b, bpm="auto")
    assert a.getvalue() == b.getvalue() and midi_to_notes(a.getvalue())
    ev16 = eng.extract_events(eng.analyze(y, transport="int16"))
    jev16 = jeng.extract_events(jeng.analyze(y, transport="int16"))
    assert_same_events(ev16, jev16)
    assert eng.analyze(np.zeros(0, np.float32)) is None
    with pytest.raises(ValueError, match="transport"):
        eng.analyze(y, transport="float32")


def test_audio_to_midi_from_a_file(clip, tmp_path):
    sr = 22050
    y, _, _, j_events = clip(sr, 1)
    wav = str(tmp_path / "c.wav")
    write_wav(wav, y, sr)
    eng = AegisPolyEngine(sample_rate=sr, device="cpu")
    mid = str(tmp_path / "c.mid")
    analysis = eng.audio_to_midi(wav, mid)
    assert analysis is not None and os.path.getsize(mid) > 0
    with open(mid, "rb") as f:
        notes = midi_to_notes(f.read())
    assert len(notes) == len(j_events)
    half = eng.analyze(wav, start_time=1.0, end_time=3.0)
    assert half["roll"].shape[0] == 1 + (2 * sr) // 512


# ----------------------------------------------------------------- the tiles

def _staggered_chord(sr=22050):
    rng = np.random.default_rng(7)
    n = int(sr * 2.5)
    y = np.zeros(n, np.float32)
    for i, m in enumerate((60, 64, 67, 55)):
        f = 440.0 * 2 ** ((m - 69) / 12)
        s = int(i * 0.4 * sr)
        p = karplus_strong(f, 1.2, sr, rng=rng)
        y[s: s + len(p)] += p[: n - s]
    return (y / max(np.max(np.abs(y)), 1e-9) * 0.8).astype(np.float32)


@pytest.mark.parametrize("sr,tile,halo", [(22050, 32, 8), (22050, 24, 4),
                                          (44100, 48, 8)])
def test_tiles_match_fused_and_jax(sr, tile, halo, clip):
    """Against the JAX tiled program on a one-device mesh: roll equal on
    >= 0.9999 of cells, rms 1e-6, onset envelope 1e-3, events equal in
    every discrete field.  Against the port's fused program with the same
    int16 transport (the tiles upload int16): the JAX package's own limits,
    roll >= 0.9999, rms atol 1e-5 / rtol 1e-4, onset 1e-3, event F1 1.0."""
    y = _staggered_chord() if sr == 22050 else clip(sr, 7)[0]
    n_fft, hop = window_of(sr)
    eng = AegisPolyEngine(sample_rate=sr, transport="int16", device="cpu")
    out = eng.analyze(y, turbo_mode="tiles",
                      turbo_config=TurboConfig(tile_frames=tile,
                                               halo_frames=halo))
    ref = jturbo.run_analyze_poly_turbo(
        y, sr=sr, n_fft=n_fft, hop_length=hop,
        turbo=JaxTurboConfig(tile_frames=tile, halo_frames=halo), mesh=ONE)
    fused = eng.analyze(y)
    T = 1 + len(y) // hop
    assert out["roll"].shape == (T, 128) and out["cqt_mag"].shape == (T, 84)
    for other, rms_tol in ((ref, dict(atol=1e-6)),
                           (fused, dict(atol=1e-5, rtol=1e-4))):
        assert (out["roll"] == other["roll"]).mean() > 0.9999
        np.testing.assert_allclose(out["rms"], other["rms"], **rms_tol)
        np.testing.assert_allclose(out["onset_env"], other["onset_env"],
                                   atol=1e-3)
    ev = eng.extract_events(out)
    assert ev
    assert discrete(ev) == discrete(eng.extract_events(
        {k: np.asarray(v) for k, v in ref.items()}))
    m = note_event_f1(
        events_to_seconds(eng.extract_events(fused), sr, hop),
        events_to_seconds(ev, sr, hop))
    assert m["f1"] == 1.0, m


def test_tiles_batch_keeps_each_track_its_own_reference():
    """The (loud, quiet) batch: per-track scalars stay per-track, and the
    batch equals the JAX tiled program's on a one-device mesh."""
    sr = 22050
    t = np.arange(sr) / sr
    loud = (0.8 * np.sin(2 * np.pi * 261.63 * t)).astype(np.float32)
    quiet = (0.01 * np.sin(2 * np.pi * 392.0 * t)).astype(np.float32)
    ys = np.stack([loud, quiet])
    out = tturbo.run_analyze_poly_turbo(
        ys, sr=sr, turbo=TurboConfig(tile_frames=16, halo_frames=4),
        device="cpu")
    ref = jturbo.run_analyze_poly_turbo(
        ys, sr=sr, turbo=JaxTurboConfig(tile_frames=16, halo_frames=4),
        mesh=ONE)
    assert out["roll"].shape == (2, 44, 128)
    assert out["roll"][0][:, 60].mean() > 0.5   # C4
    assert out["roll"][1][:, 67].mean() > 0.5   # G4
    assert (out["roll"] == ref["roll"]).mean() > 0.9999
    np.testing.assert_allclose(out["rms"], ref["rms"], atol=1e-6)
    np.testing.assert_allclose(out["onset_env"], ref["onset_env"], atol=1e-3)
    assert (out["onset_env"][:, 0] == 0).all()
    # one track alone gives its rows of the batch
    solo = tturbo.run_analyze_poly_turbo(
        quiet, sr=sr, turbo=TurboConfig(tile_frames=16, halo_frames=4),
        device="cpu")
    np.testing.assert_array_equal(solo["roll"], out["roll"][1])
    np.testing.assert_allclose(solo["onset_env"], out["onset_env"][1],
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["stream", "auto"])
def test_stream_and_auto_run_the_tiles(mode, clip):
    """No slab-streamed poly mode exists: "stream", and "auto" past the
    threshold, run the tiled program."""
    y = clip(22050, 1)[0]
    eng = AegisPolyEngine(sample_rate=22050, device="cpu")
    tc = TurboConfig(tile_frames=32, halo_frames=8)
    tiles = eng.analyze(y, turbo_mode="tiles", turbo_config=tc)
    got = eng.analyze(y, turbo_mode=mode, turbo_config=tc,
                      stream_threshold_s=1.0)
    for k in tiles:
        np.testing.assert_array_equal(got[k], tiles[k])
    if mode == "auto":   # under the threshold: the fused program
        fused = eng.analyze(y, turbo_mode="auto")
        np.testing.assert_array_equal(fused["roll"], eng.analyze(y)["roll"])


# ---------------------------------------------------------------- the folder

def test_folder_midi_equals_the_facade_and_jax(clip, tmp_path):
    sr = 22050
    src = tmp_path / "in"
    src.mkdir()
    ys = {"a": clip(sr, 1)[0], "b": clip(sr, 7)[0][: 3 * sr]}
    for name, y in ys.items():
        write_wav(str(src / f"{name}.wav"), y, sr)
    got = transcribe_folder(str(src), str(tmp_path / "t"), sample_rate=sr,
                            engine="poly", device="cpu")
    want = jax_transcribe_folder(str(src), str(tmp_path / "j"),
                                 sample_rate=sr, engine="poly", mesh=ONE)
    assert [(os.path.basename(w), n) for w, _, n in got] == \
        [(os.path.basename(w), n) for w, _, n in want]
    eng = AegisPolyEngine(sample_rate=sr, device="cpu")
    for (wav, mid, n), (_, jmid, _) in zip(got, want):
        assert n > 0
        with open(mid, "rb") as f:
            data = f.read()
        facade = io.BytesIO()
        eng.audio_to_midi(wav, facade)
        assert data == facade.getvalue()
        with open(jmid, "rb") as f:
            assert data == f.read()
    with pytest.raises(ValueError, match="pitch stack"):
        transcribe_folder(str(src), engine="poly", pitch_backend="neural",
                          device="cpu")


def test_dispatch_returns_a_handle_and_fetch_unpacks(clip):
    sr = 22050
    y = clip(sr, 3)[0]
    handles = [dispatch_analyze_poly(y[: n], sr, device="cpu")
               for n in (len(y), 2 * sr)]
    for h, n in zip(handles, (len(y), 2 * sr)):
        buf, true_frames, V, bpo = h
        assert isinstance(buf, torch.Tensor) and (V, bpo) == (6, 12)
        assert true_frames == 1 + n // 512 and buf.shape[0] >= true_frames
        out = fetch_analyze_poly(h)
        assert out["roll"].shape == (true_frames, 128)
        assert out["cqt_mag"].shape == (true_frames, 84)


# ------------------------------------------------------------------- the CLI

def _run_cli(argv, capsys):
    from aegis_tpu_torch.__main__ import main
    rc = main(argv)
    return rc, capsys.readouterr()


def test_cli_poly(clip, tmp_path, capsys):
    sr = 22050
    y, _, _, j_events = clip(sr, 7)
    wav = str(tmp_path / "c.wav")
    write_wav(wav, y, sr)
    rc, cap = _run_cli(["poly", wav, "--device", "cpu"], capsys)
    assert rc == 0 and f"{len(j_events)} events" in cap.out
    with open(str(tmp_path / "c.mid"), "rb") as f:
        fused = f.read()
    assert len(midi_to_notes(fused)) == len(j_events)
    rc, cap = _run_cli(["poly", wav, str(tmp_path / "t.mid"), "--turbo",
                        "tiles", "--device", "cpu", "--bpm", "auto"], capsys)
    assert rc == 0 and os.path.getsize(str(tmp_path / "t.mid")) > 0


@pytest.mark.parametrize("engine", ["poly", "v1"])
def test_cli_tabs(engine, clip, tmp_path, capsys):
    sr = 22050
    y, _, _, j_events = clip(sr, 7)
    wav = str(tmp_path / "c.wav")
    write_wav(wav, y, sr)
    mid = str(tmp_path / "tab.mid")
    rc, cap = _run_cli(["tabs", wav, mid, "--engine", engine, "--sr",
                        str(sr), "--device", "cpu"], capsys)
    assert rc == 0 and os.path.getsize(mid) > 0
    lines = cap.out.splitlines()
    assert sum(1 for ln in lines if ln[:2] in ("e|", "B|", "G|", "D|",
                                               "A|", "E|")) >= 6
    if engine == "poly":
        from aegis_tpu.midi.tabs import render_ascii_tab
        jeng = JaxPolyEngine(sample_rate=sr)
        chords = jeng.label_chords(j_events)
        assert lines[0] == "  ".join(f"{c['time_sec']:.2f}s {c['name']}"
                                     for c in chords)
        assert render_ascii_tab(jeng.generate_tabs(j_events)) in cap.out
        rc, cap = _run_cli(["tabs", wav, "--engine", "poly",
                            "--pitch-backend", "neural", "--device", "cpu"],
                           capsys)
        assert rc == 2


def test_cli_batch_poly(clip, tmp_path, capsys):
    sr = 22050
    src = tmp_path / "in"
    src.mkdir()
    write_wav(str(src / "a.wav"), clip(sr, 3)[0], sr)
    rc, cap = _run_cli(["batch", str(src), "--engine", "poly", "--device",
                        "cpu"], capsys)
    assert rc == 0 and "a.mid" in cap.out
    assert os.path.getsize(str(src / "a.mid")) > 0
