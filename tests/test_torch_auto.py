"""The polyphony-aware router of the port (``engine/auto.py``) against the
JAX package's, on the CPU.

The same clips (``tools/signal_gen.py``: mixed chords + 85 ms runs, chord
progressions, the bench track) go through ``analyze_auto_program_packed``
of both packages on the same int8 upload, through both engines'
``extract_events``, and the copied routing passes run on the same event
lists.  Then the accuracy floors of ``tests/test_auto.py``, the folder
sweep against the facade, and the ``auto`` / ``batch --engine auto``
commands.  One analysis a clip and package is shared through a module
fixture.  Every comparison states its tolerance.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aegis_tpu.core.analyze import quantize_pcm8 as j_quantize_pcm8
from aegis_tpu.engine import auto as jauto
from aegis_tpu.tools.signal_gen import (generate_bench_track,
                                        generate_chord_progression,
                                        generate_mixed_clip)

from aegis_tpu_torch.config import PyinConfig
from aegis_tpu_torch.core.analyze import bucket_length, quantize_pcm8
from aegis_tpu_torch.core.tables import poly_tables, tables_from_numpy
from aegis_tpu_torch.engine import auto as tauto
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CLIPS = {
    "mixed1_22050": (22050, lambda: generate_mixed_clip(1)),
    "chord3_22050": (22050, lambda: generate_chord_progression(3, sr=22050)),
    "mixed1_44100": (44100, lambda: generate_mixed_clip(1, sr=44100)),
}
V = 6
N_V1 = 6


@pytest.fixture(scope="module")
def engines():
    return {sr: (jauto.AegisAutoEngine(sample_rate=sr),
                 tauto.AegisAutoEngine(sample_rate=sr, device="cpu"))
            for sr in (22050, 44100)}


@pytest.fixture(scope="module")
def analyses(engines):
    """(clip, truth, JAX analysis, port analysis) per clip, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            sr, make = CLIPS[name]
            y, truth = make()
            jeng, teng = engines[sr]
            cache[name] = (y, truth, jeng.analyze(y), teng.analyze(y))
        return cache[name]
    return get


def f0_bins(f0):
    """The pitch bin each f0 came from (NaN where unvoiced): the discrete
    content of the f0 column, which both packages decode through bin
    tables that differ in the last bit of a few bins."""
    cfg = PyinConfig()
    with np.errstate(invalid="ignore"):
        return np.round(12 * cfg.n_bins_per_semitone
                        * np.log2(np.asarray(f0, np.float64) / cfg.fmin))


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_packed_program_matches_jax(engines, name):
    """Both programs on the same int8 upload.  Discrete columns equal: f0
    bins, voiced, rake, the peel's bins.  Float columns within today's row
    tolerances: f0 1e-6 relative, voiced_probs 1e-6, rms 3e-8, onset
    envelopes 5e-5, saliences 2e-6 relative to the peak, the f16 CQT plane
    within one f16 step (rtol 2e-3)."""
    sr, make = CLIPS[name]
    y, _ = make()
    jeng, teng = engines[sr]
    n = bucket_length(len(y))
    y_pad = np.pad(np.asarray(y, np.float32), (0, n - len(y)))
    y8, s = quantize_pcm8(y_pad)
    j8, js = j_quantize_pcm8(y_pad)
    np.testing.assert_array_equal(y8, j8)
    np.testing.assert_array_equal(s, js)
    ref = np.asarray(jauto.analyze_auto_program_packed(
        jnp.asarray(j8), jnp.asarray(js), jnp.float32(0.6), jeng.audio,
        jeng.pyin_cfg, jeng.n_fft_poly, jeng.n_bins, jeng.bins_per_octave,
        jeng.max_voices))
    got = tauto.analyze_auto_program_packed(
        torch.from_numpy(y8), torch.from_numpy(s), 0.6, teng.audio,
        teng.pyin_cfg, tables_from_numpy(teng.audio, teng.pyin_cfg, CPU),
        poly_tables(sr, teng.n_fft_poly, 84, 12, 128, CPU), V).numpy()
    assert got.shape == ref.shape
    assert got.shape[1] == N_V1 + 2 * V + 2 + 42
    f0_g, f0_r = got[:, 0], ref[:, 0]
    np.testing.assert_array_equal(np.isnan(f0_g), np.isnan(f0_r))
    np.testing.assert_array_equal(f0_bins(f0_g), f0_bins(f0_r))
    m = ~np.isnan(f0_r)
    np.testing.assert_allclose(f0_g[m], f0_r[m], rtol=1e-6)
    for col in (1, 4):                      # voiced, rake
        np.testing.assert_array_equal(got[:, col], ref[:, col])
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=0, atol=3e-8)
    np.testing.assert_allclose(got[:, 5], ref[:, 5], rtol=0, atol=5e-5)
    p_g, p_r = got[:, N_V1:], ref[:, N_V1:]
    np.testing.assert_array_equal(p_g[:, :V], p_r[:, :V])   # peel bins
    peak = p_r[:, V:2 * V].max()
    np.testing.assert_allclose(p_g[:, V:2 * V], p_r[:, V:2 * V], rtol=0,
                               atol=2e-6 * peak)
    np.testing.assert_allclose(p_g[:, 2 * V], p_r[:, 2 * V], rtol=0, atol=3e-8)
    np.testing.assert_allclose(p_g[:, 2 * V + 1], p_r[:, 2 * V + 1], rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(
        tauto.P.unpack_cqt_f16(p_g[:, 2 * V + 2:], 84),
        tauto.P.unpack_cqt_f16(p_r[:, 2 * V + 2:], 84), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_events_match_jax(engines, analyses, name):
    """extract_events dict for dict: note, start, end, source and every
    other discrete field equal; float fields within 2e-6."""
    sr = CLIPS[name][0]
    _, _, a_j, a_t = analyses(name)
    jeng, teng = engines[sr]
    ev_j, ev_t = jeng.extract_events(a_j), teng.extract_events(a_t)
    assert ev_t and len(ev_t) == len(ev_j)
    for g, r in zip(ev_t, ev_j):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 2e-6, (k, g, r)
            else:
                assert g[k] == r[k], (k, g, r)
    assert {e["source"] for e in ev_t} <= {"v1", "poly"}


def mk(n, s, e, **kw):
    return {"note": n, "start": s, "end": e, "salience": 1.0, **kw}


REGION_CASES = {
    # tests/test_auto.py's constructed router physics
    "v1_shadow_ghosts": ([mk(62, 12, 40), mk(69, 12, 38), mk(83, 12, 36)],
                         80, [mk(50, 10, 60)]),
    "rim_pair": ([mk(44, 12, 40), mk(47, 12, 40)], 80, [mk(47, 10, 60)]),
    "triad_with_v1_lock": ([mk(48, 12, 40), mk(52, 12, 40), mk(55, 12, 40)],
                           80, [mk(55, 10, 60)]),
    "octave_pair": ([mk(47, 12, 40), mk(59, 12, 40, recovered_octave=True)],
                    80, [mk(47, 10, 60)]),
    "strum": ([mk(48, 10, 40), mk(55, 10, 38)], 60, None),
    "offset_overlap": ([mk(48, 10, 40), mk(55, 25, 50)], 60, None),
    "short_cluster": ([mk(48, 10, 14), mk(55, 10, 13)], 60, None),
    "run_demotion": ([mk(48, 10, 30), mk(55, 10, 30)], 60,
                     [mk(50, 12, 15), mk(53, 17, 20), mk(57, 22, 25)]),
}


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_polyphony_regions_copy_equals_the_original(case):
    poly, T, v1 = REGION_CASES[case]
    np.testing.assert_array_equal(
        tauto.polyphony_regions(poly, T, v1_events=v1),
        jauto.polyphony_regions(poly, T, v1_events=v1))


def test_route_events_copy_equals_the_original():
    """tests/test_auto.py's routing case, and with a short ghost on a
    stronger concurrent voice's partial line."""
    chordal = np.zeros(100, bool)
    chordal[10:50] = True
    poly = [mk(48, 10, 45), mk(55, 10, 45), mk(60, 60, 70), mk(30, 12, 40),
            dict(mk(67, 14, 20), salience=0.1)]
    v1 = [mk(48, 12, 44), mk(64, 60, 70), mk(62, 80, 90)]
    got = tauto.route_events(v1, poly, chordal)
    assert got == jauto.route_events(v1, poly, chordal)
    assert {(e["note"], e["source"]) for e in got} >= {(48, "poly"),
                                                       (64, "v1")}


def test_adjudicate_poly_stream_copy_equals_the_original(engines, analyses):
    """The physics re-adjudication on the JAX engine's own poly and v1
    events and CQT plane of the mixed clip: the same survivors."""
    jeng, teng = engines[22050]
    _, _, a_j, _ = analyses("mixed1_22050")
    from aegis_tpu.core.events import extract_events_v1
    from aegis_tpu.engine.poly import AegisPolyEngine

    poly_ev = AegisPolyEngine(sample_rate=22050).extract_events(a_j["poly"])
    v1 = a_j["v1"]
    v1_ev = extract_events_v1(
        v1["rake_mask"], np.nan_to_num(v1["f0"]), v1["voiced_flag"],
        v1["voiced_probs"], v1["rms"], 22050, 512,
        onset_env=v1["onset_env"], min_note_duration_ms=40.0)
    cqt = np.asarray(a_j["poly"]["cqt_mag"])
    got = tauto.adjudicate_poly_stream([dict(e) for e in poly_ev], v1_ev, cqt,
                                       22050, 512)
    ref = jauto.adjudicate_poly_stream([dict(e) for e in poly_ev], v1_ev, cqt,
                                       22050, 512)
    assert got == ref and 0 < len(got) <= len(poly_ev)


def truth_f1(eng, events, truth):
    return note_event_f1(truth, events_to_seconds(
        events, eng.sr, eng.hop_length))["f1"]


def test_accuracy_floors(engines, analyses):
    """tests/test_auto.py's floors: a pure chord progression >= 0.96, the
    mixed clip >= 0.95 at 44 100 Hz, and a dense monophonic line (20 s
    bench track) >= 0.97."""
    for name, floor in (("chord3_22050", 0.96), ("mixed1_44100", 0.95)):
        y, truth, _, a_t = analyses(name)
        teng = engines[CLIPS[name][0]][1]
        assert truth_f1(teng, teng.extract_events(a_t), truth) >= floor, name
    teng = engines[22050][1]
    y, truth = generate_bench_track(duration=20.0, sr=22050,
                                    return_truth=True)
    assert truth_f1(teng, teng.extract_events(teng.analyze(y)), truth) >= 0.97


def test_midi_bpm_and_tabs(engines, analyses):
    """bpm="auto" resolves before the MIDI encode (program 25); the tab is
    the chord-aware fingering."""
    teng = engines[22050][1]
    _, _, _, a_t = analyses("mixed1_22050")
    from aegis_tpu_torch.core.tempo import estimate_bpm
    from aegis_tpu_torch.midi.encode import events_to_midi
    from aegis_tpu_torch.midi.tabs import generate_tabs_chords

    buf, ref = io.BytesIO(), io.BytesIO()
    ev = teng.extract_events(a_t, output_mid=buf, bpm="auto")
    assert len(midi_to_notes(buf.getvalue())) == len(ev)
    events_to_midi(ev, 22050, 512, midi_program=25,
                   bpm=estimate_bpm(a_t["v1"], 22050, 512), output=ref)
    assert buf.getvalue() == ref.getvalue()
    tabs = teng.generate_tabs(ev)
    assert tabs and tabs == generate_tabs_chords(ev, 22050, 512)


def test_folder_equals_the_facade(engines, tmp_path):
    """transcribe_folder(engine="auto"), dispatch-ahead: each track's MIDI
    bytes equal the facade's; the neural backend is refused."""
    teng = engines[22050][1]
    for seed in (1, 2):
        write_wav(str(tmp_path / f"m{seed}.wav"), generate_mixed_clip(seed)[0],
                  22050)
    results = transcribe_folder(str(tmp_path), str(tmp_path / "mid"),
                                engine="auto", device="cpu")
    assert len(results) == 2
    for wav, mid, n in results:
        ref = io.BytesIO()
        assert n == len(teng.extract_events(teng.analyze(wav), ref)) > 0
        assert Path(mid).read_bytes() == ref.getvalue()
    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), engine="auto",
                          pitch_backend="neural", device="cpu")


def test_cli_auto_and_batch(tmp_path):
    """`auto` and `batch --engine auto` with --device cpu."""
    y, truth = generate_mixed_clip(2)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), y, 22050)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for args in (["auto", str(wav), str(tmp_path / "a.mid")],
                 ["batch", str(tmp_path), "--engine", "auto",
                  "--output-dir", str(tmp_path / "b")]):
        proc = subprocess.run([sys.executable, "-m", "aegis_tpu_torch", *args,
                               "--device", "cpu"], cwd=REPO,
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr
    a = (tmp_path / "a.mid").read_bytes()
    assert a == (tmp_path / "b" / "in.mid").read_bytes()
    est = [{"note": n["note"], "start": n["start"], "end": n["end"]}
           for n in midi_to_notes(a)]
    assert note_event_f1(truth, est)["f1"] >= 0.9
