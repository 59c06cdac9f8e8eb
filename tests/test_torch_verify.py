"""The port's self-verification loops (aegis_tpu_torch/verify/) and piano
roll (aegis_tpu_torch/viz/) on the CPU against the JAX package's, case for
case with tests/test_verify_loops.py, plus parity and the copied host
modules of this slice.

Tolerances: audio_similarity and note_slice_similarity 1e-5; auto-match the
same result dict with the score within 1e-5; the per-note optimizer the
same parameters and waveform per note with the score equal at its
4-decimal rounding; the technique verifier the same decisions;
reverse_analysis and learning_loop the same metrics and events (float event
fields within 1e-5).  Ties: where two picks' scores lie within the
tolerance of each other the test shows the tie instead of asserting the
pick.
"""

import os

import numpy as np
import pytest

from aegis_tpu.engine.engine import AegisEngine as JaxEngine
from aegis_tpu.verify import auto_match as ja
from aegis_tpu.verify import effect_loop as jl
from aegis_tpu.verify import per_note as jp
from aegis_tpu.verify import reverse as jr
from aegis_tpu.verify import similarity as js
from aegis_tpu.verify import technique as jt
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.midi.smf import MidiFile, MidiMessage, MidiTrack
from aegis_tpu_torch.tools.signal_gen import generate_test_track, two_tone
from aegis_tpu_torch.verify import auto_match as ta
from aegis_tpu_torch.verify import effect_loop as tl
from aegis_tpu_torch.verify import per_note as tp
from aegis_tpu_torch.verify import reverse as tr
from aegis_tpu_torch.verify import similarity as ts
from aegis_tpu_torch.verify import technique as tt

SR = 22050
EVENT_FLOATS = ("confidence", "rms_energy", "slope")


def _midi(notes=(60, 64, 67), ticks=480):
    mid = MidiFile()
    tr_ = MidiTrack()
    mid.tracks.append(tr_)
    for n in notes:
        tr_.append(MidiMessage("note_on", note=n, velocity=100, time=0))
        tr_.append(MidiMessage("note_off", note=n, velocity=0, time=ticks))
    return mid.save(None)


@pytest.fixture(scope="module")
def engine():
    return AegisEngine(sample_rate=SR, device="cpu")


@pytest.fixture(scope="module")
def jengine():
    return JaxEngine(sample_rate=SR, backend="device")


@pytest.fixture(scope="module", autouse=True)
def no_fluidsynth():
    """Both packages' synthesizer ladders step down to the ADSR synth."""
    from aegis_tpu.synth import fluidsynth as jfs
    from aegis_tpu_torch.synth import fluidsynth as tfs
    mp = pytest.MonkeyPatch()
    mp.setenv("AEGIS_FLUIDSYNTH_BIN", os.path.join(os.sep, "nonexistent",
                                                   "fluidsynth"))
    for mod in (tfs, jfs):
        mp.setattr(mod, "_singleton", None)
    yield
    mp.undo()


def _events_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if k in EVENT_FLOATS and x[k] is not None:
                assert abs(x[k] - y[k]) <= 1e-5, k
            else:
                assert x[k] == y[k], k


# ------------------------------------- tests/test_verify_loops.py, ported

def test_compare_note_lists():
    orig = [{"note": 60, "start": 0.0, "end": 0.5}]
    same = [{"note": 60, "start": 0.02, "end": 0.5}]
    m = tr.compare_note_lists(orig, same)
    assert m["note_accuracy"] == 1.0
    off = [{"note": 66, "start": 2.0, "end": 2.5}]
    assert tr.compare_note_lists(orig, off)["note_accuracy"] == 0.0
    for a, b in ((orig, same), (orig, off), (orig + off, same), ([], same)):
        np.testing.assert_equal(tr.compare_note_lists(a, b),
                                jr.compare_note_lists(a, b))


def test_audio_similarity_self_and_other():
    t = np.arange(SR) / SR
    a = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    b = (0.5 * np.sin(2 * np.pi * 523 * t)).astype(np.float32)
    aa = ts.audio_similarity(a, a, SR, device="cpu")
    ab = ts.audio_similarity(a, b, SR, device="cpu")
    assert aa > 0.99
    assert ab < aa - 0.1
    assert abs(aa - js.audio_similarity(a, a, SR)) <= 1e-5
    assert abs(ab - js.audio_similarity(a, b, SR)) <= 1e-5
    c = (a + 0.1 * np.sin(2 * np.pi * 331 * t)).astype(np.float32)[: SR * 3 // 4]
    assert abs(ts.audio_similarity(a, c, SR, device="cpu")
               - js.audio_similarity(a, c, SR)) <= 1e-5
    assert ts.audio_similarity(a[:1000], a, SR, device="cpu") == 0.0


@pytest.mark.parametrize("sr", [22050, 44100])
def test_note_slice_similarity_matches_jax(sr):
    rng = np.random.default_rng(sr)
    B, L = 6, 4096
    env = np.linspace(1, 0, L, dtype=np.float32)
    orig = (rng.standard_normal((B, L)) * env).astype(np.float32)
    synth = (rng.standard_normal((B, L)) * env[::-1]).astype(np.float32)
    orig[1] = 0.0                      # silent: both RMS stds below 1e-10
    synth[1] = 0.0
    synth[2] = 0.0                     # one side silent
    got = ts.note_slice_similarity(orig, synth, sr, device="cpu").numpy()
    ref = np.asarray(js.note_slice_similarity(orig, synth, sr))
    assert np.abs(got - ref).max() <= 1e-5


def test_reverse_analysis_roundtrip(engine, jengine):
    result = tr.reverse_analysis(_midi((60, 64, 67)), engine, sample_rate=SR)
    assert result is not None
    assert result["original_notes"] == 3
    assert result["note_accuracy"] >= 2 / 3
    assert result["pitch_accuracy"] > 0.8
    ref = jr.reverse_analysis(_midi((60, 64, 67)), jengine, sample_rate=SR)
    metrics = [k for k in ref if k not in ("reversed_midi", "reversed_events")]
    np.testing.assert_equal({k: result[k] for k in metrics},
                            {k: ref[k] for k in metrics})
    _events_equal(result["reversed_events"], ref["reversed_events"])
    assert result["reversed_midi"] == ref["reversed_midi"]


@pytest.mark.parametrize("mode", ["precise", "quick"])
def test_optimize_single_note_matches_jax(mode):
    """One note of the 60 s bench track (its third truth note, in frames):
    the same parameters and score as the JAX package's."""
    from aegis_tpu_torch.tools.signal_gen import generate_bench_track
    y, truth = generate_bench_track(60.0, sr=SR, return_truth=True)
    note = truth[2]
    event = {"note": note["note"], "start": int(note["start"] * SR / 512),
             "end": int(note["end"] * SR / 512), "velocity": 90}
    got = tp.optimize_single_note(y, event, SR, 512, mode=mode, device="cpu")
    assert got == jp.optimize_single_note(y, event, SR, 512, mode=mode)
    assert got == tp.optimize_all_notes(y, [event], SR, 512, mode=mode,
                                        device="cpu")[0]


def test_per_note_optimizer(engine, jengine):
    track, _ = generate_test_track(sr=SR)
    raw = engine.audio_to_midi(track)
    events = engine.extract_events(raw, None, confidence_threshold=0.5,
                                   sustain_ms=150)
    assert events
    results = tp.optimize_all_notes(track, events, SR, 512, mode="precise",
                                    device="cpu")
    assert len(results) == len(events)
    assert all(0.0 <= r["similarity_score"] <= 1.0 for r in results)
    assert all(r["waveform"] in ("sawtooth", "triangle", "square")
               for r in results)
    ref = jp.optimize_all_notes(track, events, SR, 512, mode="precise")
    for got, want in zip(results, ref):
        if got != want:   # a near tie: the two picks score within 1e-4
            assert abs(got["similarity_score"]
                       - want["similarity_score"]) <= 1e-4, (got, want)
            print(f"per-note tie: {got} / {want}")

    quick = tp.optimize_all_notes(track, events, SR, 512, mode="quick",
                                  device="cpu")
    assert len(quick) == len(events)
    assert quick == jp.optimize_all_notes(track, events, SR, 512, mode="quick")

    audio = tp.synthesize_with_per_note_params(events, results, SR, 512,
                                               device="cpu")
    assert len(audio) > SR
    want = jp.synthesize_with_per_note_params(events, results, SR, 512)
    assert np.abs(audio - want).max() <= 1e-5

    report = tp.generate_optimization_report(results)
    assert report["count"] == len(events)
    assert len(report["worst_notes"]) <= 5


@pytest.mark.parametrize("chunk_elems", [1 << 23, 1 << 17])
def test_per_note_scores_match_jax(chunk_elems, jengine):
    """Every (note, combo) score of the sweep against JAX's, in one chunk
    and in many."""
    track, _ = generate_test_track(sr=SR)
    events = jengine.extract_events(jengine.audio_to_midi(track), None,
                                    confidence_threshold=0.5, sustain_ms=150)
    captured = {}

    def spy(key, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            captured.setdefault(key, []).append(np.array(out))
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(tp, "note_slice_similarity",
               spy("t", tp.note_slice_similarity))
    mp.setattr(jp, "note_slice_similarity",
               spy("j", jp.note_slice_similarity))
    try:
        tp.optimize_all_notes(track, events, SR, 512, device="cpu",
                              chunk_elems=chunk_elems)
        jp.optimize_all_notes(track, events, SR, 512, chunk_elems=chunk_elems)
    finally:
        mp.undo()
    got, want = (np.concatenate(captured[k]) for k in ("t", "j"))
    assert got.shape == want.shape == (27 * len(events),)
    assert np.abs(got - want).max() <= 1e-5


def test_adjust_parameters_rules():
    params = {"confidence_threshold": 0.3, "min_note_duration_ms": 50,
              "sustain_ms": 200}
    acc = {"note_accuracy": 1.0, "pitch_accuracy": 1.0,
           "timing_accuracy": 1.0, "overall": 1.0}
    few = tl.adjust_parameters(params, acc, [1] * 10, [1] * 3)
    assert few["confidence_threshold"] < params["confidence_threshold"]
    many = tl.adjust_parameters(params, acc, [1] * 10, [1] * 20)
    assert many["confidence_threshold"] > params["confidence_threshold"]
    bad_pitch = tl.adjust_parameters(
        params, {**acc, "pitch_accuracy": 0.2}, [1] * 10, [1] * 10)
    assert bad_pitch["sustain_ms"] < params["sustain_ms"]


def test_effect_learning_loop(engine, jengine):
    result = tl.learning_loop(_midi((60, 67)), engine,
                              preset="light_overdrive", max_iterations=2,
                              sample_rate=SR)
    assert result is not None
    assert len(result["history"]) >= 1
    assert 0.0 <= result["best_accuracy"]["overall"] <= 1.0
    ref = jl.learning_loop(_midi((60, 67)), jengine, preset="light_overdrive",
                           max_iterations=2, sample_rate=SR)
    np.testing.assert_equal(result, ref)


@pytest.mark.parametrize("preset", ["full_fx", "ambient"])
def test_effect_learning_loop_presets_match_jax(preset, engine, jengine):
    """Chains with reverb, delay and chorus: the re-transcribed notes, hence
    every accuracy of the history, equal the JAX engine's."""
    kw = dict(preset=preset, max_iterations=3, sample_rate=SR)
    midi = _midi((57, 60, 64, 69), ticks=360)
    np.testing.assert_equal(tl.learning_loop(midi, engine, **kw),
                            jl.learning_loop(midi, jengine, **kw))


def test_auto_match(engine, jengine):
    y = two_tone(sr=SR)
    raw = engine.audio_to_midi(y)
    result = ta.auto_match_parameters(y, engine, raw, sample_rate=SR)
    assert result is not None
    assert 0.1 <= result["confidence_threshold"] <= 0.9
    assert result["score"] > 0.1
    ref = ja.auto_match_parameters(y, jengine, jengine.audio_to_midi(y),
                                   sample_rate=SR)
    assert abs(result["score"] - ref["score"]) <= 1e-5
    picks = [{k: v for k, v in d.items() if k != "score"}
             for d in (result, ref)]
    if picks[0] != picks[1]:
        print(f"auto-match tie within 1e-5: {result} / {ref}")
    else:
        assert result.keys() == ref.keys()


@pytest.mark.parametrize("seed", [0, 1])
def test_auto_match_sweep_scores_match_jax(seed, engine, jengine):
    """Every combo score of both sweeps against JAX's on a track of many
    notes (the batched render of whole event lists)."""
    y, _ = generate_test_track(sr=SR)
    if seed:
        y = y + np.float32(0.01) * np.random.default_rng(seed).standard_normal(
            len(y)).astype(np.float32)
    t_raw, j_raw = engine.audio_to_midi(y), jengine.audio_to_midi(y)
    got = ta.auto_match_parameters(y, engine, t_raw, sample_rate=SR)
    want = ja.auto_match_parameters(y, jengine, j_raw, sample_rate=SR)
    assert abs(got["score"] - want["score"]) <= 1e-5
    if {k: got[k] for k in got if k != "score"} != \
            {k: want[k] for k in want if k != "score"}:
        print(f"auto-match tie within 1e-5: {got} / {want}")


def _bend_clip(sr, dur, note, bend):
    n = int(sr * dur)
    t = np.arange(n) / sr
    f0 = 440.0 * 2 ** ((note - 69) / 12)
    semis = 2.0 * (t / dur) ** 2 if bend else np.zeros(n)
    phase = 2 * np.pi * np.cumsum(f0 * 2 ** (semis / 12)) / sr
    return (0.5 * (2 * ((phase / (2 * np.pi)) % 1) - 1)).astype(np.float32)


def _legato_clip(sr, dur, note, attack_s):
    n = int(sr * dur)
    t = np.arange(n) / sr
    f0 = 440.0 * 2 ** ((note - 69) / 12)
    saw = 2 * ((f0 * t) % 1) - 1
    env = np.minimum(1.0, t / attack_s) * np.exp(-1.5 * t)
    return (0.5 * saw * env).astype(np.float32)


def _verify_both(y, ev, sr, hop, **kw):
    got = tt.verify_technique_by_audio_matching(y, [dict(ev)], sr, hop,
                                                device="cpu", **kw)
    want = jt.verify_technique_by_audio_matching(y, [dict(ev)], sr, hop, **kw)
    assert [e["technique"] for e in got] == [e["technique"] for e in want]
    assert [e.get("technique_verified") for e in got] == \
        [e.get("technique_verified") for e in want]
    for a, b in zip(got, want):
        if "technique_similarity" in b:
            assert abs(a["technique_similarity"]
                       - b["technique_similarity"]) <= 1e-4
    return got


def test_technique_verifier_bend_discrimination():
    """A real pitch-bend is verified; a falsely-tagged steady note is
    stripped (the FM probe path used when FluidSynth is absent)."""
    sr, hop, dur = 22050, 512, 0.6
    end_frame = int(sr * dur) // hop - 1
    ev = {"note": 55, "start": 0, "end": end_frame, "velocity": 100,
          "technique": "bend", "confidence": 0.9, "track": "main"}
    out_bend = _verify_both(_bend_clip(sr, dur, 55, True), ev, sr, hop,
                            min_similarity=0.3)
    out_steady = _verify_both(_bend_clip(sr, dur, 55, False), ev, sr, hop,
                              min_similarity=0.3)
    assert out_bend[0]["technique"] == "bend", out_bend[0]
    assert out_steady[0]["technique"] is None, out_steady[0]


def test_technique_verifier_hammer_on_discrimination():
    """A soft legato attack keeps hammer_on; a sharp picked attack loses
    it (the envelope path decides where the mel cosine cannot)."""
    sr, hop, dur = 22050, 512, 0.4
    end_frame = int(sr * dur) // hop - 1
    ev = {"note": 57, "start": 0, "end": end_frame, "velocity": 70,
          "technique": "hammer_on", "confidence": 0.9, "track": "main"}
    soft = _verify_both(_legato_clip(sr, dur, 57, 0.05), ev, sr, hop,
                        min_similarity=0.3)
    sharp = _verify_both(_legato_clip(sr, dur, 57, 0.002), ev, sr, hop,
                         min_similarity=0.3)
    assert soft[0]["technique"] == "hammer_on", soft[0]
    assert sharp[0]["technique"] is None, sharp[0]


@pytest.mark.parametrize("sr", [22050, 44100])
def test_technique_decisions_match_jax(sr):
    """Every verifiable technique on bent, steady, soft and sharp clips, a
    pass-through event and one too short to check: the same decisions."""
    hop = 512
    clips = {"bent": _bend_clip(sr, 0.6, 55, True),
             "steady": _bend_clip(sr, 0.6, 55, False),
             "soft": _legato_clip(sr, 0.6, 55, 0.05),
             "sharp": _legato_clip(sr, 0.6, 55, 0.002)}
    end_frame = int(sr * 0.6) // hop - 1
    for y in clips.values():
        events = [{"note": 55, "start": 0, "end": end_frame, "velocity": 90,
                   "technique": tech, "confidence": 0.9, "track": "main"}
                  for tech in ("bend", "vibrato", "hammer_on", "pull_off",
                               None)]
        events.append(dict(events[0], start=end_frame + 30,
                           end=end_frame + 31))   # past the clip's end
        for ev in events:
            _verify_both(y, ev, sr, hop)


@pytest.mark.parametrize("loop", ["technique", "auto_match_sequential"])
def test_device_error_raises_where_the_reference_skips(loop, engine,
                                                       monkeypatch):
    """No fallback hides the device: where the JAX package logs a failing
    event (technique verifier) or combo (sequential auto-match) and goes
    on, an error of the port's device scoring raises."""
    def broken(*a, **k):
        raise RuntimeError("device failure")

    sr, hop = 22050, 512
    y = _bend_clip(sr, 0.6, 55, True)
    if loop == "technique":
        ev = {"note": 55, "start": 0, "end": int(sr * 0.6) // hop - 1,
              "velocity": 90, "technique": "bend", "confidence": 0.9,
              "track": "main"}
        monkeypatch.setattr(jt, "_mel_cosine", broken)
        assert jt.verify_technique_by_audio_matching(
            y, [dict(ev)], sr, hop)[0]["technique"] == "bend"
        monkeypatch.setattr(tt, "_mel_cosine", broken)
        with pytest.raises(RuntimeError, match="device failure"):
            tt.verify_technique_by_audio_matching(y, [dict(ev)], sr, hop,
                                                  device="cpu")
    else:
        y = two_tone(sr=SR)
        raw = engine.audio_to_midi(y)
        monkeypatch.setattr(ta, "audio_similarity", broken)
        with pytest.raises(RuntimeError, match="device failure"):
            ta.auto_match_parameters(y, engine, raw, batched=False)


@pytest.mark.parametrize("engine_name", ["svg", "tonejs", "html_midi_player",
                                         "webaudiofont"])
def test_render_piano_roll_matches_jax(engine_name):
    import base64
    import re

    from aegis_tpu.viz.piano_roll import render_piano_roll as jroll
    from aegis_tpu_torch.io.wav import read_wav
    from aegis_tpu_torch.viz import render_piano_roll

    midi = _midi((48, 55, 60, 64))
    assert render_piano_roll(midi, engine_name, device="cpu") == \
        jroll(midi, engine_name)
    got = render_piano_roll(midi, engine_name, offline=True, device="cpu")
    want = jroll(midi, engine_name, offline=True)
    pat = re.compile(r'data:audio/wav;base64,([A-Za-z0-9+/=]+)')
    assert pat.sub("", got) == pat.sub("", want)
    (a, ra), (b, rb) = (read_wav(base64.b64decode(pat.search(m).group(1)))
                        for m in (got, want))
    assert ra == rb and np.abs(a - b).max() <= 1.0 / 32767 + 1e-9


# ------------------------------------------------ the copies of this slice

def _pair(name):
    import importlib
    return (importlib.import_module(f"aegis_tpu_torch.{name}"),
            importlib.import_module(f"aegis_tpu.{name}"))


def _copy_hpss_ref():
    t, j = _pair("ref.hpss_ref")
    rng = np.random.default_rng(0)
    y = rng.standard_normal(9000).astype(np.float32)
    for kw in ({}, {"n_fft": 1024, "hop_length": 256, "kernel_time": 9}):
        for a, b in zip(t.hpss_ref(y, **kw), j.hpss_ref(y, **kw)):
            np.testing.assert_array_equal(a, b)


def _copy_presets():
    t, j = _pair("synth.presets")
    for name in ("GUITAR_ADSR_PRESETS", "EFFECT_PRESETS", "WAVEFORM_CODES",
                 "WAVEFORM_NAMES"):
        assert getattr(t, name) == getattr(j, name), name


def _copy_fluidsynth(tmp_path, monkeypatch):
    t, j = _pair("synth.fluidsynth")
    assert t._SOUNDFONT_PATHS == j._SOUNDFONT_PATHS
    sf = tmp_path / "x.sf2"
    sf.write_bytes(b"")
    for env in ({}, {"AEGIS_SOUNDFONT": str(sf),
                     "AEGIS_FLUIDSYNTH_BIN": str(tmp_path / "fs")}):
        for k in ("AEGIS_SOUNDFONT", "AEGIS_FLUIDSYNTH_BIN"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        a, b = t.FluidSynthSynthesizer(), j.FluidSynthSynthesizer()
        assert (a.fluidsynth_path, a.soundfont, a.is_available()) == \
            (b.fluidsynth_path, b.soundfont, b.is_available())


def _copy_stems(tmp_path, monkeypatch):
    t, j = _pair("synth.stems")
    assert t.DEMUCS_MODELS == j.DEMUCS_MODELS
    fake = tmp_path / "demucs"
    fake.write_text("")
    for env in ("", str(fake)):
        monkeypatch.setenv("AEGIS_DEMUCS_BIN", env)
        assert t.find_demucs() == j.find_demucs()
    monkeypatch.setenv("AEGIS_DEMUCS_BIN", "")
    assert t.separate_all_stems("x.wav", str(tmp_path)) == \
        j.separate_all_stems("x.wav", str(tmp_path))


def _copy_reverse():
    t, j = _pair("verify.reverse")
    rng = np.random.default_rng(1)
    notes = [{"note": int(n), "start": float(s), "end": float(s) + 0.3}
             for n, s in zip(rng.integers(40, 80, 30), rng.uniform(0, 9, 30))]
    est = [dict(n, note=n["note"] + int(d), start=n["start"] + e)
           for n, d, e in zip(notes[::2], rng.integers(-2, 3, 15),
                              rng.uniform(-0.2, 0.2, 15))]
    for a, b in ((notes, est), (est, notes), (notes, []), (notes, notes)):
        np.testing.assert_equal(t.compare_note_lists(a, b),
                                j.compare_note_lists(a, b))


def _copy_effect_loop():
    t, j = _pair("verify.effect_loop")
    params = {"confidence_threshold": 0.3, "min_note_duration_ms": 50,
              "sustain_ms": 200}
    rng = np.random.default_rng(2)
    for _ in range(40):
        acc = dict(zip(("note_accuracy", "pitch_accuracy", "timing_accuracy"),
                       rng.uniform(0, 1, 3)))
        orig, rev = [1] * int(rng.integers(0, 12)), [1] * int(rng.integers(0, 20))
        seed = int(rng.integers(1 << 30))
        assert t.adjust_parameters(params, acc, orig, rev,
                                   np.random.default_rng(seed)) == \
            j.adjust_parameters(params, acc, orig, rev,
                                np.random.default_rng(seed))


def _copy_piano_roll():
    t, j = _pair("viz.piano_roll")
    midi = _midi((40, 52, 64, 71))
    events = [{"note": 40 + k, "start": 10 * k, "end": 10 * k + 7,
               "velocity": 60 + k, "track": ("main", "safe")[k % 2]}
              for k in range(6)]
    assert t.midi_to_svg(midi, title="x") == j.midi_to_svg(midi, title="x")
    assert t.events_to_svg(events, SR, 512) == j.events_to_svg(events, SR, 512)
    assert t.ONLINE_ONLY_ENGINES == j.ONLINE_ONLY_ENGINES
    for fn in ("html_midi_player_embed", "tonejs_canvas_embed",
               "webaudiofont_embed"):
        assert getattr(t, fn)(midi) == getattr(j, fn)(midi)
    with pytest.raises(ValueError):
        t.render_piano_roll(midi, "nope", device="cpu")


def _copy_analyze_envelope():
    from aegis_tpu.synth.adsr import analyze_envelope as j
    from aegis_tpu_torch.synth.adsr import analyze_envelope as t
    rng = np.random.default_rng(3)
    x = np.sin(np.arange(20000) * 0.05) * np.exp(-np.arange(20000) / 6000.0)
    for audio in (x, (x * 20000).astype(np.int16), np.stack([x, x], 1),
                  np.zeros(500), rng.standard_normal(100), np.zeros(4000)):
        for sr in (22050, 44100):
            assert t(audio, sr) == j(audio, sr)


def _copy_extract_note_audio():
    y = np.arange(50000, dtype=np.float32)
    for ev in ({"start": 0, "end": 5}, {"start": 40, "end": 90},
               {"start": 95, "end": 200}):
        np.testing.assert_array_equal(
            tp.extract_note_audio(y, ev, SR, 512),
            jp.extract_note_audio(y, ev, SR, 512))


def _copy_render_probe():
    for tech in ("bend", "vibrato", "hammer_on", "pull_off", None):
        for dur in (0.001, 0.37):
            np.testing.assert_array_equal(
                tt._render_probe(57, dur, tech, 90, SR),
                jt._render_probe(57, dur, tech, 90, SR))


def _copy_envelope_pearson():
    rng = np.random.default_rng(4)
    a = rng.standard_normal(9000).astype(np.float32)
    for b in (a[::-1].copy(), a * 0.5, np.zeros(9000, np.float32), a[:500]):
        for x, y in ((a, b), (b, b)):
            assert tt._envelope_pearson(x, y, SR) == \
                jt._envelope_pearson(x, y, SR)


def _copy_mini_midi():
    ev = {"note": 57, "start": 40, "end": 61, "velocity": 90,
          "technique": "bend", "confidence": 0.9, "track": "main"}
    for with_technique in (True, False):
        for e in (ev, dict(ev, end=40), dict(ev, technique="hammer_on")):
            assert tt._mini_midi(e, SR, 512, with_technique) == \
                jt._mini_midi(e, SR, 512, with_technique)


def _copy_optimization_report():
    rng = np.random.default_rng(5)
    results = [{"attack_ms": 5.0, "decay_ms": 40.0, "sustain_level": 0.5,
                "release_ms": 90.0,
                "waveform": ("sawtooth", "square", "triangle")[k % 3],
                "similarity_score": round(float(s), 4)}
               for k, s in enumerate(rng.uniform(0, 1, 9))]
    for r in (results, results[:2], []):
        assert tp.generate_optimization_report(r) == \
            jp.generate_optimization_report(r)


@pytest.mark.parametrize("what", [
    "hpss_ref", "presets", "fluidsynth", "stems", "reverse", "effect_loop",
    "piano_roll", "analyze_envelope", "extract_note_audio", "render_probe",
    "envelope_pearson", "mini_midi", "optimization_report"])
def test_copy_equals_its_original(what, tmp_path, monkeypatch):
    """The host modules and functions this slice copies from ``aegis_tpu``
    give the originals' arrays, dicts and markup."""
    fn = globals()[f"_copy_{what}"]
    kw = {"fluidsynth": {"tmp_path": tmp_path, "monkeypatch": monkeypatch},
          "stems": {"tmp_path": tmp_path, "monkeypatch": monkeypatch}}
    fn(**kw.get(what, {}))

