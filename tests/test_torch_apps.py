"""The port's Streamlit apps against the JAX package's, on the CPU.

Neither this box nor the GPU machine has streamlit: each app runs through
``chip_smoke.py``'s recording stand-in (one home for it; phase 28 drives
the same apps on the card).  One scripted session goes through
``aegis_tpu.apps.<app>.main()`` on JAX's CPU and through
``aegis_tpu_torch.apps.<app>.main(device="cpu")``; what each recorded must
agree: MIDI bytes, tab text, metric strings and every discrete event field
equal, float fields within the tolerances ROADMAP.md's Queue 3 records
(event floats ~2e-6), WAV audio within one int16 step.
"""

import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.io import read_wav, write_wav
from aegis_tpu_torch.tools.signal_gen import generate_test_track, two_tone

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FLOAT_TOL = 2e-6
# mel_db within 1.2e-3 dB near the -80 dB floor (ROADMAP.md, Queue 3)
MEL_DB_TOL = 1.2e-3


def _chip_smoke():
    """chip_smoke.py, the home of the streamlit stand-in."""
    root = str(REPO)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _wav(y, sr) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, y, sr)
    return buf.getvalue()


def _port_text(s: str) -> str:
    """The port's texts name the port's commands; otherwise they are the
    JAX app's."""
    return s.replace("aegis_tpu_torch", "aegis_tpu")


def _same(a, b, where: str, tol: float = FLOAT_TOL) -> None:
    """``a`` (recorded by the port's app) against ``b`` (the JAX app's)."""
    if isinstance(b, bytes) and b[:4] == b"RIFF":
        ya, sa = read_wav(a)
        yb, sb = read_wav(b)
        assert sa == sb and ya.shape == yb.shape, where
        step = np.abs(np.round(ya * 32767) - np.round(yb * 32767)).max()
        assert step <= 1, (where, step)
    elif isinstance(b, (bytes, bool, type(None))) or isinstance(b, int):
        assert type(a) is type(b) and a == b, (where, a, b)
    elif isinstance(b, str):
        assert _port_text(a) == b, (where, a[:200], b[:200])
    elif isinstance(b, (float, np.floating)):
        assert abs(float(a) - float(b)) <= tol or (a != a and b != b), \
            (where, a, b)
    elif isinstance(b, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in b:
            _same(a[k], b[k], f"{where}.{k}", tol)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]", tol)
    elif hasattr(b, "to_numpy") or hasattr(getattr(b, "data", None),
                                           "to_numpy"):
        _same(_frame(a), _frame(b), where, tol)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        if b.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)


def _frame(x):
    """A pandas frame or its Styler as a plain array."""
    return (x.data if hasattr(x, "data") else x).to_numpy()


def _same_logs(port_log, jax_log, tols=None) -> None:
    """Call for call; ``tols`` maps an output's name to the tolerance of its
    floats where it is not FLOAT_TOL."""
    assert [n for n, _, _ in port_log] == [n for n, _, _ in jax_log]
    for i, ((n, a, ka), (_, b, kb)) in enumerate(zip(port_log, jax_log)):
        tol = (tols or {}).get(n, FLOAT_TOL)
        _same(a, b, f"#{i} {n}", tol)
        _same(ka, kb, f"#{i} {n} kwargs", tol)


def _both(app: str, script: dict, reruns=({},), port_kw=(("device", "cpu"),)):
    """The same scripted session through the JAX app and the port's app:
    one stand-in each, ``reruns`` script updates one rerun each.  Returns
    (port stand-in, JAX stand-in, [(port log, JAX log) a rerun])."""
    import importlib

    cs = _chip_smoke()
    jax_app = importlib.import_module(f"aegis_tpu.apps.{app}")
    port_app = importlib.import_module(f"aegis_tpu_torch.apps.{app}")
    st_p, st_j = cs.StreamlitStandIn(script), cs.StreamlitStandIn(script)
    logs = []
    for update in reruns:
        st_p.script.update(update)
        st_j.script.update(update)
        logs.append((st_p.run(port_app.main, **dict(port_kw)),
                     st_j.run(jax_app.main)))
    return st_p, st_j, logs


APPS = ("tuning_center", "tuner_pro", "live_monitor", "financial_batch",
        "financial_realtime", "stem_lab", "midi_sandbox", "collector_studio",
        "intelligence_dashboard")


@pytest.fixture(scope="module")
def ks44():
    """The Karplus-Strong test track at 44 100 Hz (4.2 s) as an upload."""
    return _chip_smoke().Upload(_wav(generate_test_track(sr=44100)[0], 44100),
                                "ks_track.wav")


@pytest.fixture(scope="module")
def ks22():
    return _chip_smoke().Upload(_wav(generate_test_track(sr=22050)[0], 22050),
                                "ks_track.wav")


def _facade_midi(raw_kw: dict, extract_kw: dict, data: bytes):
    """The port's v1 facade on the CPU at the Tuning Center's rate: events
    and MIDI bytes."""
    eng = AegisEngine(sample_rate=44100, device="cpu")
    raw = eng.audio_to_midi(data, None, **raw_kw)
    buf = io.BytesIO()
    events = eng.extract_events(raw, buf, **extract_kw)
    return raw, events, buf.getvalue()


# the Tuning Center's Phase-2 defaults, as its sliders give them
TC_EXTRACT = _chip_smoke().TC_EXTRACT
STEM = "Stem separation (Demucs, or on-device HPSS)"
NEURAL = "Neural pitch tracker (PitchNet)"
# PitchNet's logits within 2e-5 of JAX's (ROADMAP.md, Queue 3); a
# confidence is a sigmoid of them, whose slope is at most 1/4
NEURAL_TOL = 5e-6


def test_tuning_center_matches_jax_with_a_phase2_rerun(ks44):
    """Upload with the defaults, then move the confidence slider: both
    reruns record what the JAX app records."""
    _, _, logs = _both("tuning_center", {"Audio file": ks44},
                       reruns=({}, {"Confidence": 0.6, "MIDI program": 30}))
    for port_log, jax_log in logs:
        _same_logs(port_log, jax_log, {"line_chart": MEL_DB_TOL})
    first, second = (p for p, _ in logs)
    cs = _chip_smoke()
    assert cs.outputs(first, "download_button") != cs.outputs(
        second, "download_button")


def test_tuning_center_neural_matches_jax(ks44):
    _, _, ((port_log, jax_log),) = _both("tuning_center",
                                         {"Audio file": ks44, NEURAL: True})
    _same_logs(port_log, jax_log, {"line_chart": MEL_DB_TOL,
                                   "dataframe": NEURAL_TOL})


def test_tuning_center_stems_match_jax(ks44):
    """HPSS stem first, then the analysis of the stem: the stems within one
    int16 step of the JAX app's, MIDI, tab, metrics and events equal.  The
    mel chart is of the stem, so it is held to the port's own facade on the
    port's stem."""
    st_p, st_j, ((port_log, jax_log),) = _both(
        "tuning_center", {"Audio file": ks44, STEM: True})
    _same(st_p.session_state["stem_bytes"], st_j.session_state["stem_bytes"],
          "stem")
    _same_logs([c for c in port_log if c[0] != "line_chart"],
               [c for c in jax_log if c[0] != "line_chart"])
    raw, _, _ = _facade_midi({}, TC_EXTRACT, st_p.session_state["stem_bytes"])
    (chart,), = _chip_smoke().outputs(port_log, "line_chart")
    np.testing.assert_array_equal(chart, raw["mel_db"].mean(axis=1))


def test_tuning_center_turbo_equals_the_facade(ks44):
    """Turbo reruns are held to the port's own tiled facade (on the test
    suite's 8-device mesh the JAX package pads the tiles to a multiple of
    8)."""
    cs = _chip_smoke()
    st = cs.StreamlitStandIn({"Audio file": ks44,
                              "Turbo (sharded tiles)": True})
    from aegis_tpu_torch.apps import tuning_center
    log = st.run(tuning_center.main, device="cpu")
    _, events, midi = _facade_midi(dict(turbo_mode=True), TC_EXTRACT,
                                   ks44.getvalue())
    assert cs.outputs(log, "download_button") == [
        ("⬇ MIDI", midi, "ks_track.mid", "audio/midi")]
    assert cs.outputs(log, "dataframe") == [(cs.tc_rows(events),)]


def test_phase2_rerun_does_not_analyze_again(ks44, monkeypatch):
    """A rerun that moves only Phase-2 sliders re-extracts events from the
    cached analysis: audio_to_midi runs once for the three reruns, and the
    MIDI follows the sliders."""
    _, _, midi = _facade_midi({}, dict(TC_EXTRACT, confidence_threshold=0.6,
                                       midi_program=30, noise_gate_db=-30),
                              ks44.getvalue())
    calls = []
    real = AegisEngine.audio_to_midi

    def counted(self, *a, **k):
        calls.append(k.get("turbo_mode"))
        return real(self, *a, **k)

    monkeypatch.setattr(AegisEngine, "audio_to_midi", counted)
    cs = _chip_smoke()
    from aegis_tpu_torch.apps import tuning_center
    st = cs.StreamlitStandIn({"Audio file": ks44})
    midis = []
    for update in ({}, {"Confidence": 0.6}, {"MIDI program": 30,
                                             "Noise gate (dB)": -30}):
        st.script.update(update)
        midis.append(cs.outputs(st.run(tuning_center.main, device="cpu"),
                                "download_button")[0][1])
    assert calls == [False]
    assert midis[2] == midi and midis[2] != midis[0]
    st.script[STEM] = True   # a Phase-1 parameter: analyzed again
    st.run(tuning_center.main, device="cpu")
    assert calls == [False, False]


@pytest.mark.parametrize("engine", ["v1", "financial", "poly"])
def test_live_monitor_matches_jax(ks22, engine):
    """2 s chunks at 22 050 Hz through the live transcriber: every poll's
    roll, the lookahead, the finalized count and MIDI."""
    _, _, ((port_log, jax_log),) = _both(
        "live_monitor", {"Audio": ks22, "Engine": engine})
    _same_logs(port_log, jax_log)
    assert _chip_smoke().outputs(port_log, "download_button")


def test_live_monitor_midi_equals_a_direct_transcriber(ks22):
    from aegis_tpu_torch.apps import live_monitor
    from aegis_tpu_torch.io.audio import load_audio
    from aegis_tpu_torch.midi import events_to_midi

    cs = _chip_smoke()
    st = cs.StreamlitStandIn({"Audio": ks22, "Engine-default confidence":
                              False, "Confidence": 0.4})
    log = st.run(live_monitor.main, device="cpu")
    y, _ = load_audio(ks22.getvalue(), sr=22050)
    rt = live_monitor.make_transcriber("v1", 22050, 0.4, device="cpu")
    for i in range(0, len(y), 2 * 22050):
        rt.feed(y[i:i + 2 * 22050])
        rt.poll_events()
    midi = events_to_midi(rt.finalize(), 22050, rt.audio.hop_length,
                          output=None)
    assert cs.outputs(log, "download_button") == [("Download MIDI", midi,
                                                   "live.mid")]


def test_financial_batch_matches_jax(ks22):
    _, _, ((port_log, jax_log),) = _both(
        "financial_batch", {"Audio": ks22, "🚀 Convert": True})
    _same_logs(port_log, jax_log)


def test_financial_realtime_matches_jax(ks22):
    _, _, logs = _both("financial_realtime", {"Audio": ks22},
                       reruns=({}, {"Min duration (ms)": 100,
                                    "Adaptive confidence threshold": False}))
    for port_log, jax_log in logs:
        _same_logs(port_log, jax_log)


def test_stem_lab_matches_jax(ks22):
    """The HPSS stems (other.wav, drums.wav) within one int16 step."""
    _, _, ((port_log, jax_log),) = _both("stem_lab",
                                         {"Audio": ks22, "Separate": True})
    _same_logs(port_log, jax_log)
    assert len(_chip_smoke().outputs(port_log, "download_button")) == 2


@pytest.mark.parametrize("engine", ["svg", "html_midi_player", "tonejs",
                                    "webaudiofont"])
def test_midi_sandbox_matches_jax(engine):
    from aegis_tpu_torch.midi import events_to_midi

    events = [{"note": 40 + 3 * k, "start": 10 * k, "end": 10 * k + 8,
               "velocity": 70 + 5 * k, "track": "main", "technique": None,
               "confidence": 0.9} for k in range(6)]
    midi = events_to_midi(events, 22050, 512, output=None)
    _, _, ((port_log, jax_log),) = _both(
        "midi_sandbox", {"MIDI file": _chip_smoke().Upload(midi, "a.mid"),
                         "Engine": engine})
    _same_logs(port_log, jax_log)


@pytest.mark.parametrize("mode", ["Search & Bake", "Artist folders",
                                  "Mega batch", "Mobile"])
def test_collector_studio_matches_jax(mode, tmp_path, monkeypatch):
    monkeypatch.delenv("AEGIS_COLLECTOR_PASSWORD", raising=False)
    script = {"Mode": mode, "Output folder": str(tmp_path / "out"),
              "Search query": "guitar", "Artist": "some artist",
              "Queries (one per line)": "a\nb",
              "Batch queries (one per line)": "a", "Query": "a",
              "Collect into artist folder": True, "🚀 Run mega batch": True,
              "Collect": True}
    _, _, ((port_log, jax_log),) = _both("collector_studio", script,
                                         port_kw=())
    _same_logs(port_log, jax_log)


def test_collector_gate_reruns_once_the_password_is_right(tmp_path,
                                                          monkeypatch):
    """The password gate: a wrong word shows an error; the right one sets
    the session's flag and reruns the script (st.rerun), as in the JAX
    app."""
    monkeypatch.setenv("AEGIS_COLLECTOR_PASSWORD", "s3cret")
    script = {"Mode": "Mobile", "Output folder": str(tmp_path / "out"),
              "Access password": "nope"}
    st_p, st_j, logs = _both("collector_studio", script,
                             reruns=({}, {"Access password": "s3cret"}),
                             port_kw=())
    for port_log, jax_log in logs:
        _same_logs(port_log, jax_log)
    assert _chip_smoke().outputs(logs[0][0], "error") == [("Wrong password",)]
    assert st_p.session_state["gate_ok"] and st_j.session_state["gate_ok"]


def test_dashboard_matches_jax():
    _, _, ((port_log, jax_log),) = _both("intelligence_dashboard",
                                         {"🔍 Scan trends": True}, port_kw=())
    _same_logs(port_log, jax_log)


def test_dashboard_simulated_trends_deterministic():
    from aegis_tpu.apps.intelligence_dashboard import \
        _simulated_trends as jax_trends
    from aegis_tpu_torch.apps.intelligence_dashboard import (GENRES,
                                                             _simulated_trends)

    i1, h1 = _simulated_trends()
    i2, h2 = _simulated_trends()
    ij, hj = jax_trends()
    assert i1 == i2 == ij and np.array_equal(h1, h2)
    np.testing.assert_array_equal(h1, hj)
    assert set(i1) == set(GENRES) and h1.shape == (7, 24)


def test_tuning_center_archive_files(tmp_path, monkeypatch):
    from aegis_tpu.apps.tuning_center import _archive_files as jax_archive
    from aegis_tpu_torch.apps.tuning_center import _archive_files

    artist = tmp_path / "col" / "some_artist"
    artist.mkdir(parents=True)
    for name in ("take1.wav", "take2.mp3", "notes.txt", "b.FLAC"):
        (artist / name).write_bytes(b"x")
    monkeypatch.setenv("AEGIS_ARCHIVE_DIR", str(tmp_path / "col"))
    monkeypatch.chdir(tmp_path)
    found = _archive_files()
    assert found == jax_archive()
    names = {os.path.basename(p) for p in found}
    assert {"take1.wav", "take2.mp3", "b.FLAC"} <= names
    assert "notes.txt" not in names


def test_tuning_center_archive_mode_matches_jax(tmp_path, monkeypatch,
                                                ks44):
    (tmp_path / "col").mkdir()
    (tmp_path / "col" / "take.wav").write_bytes(ks44.getvalue())
    monkeypatch.setenv("AEGIS_ARCHIVE_DIR", str(tmp_path / "col"))
    monkeypatch.chdir(tmp_path)
    _, _, ((port_log, jax_log),) = _both(
        "tuning_center", {"Perception input": "📂 Archive explorer"})
    _same_logs(port_log, jax_log, {"line_chart": MEL_DB_TOL})
    assert _chip_smoke().outputs(port_log, "download_button")[0][2] == \
        "take.mid"


@pytest.mark.parametrize("kind", ["v1", "financial", "poly"])
def test_live_monitor_stream_helpers(kind):
    """The live-monitor loop works headlessly: the upload is fed in chunks
    and the event list grows to the finalize result, as with the JAX
    helpers."""
    from aegis_tpu.apps import live_monitor as jlive
    from aegis_tpu_torch.apps.live_monitor import (make_transcriber,
                                                   stream_in_chunks)

    y = two_tone(sr=22050)
    rt = make_transcriber(kind, 22050, 0.5, device="cpu")
    steps = list(stream_in_chunks(rt, y, 22050, chunk_s=1.0))
    jrt = jlive.make_transcriber(kind, 22050, 0.5)
    jsteps = list(jlive.stream_in_chunks(jrt, y, 22050, chunk_s=1.0))
    assert [s for s, _ in steps] == [s for s, _ in jsteps]
    assert steps[-1][0] == len(y) / 22050
    final = rt.finalize()
    assert [(e["note"], e["start"], e["end"]) for e in final] == [
        (e["note"], e["start"], e["end"]) for e in jrt.finalize()]
    if kind != "financial":
        assert {e["note"] for e in final} >= {55, 62}, final


@pytest.mark.parametrize("app", APPS)
def test_apps_need_streamlit(app):
    """Every app module imports without streamlit; main() raises an
    ImportError that names it and the port's server."""
    import importlib

    mod = importlib.import_module(f"aegis_tpu_torch.apps.{app}")
    assert "streamlit" not in sys.modules
    with pytest.raises(ImportError, match="streamlit") as err:
        mod.main()
    assert "python -m aegis_tpu_torch serve" in str(err.value)


def test_common_copy_equals_its_original():
    """``apps/common.py`` is a copy: the same cache keys, the same recorded
    player and panel calls."""
    from aegis_tpu.apps import common as jcommon
    from aegis_tpu_torch.apps import common

    for params in ({}, {"start": 0.0, "end": None, "rake": 0.6,
                        "turbo": False, "stem": True, "neural": False},
                   {"cap": 30, "neural": False}):
        assert common.phase1_cache_key(b"abc", **params) == \
            jcommon.phase1_cache_key(b"abc", **params)
    assert common.phase1_cache_key(b"abc", rake=0.6) != \
        common.phase1_cache_key(b"abc", rake=0.65)
    cs = _chip_smoke()
    logs = []
    for mod in (common, jcommon):
        st = cs.StreamlitStandIn()
        st.run(lambda: (mod.audio_player(st, b"RIFFxx", "label"),
                        mod.svg_panel(st, "<svg/>", height=100)))
        logs.append(st.log)
    assert logs[0] == logs[1] == [
        ("caption", ("label",), {}),
        ("audio", (b"RIFFxx",), {"format": "audio/wav"}),
        ("html", ("<svg/>",), {"height": 130, "scrolling": False})]


@pytest.mark.parametrize("app,script", [
    ("tuning_center", {"Audio file": "wav"}),
    ("tuner_pro", {"Audio (first 30 s analyzed)": "wav"}),
    ("live_monitor", {"Audio": "wav"}),
    ("financial_batch", {"Audio": "wav", "🚀 Convert": True}),
    ("financial_realtime", {"Audio": "wav"}),
    ("stem_lab", {"Audio": "wav", "Separate": True}),
    ("midi_sandbox", {"MIDI file": "midi"}),
])
def test_apps_run_on_the_card_unless_told(app, script, ks22, monkeypatch):
    """``main()`` names no device: the app's device work asks for the card,
    and without one it raises (no CPU run instead)."""
    import importlib

    from aegis_tpu_torch.midi import events_to_midi

    midi = events_to_midi([{"note": 60, "start": 0, "end": 8, "velocity": 90,
                            "track": "main", "technique": None,
                            "confidence": 0.9}], 22050, 512, output=None)
    cs = _chip_smoke()
    uploads = {"wav": ks22, "midi": cs.Upload(midi, "a.mid")}
    st = cs.StreamlitStandIn({k: uploads.get(v, v) if isinstance(v, str)
                              else v for k, v in script.items()})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"aegis_tpu_torch.apps.{app}")
    with pytest.raises(RuntimeError, match="is_available"):
        st.run(mod.main)
