"""aegis_tpu_torch v1 engine vs the JAX engine, end to end on the CPU, and
the guards that keep the port honest (no JAX, no silent CPU run, no
silent success without a card)."""

import io
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aegis_tpu.config import AudioConfig, PyinConfig
from aegis_tpu.core.analyze import run_analyze as jax_run_analyze
from aegis_tpu.engine.engine import AegisEngine as JaxEngine
from aegis_tpu.io import write_wav
from aegis_tpu.midi.decode import midi_to_notes
from aegis_tpu.tools.signal_gen import generate_scale_benchmark, generate_test_track
from aegis_tpu.verify.metrics import events_to_seconds, note_event_f1
from aegis_tpu_torch import config as tconfig
from aegis_tpu_torch.core.analyze import _V1_ROWS, run_analyze
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.folder import transcribe_folder

# One torch thread per process: the suite runs in parallel pytest workers,
# and torch's default of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CLIPS = {
    "ks_22050": (22050, lambda: generate_test_track(sr=22050)[0]),
    "ks_44100": (44100, lambda: generate_test_track(sr=44100)[0]),
    "scale_22050": (22050, lambda: generate_scale_benchmark(sr=22050)[0]),
}


@pytest.fixture(scope="module")
def raws():
    """(JAX raw_data, port raw_data) per clip, analyzed once."""
    cache = {}

    def get(name):
        if name not in cache:
            sr, make = CLIPS[name]
            y = make()
            cache[name] = (
                JaxEngine(sample_rate=sr, backend="device").audio_to_midi(y),
                AegisEngine(sample_rate=sr, device="cpu").audio_to_midi(y))
        return cache[name]
    return get


@pytest.mark.parametrize("transport", ["int8", "int16", "float32"])
def test_run_analyze_rows_match_jax(transport):
    y, _ = generate_test_track(sr=22050)
    audio, cfg = AudioConfig(sample_rate=22050), PyinConfig()
    ref = jax_run_analyze(y, audio, cfg, transport=transport)
    got = run_analyze(y, tconfig.AudioConfig(sample_rate=22050),
                      tconfig.PyinConfig(), transport=transport, device="cpu")
    for k in _V1_ROWS:
        assert got[k].shape == ref[k].shape, k
        if k in ("voiced_flag", "rake_mask"):
            np.testing.assert_array_equal(got[k], ref[k])
        elif k == "f0":
            assert got[k].dtype == np.float64
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(ref[k]))
            m = ~np.isnan(ref[k])
            assert np.max(np.abs(got[k][m] - ref[k][m]) / ref[k][m]) < 1e-4
        else:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-4)


def assert_same_events(got, ref):
    """Equal event lists: every discrete field (note, start, end, velocity,
    track, technique) equal; the float fields (confidence, rms_energy,
    slope) within 1e-4, the per-frame row tolerance, because the rows they
    read (voiced_probs, rms, f0) sum in another order than XLA's."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-4, (k, g, r)
            else:
                assert g[k] == r[k], (k, g, r)


@pytest.mark.parametrize("conf", [0.5, 0.3])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_events_equal_jax_engine(raws, clip, conf):
    sr = CLIPS[clip][0]
    raw_j, raw_t = raws(clip)
    ev_j = JaxEngine(sample_rate=sr, backend="device").extract_events(
        raw_j, None, confidence_threshold=conf)
    ev_t = AegisEngine(sample_rate=sr, device="cpu").extract_events(
        raw_t, None, confidence_threshold=conf)
    assert ev_t
    assert_same_events(ev_t, ev_j)


def test_truth_recall_and_midi(raws):
    _, truth = generate_test_track(sr=22050)
    eng = AegisEngine(sample_rate=22050, device="cpu")
    raw = raws("ks_22050")[1]
    events = eng.extract_events(raw, None, confidence_threshold=0.5)
    m = note_event_f1(truth, events_to_seconds(events, 22050, 512),
                      onset_tolerance=0.2)
    assert m["recall"] == 1.0, m

    buf = io.BytesIO()
    eng.extract_events(raw, buf, confidence_threshold=0.5, sustain_ms=150)
    pitches = {n["note"] for n in midi_to_notes(buf.getvalue())}
    assert {40, 45, 50} <= pitches


def test_raw_data_roundtrip_and_bpm(tmp_path, raws):
    eng = AegisEngine(sample_rate=22050, device="cpu")
    raw = raws("scale_22050")[1]
    p = str(tmp_path / "raw.npz")
    eng.save_raw(raw, p)
    raw2 = eng.load_raw(p)
    assert eng.extract_events(raw, None) == eng.extract_events(raw2, None)
    bpm = eng.estimate_bpm(raw)
    assert bpm is None or bpm > 0


def test_unported_modes_raise(tmp_path):
    """What is unknown raises: an unknown pitch backend, a pitch backend on
    the engines that embed their own, an unknown transport, an unknown
    turbo mode.  The poly and auto folder engines, the neural backend, the
    polyphonic live transcriber and the facade's ``separate_stems`` are
    ported: they run or exist."""
    from aegis_tpu_torch.engine.realtime import StreamingPolyTranscriber
    from aegis_tpu_torch.tools.signal_gen import generate_chord_progression
    y = np.zeros(22050, np.float32)
    rt = StreamingPolyTranscriber(sample_rate=22050, device="cpu")
    rt.feed(y)
    assert rt.frames_analyzed > 0 and rt.finalize() == []
    eng = AegisEngine(sample_rate=22050, device="cpu")
    assert callable(getattr(eng, "separate_stems"))
    assert hasattr(JaxEngine, "separate_stems")
    with pytest.raises(ValueError):
        eng.audio_to_midi(y, pitch_backend="bogus")
    with pytest.raises(ValueError):
        AegisFinancialEngine(device="cpu").analyze(y, pitch_backend="bogus")
    for engine in ("poly", "auto"):
        with pytest.raises(ValueError):
            transcribe_folder(str(tmp_path), engine=engine,
                              pitch_backend="neural", device="cpu")
    with pytest.raises(ValueError):
        transcribe_folder(str(tmp_path), transport="int2", device="cpu")
    assert transcribe_folder(str(tmp_path), engine="poly", device="cpu") == []
    write_wav(str(tmp_path / "c.wav"),
              generate_chord_progression(7, 22050)[0], 22050)
    for engine in ("poly", "auto"):
        (wav, mid, n), = transcribe_folder(str(tmp_path), engine=engine,
                                           device="cpu")
        assert n > 0 and os.path.getsize(mid) > 0
    (wav, mid, n), = transcribe_folder(str(tmp_path), pitch_backend="neural",
                                       device="cpu")
    assert n > 0 and os.path.getsize(mid) > 0
    with pytest.raises(ValueError):
        eng.audio_to_midi(y, turbo_mode="bogus")


def test_turbo_modes_run_through_the_facade():
    """turbo_mode "auto" past stream_threshold_s streams (it used to raise
    past 240 s), and "tiles" and "stream" run: each gives the fused
    program's frame count and events on a short clip."""
    y, _ = generate_test_track(sr=22050)
    eng = AegisEngine(sample_rate=22050, device="cpu")
    fused = eng.audio_to_midi(y)
    ev_fused = eng.extract_events(fused, None, confidence_threshold=0.5)
    for kw in ({"turbo_mode": "auto", "stream_threshold_s": 1.0},
               {"turbo_mode": "tiles"}, {"turbo_mode": "stream"}):
        raw = eng.audio_to_midi(y, **kw)
        assert raw["f0"].shape == fused["f0"].shape, kw
        ev = eng.extract_events(raw, None, confidence_threshold=0.5)
        assert [(e["note"], e["start"], e["end"]) for e in ev] == \
            [(e["note"], e["start"], e["end"]) for e in ev_fused], kw


def test_cli_transcribe(tmp_path):
    y, _ = generate_test_track(sr=22050)
    wav, mid = tmp_path / "in.wav", tmp_path / "out.mid"
    write_wav(str(wav), y, 22050)
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "transcribe", str(wav),
         str(mid), "--sr", "22050", "--device", "cpu", "--confidence", "0.5"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "events ->" in proc.stdout
    assert {40, 45, 50} <= {n["note"] for n in midi_to_notes(str(mid))}
    # the stems command: the harmonic stem's path, exit code 0
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "stems", str(wav),
         str(tmp_path / "stems"), "--method", "hpss", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert Path(proc.stdout.strip().splitlines()[-1]).is_file()


@pytest.mark.parametrize("method", ["load_audio", "detect_rake_patterns",
                                    "generate_tabs", "export_musicxml",
                                    "separate_stems"])
@pytest.mark.parametrize("clip", ["ks_22050", "ks_44100"])
def test_facade_helpers_match_jax(tmp_path, monkeypatch, raws, clip, method):
    """Each helper of the JAX facade gives the JAX facade's output on the
    same input: load_audio's samples and S_dB equal (the same NumPy code
    on both sides), the rake mask equal, the tab list equal, the MusicXML
    bytes equal, the HPSS stems within one int16 step."""
    sr = CLIPS[clip][0]
    jeng = JaxEngine(sample_rate=sr, backend="device")
    teng = AegisEngine(sample_rate=sr, device="cpu")
    wav = str(tmp_path / "in.wav")
    write_wav(wav, CLIPS[clip][1](), sr)
    (yj, sj), (yt, st) = (e.load_audio(wav, 0.5, 3.5) for e in (jeng, teng))
    if method == "load_audio":
        np.testing.assert_array_equal(yt, yj)
        assert st.shape == sj.shape == (128, 1 + len(yj) // 512)
        np.testing.assert_array_equal(st, sj)
    elif method == "separate_stems":
        from aegis_tpu.synth import stems as jstems
        from aegis_tpu_torch.io.wav import read_wav
        from aegis_tpu_torch.synth import stems as tstems
        for mod in (jstems, tstems):
            monkeypatch.setattr(mod, "find_demucs", lambda: None)
        a = teng.separate_stems(wav, str(tmp_path / "t"))
        b = jeng.separate_stems(wav, str(tmp_path / "j"))
        assert a.endswith("other.wav") and b.endswith("other.wav")
        assert np.abs(read_wav(a)[0] - read_wav(b)[0]).max() <= 1.0 / 32767
    elif method == "detect_rake_patterns":
        for sens in (0.3, 0.6):
            np.testing.assert_array_equal(teng.detect_rake_patterns(sj, sens),
                                          jeng.detect_rake_patterns(sj, sens))
    else:
        events = jeng.extract_events(raws(clip)[0], None,
                                     confidence_threshold=0.5)
        tabs = teng.generate_tabs(events)
        assert tabs and tabs == jeng.generate_tabs(events)
        if method == "export_musicxml":
            a, b = str(tmp_path / "t.xml"), str(tmp_path / "j.xml")
            assert teng.export_musicxml(tabs, a) == a
            jeng.export_musicxml(tabs, b)
            assert Path(a).read_bytes() == Path(b).read_bytes()


def test_int4_transport_matches_jax(tmp_path):
    """transport="int4": the packed nibbles and scales equal JAX's, the
    device dequantization equals JAX's bit for bit, run_analyze's rows
    meet the int8 test's tolerances, the events equal the JAX engine's,
    and transcribe_folder and `batch --transport int4` run it."""
    import jax.numpy as jnp
    from aegis_tpu.core import analyze as janalyze
    from aegis_tpu.core.events import extract_events_v1 as j_extract
    from aegis_tpu_torch.core import analyze as tanalyze
    from aegis_tpu_torch.core.events import extract_events_v1 as t_extract

    y, _ = generate_test_track(sr=22050)
    y_pad = tanalyze.pad_to_bucket(y)
    (q, s), (qj, sj) = tanalyze.quantize_pcm4(y_pad), janalyze.quantize_pcm4(y_pad)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    assert q.dtype == np.uint8 and len(q) == len(y_pad) // 2
    deq = tanalyze.dequant_transport(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(janalyze.dequant_transport(jnp.asarray(qj),
                                                           jnp.asarray(sj))))
    audio, cfg = AudioConfig(sample_rate=22050), PyinConfig()
    ref = jax_run_analyze(y, audio, cfg, transport="int4")
    got = run_analyze(y, tconfig.AudioConfig(sample_rate=22050),
                      tconfig.PyinConfig(), transport="int4", device="cpu")
    for k in _V1_ROWS:
        if k in ("voiced_flag", "rake_mask"):
            np.testing.assert_array_equal(got[k], ref[k])
        elif k == "f0":
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(ref[k]))
            m = ~np.isnan(ref[k])
            assert np.max(np.abs(got[k][m] - ref[k][m]) / ref[k][m]) < 1e-4
        else:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-4)

    def events(mod_extract, r):
        return mod_extract(r["rake_mask"], np.nan_to_num(r["f0"]),
                           r["voiced_flag"], r["voiced_probs"], r["rms"],
                           22050, 512, confidence_threshold=0.5,
                           onset_env=r["onset_env"])
    assert_same_events(events(t_extract, got), events(j_extract, ref))

    write_wav(str(tmp_path / "a.wav"), y, 22050)
    (wav, mid, n), = transcribe_folder(str(tmp_path), str(tmp_path / "f"),
                                       transport="int4",
                                       confidence_threshold=0.5,
                                       device="cpu")
    assert n > 0
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "batch", str(tmp_path),
         "--output-dir", str(tmp_path / "b"), "--transport", "int4",
         "--confidence", "0.5", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "b" / "a.mid").read_bytes() == Path(mid).read_bytes()


# ------------------------------------------------------------------ guards

# the polyphonic stack: fused, tiles, the folder, live, tabs
_POLY_PATHS = (
    "from aegis_tpu_torch.engine.poly import AegisPolyEngine\n"
    "from aegis_tpu_torch.engine.realtime import StreamingPolyTranscriber\n"
    "from aegis_tpu_torch.midi.tabs import render_ascii_tab\n"
    "from aegis_tpu_torch.tools.signal_gen import generate_chord_progression\n"
    "yc = generate_chord_progression(7, 22050)[0][:3 * 22050]\n"
    "peng = AegisPolyEngine(sample_rate=22050, device='cpu')\n"
    "for mode in (False, 'tiles'):\n"
    "    pev = peng.extract_events(peng.analyze(yc, turbo_mode=mode))\n"
    "    assert pev and render_ascii_tab(peng.generate_tabs(pev)), mode\n"
    "assert peng.label_chords(pev)\n"
    "dp = tempfile.mkdtemp()\n"
    "write_wav(os.path.join(dp, 'c.wav'), yc, 22050)\n"
    "assert transcribe_folder(dp, engine='poly', device='cpu')[0][2] > 0\n"
    "prt = StreamingPolyTranscriber(sample_rate=22050, device='cpu')\n"
    "for i in range(0, len(yc), 5000):\n"
    "    prt.feed(yc[i:i + 5000])\n"
    "assert prt.poll_events() and prt.finalize()\n"
    "from aegis_tpu_torch.engine.auto import AegisAutoEngine\n"
    "aeng = AegisAutoEngine(sample_rate=22050, device='cpu')\n"
    "assert aeng.extract_events(aeng.analyze(yc), io.BytesIO())\n"
    "assert transcribe_folder(dp, engine='auto', device='cpu')[0][2] > 0\n"
    "from aegis_tpu_torch.models.pitchnet import run_analyze_neural_streamed\n"
    "neng = AegisEngine(sample_rate=22050, device='cpu')\n"
    "for mode in (False, 'stream'):\n"
    "    nraw = neng.audio_to_midi(yc, pitch_backend='neural', turbo_mode=mode)\n"
    "    assert neng.extract_events(nraw, None, confidence_threshold=0.3), mode\n"
    "assert run_analyze_neural_streamed(yc, 22050, 512, slab_frames=64,\n"
    "                                   device='cpu')['voiced_flag'].any()\n"
    "assert AegisFinancialEngine(device='cpu').analyze(\n"
    "    yc, pitch_backend='neural')['trend'].shape[0] > 0\n"
    "assert transcribe_folder(dp, pitch_backend='neural', device='cpu')\n"
) + (
    # HPSS stems, the ADSR synth and effect chain, the verification loops
    "from aegis_tpu_torch.core.hpss import hpss, hpss_program\n"
    "from aegis_tpu_torch.synth.stems import separate_stems, separate_hpss\n"
    "from aegis_tpu_torch.synth.adsr import (synthesize_note_arrays,\n"
    "    midi_to_wav_adsr, synthesize_midi_adsr)\n"
    "from aegis_tpu_torch.synth.fluidsynth import synthesize_midi\n"
    "from aegis_tpu_torch.synth.effects import apply_effect_chain\n"
    "from aegis_tpu_torch.verify.similarity import (audio_similarity,\n"
    "    note_slice_similarity)\n"
    "from aegis_tpu_torch.verify.reverse import reverse_analysis\n"
    "from aegis_tpu_torch.verify.auto_match import auto_match_parameters\n"
    "from aegis_tpu_torch.verify.per_note import (optimize_all_notes,\n"
    "    synthesize_with_per_note_params)\n"
    "from aegis_tpu_torch.verify.technique import (\n"
    "    verify_technique_by_audio_matching)\n"
    "from aegis_tpu_torch.verify.effect_loop import learning_loop\n"
    "from aegis_tpu_torch.viz import render_piano_roll\n"
    "from aegis_tpu_torch.midi import events_to_midi\n"
    "ys = yc[:22050]\n"
    "assert hpss(ys, device='cpu')[0].shape == ys.shape\n"
    "assert hpss_program(ys, device='cpu').shape == (2, len(ys))\n"
    "assert separate_hpss(os.path.join(dp, 'c.wav'), dp, device='cpu')\n"
    "assert separate_stems(os.path.join(dp, 'c.wav'), dp, method='hpss',\n"
    "                      device='cpu')\n"
    "assert neng.separate_stems(os.path.join(dp, 'c.wav'), dp)\n"
    "seng = AegisEngine(sample_rate=22050, device='cpu')\n"
    "sraw = seng.audio_to_midi(ys)\n"
    "sev = seng.extract_events(sraw, None, confidence_threshold=0.3)\n"
    "smid = events_to_midi(sev, 22050, 512, output=None)\n"
    "notes = [{'note': 60, 'start': 0.0, 'end': 0.4, 'velocity': 90}]\n"
    "assert synthesize_note_arrays(notes, 22050, device='cpu').any()\n"
    "for fn in (midi_to_wav_adsr, synthesize_midi_adsr, synthesize_midi):\n"
    "    assert fn(smid, sample_rate=22050, device='cpu')[:4] == b'RIFF'\n"
    "assert apply_effect_chain(ys, [('chorus', {}), ('reverb', {})],\n"
    "                          sr=22050, device='cpu').shape == ys.shape\n"
    "assert audio_similarity(ys, ys, 22050, device='cpu') > 0.99\n"
    "assert note_slice_similarity(ys[None, :4096], ys[None, :4096], 22050,\n"
    "                             device='cpu').shape == (1,)\n"
    "assert reverse_analysis(smid, seng, sample_rate=22050) is not None\n"
    "assert learning_loop(smid, seng, preset='full_fx', max_iterations=1,\n"
    "                     sample_rate=22050)['history']\n"
    "assert auto_match_parameters(ys, seng, sraw) is not None\n"
    "opt = optimize_all_notes(ys, sev[:2], 22050, 512, device='cpu')\n"
    "assert synthesize_with_per_note_params(sev[:2], opt, 22050, 512,\n"
    "                                       device='cpu').any()\n"
    "assert verify_technique_by_audio_matching(\n"
    "    ys, [dict(sev[0], technique='bend')], 22050, 512, device='cpu')\n"
    "assert '<audio' in render_piano_roll(smid, offline=True, device='cpu')\n"
)


def test_port_never_imports_jax():
    """With jax made unimportable, the port still runs the v1 path fused,
    tiled and streamed, the financial engine, the folder sweep, a live v1
    and a live financial session, the polyphonic stack (fused, tiles,
    folder, live, tabs), the auto router (facade and folder) and the
    neural backend (fused, streamed, financial, folder)."""
    code = (
        "import sys, os, tempfile\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, io\n"
        "from aegis_tpu_torch.io import write_wav\n"
        "from aegis_tpu_torch.engine.engine import AegisEngine\n"
        "from aegis_tpu_torch.engine.financial import AegisFinancialEngine\n"
        "from aegis_tpu_torch.engine.folder import transcribe_folder\n"
        "from aegis_tpu_torch.tools.signal_gen import generate_test_track\n"
        "y = generate_test_track(sr=22050)[0][:2 * 22050]\n"
        "eng = AegisEngine(sample_rate=22050, device='cpu')\n"
        "for mode in (False, 'tiles', 'stream'):\n"
        "    raw = eng.audio_to_midi(y, turbo_mode=mode)\n"
        "    buf = io.BytesIO()\n"
        "    events = eng.extract_events(raw, buf, confidence_threshold=0.5)\n"
        "    assert events and buf.getvalue().startswith(b'MThd'), mode\n"
        "fin = AegisFinancialEngine(device='cpu')\n"
        "d = tempfile.mkdtemp()\n"
        "write_wav(os.path.join(d, 'a.wav'), y, 22050)\n"
        "assert fin.audio_to_midi_financial(y, os.path.join(d, 'f.mid'))\n"
        "assert fin.analyze(y, turbo_mode='stream')['trend'].shape == raw['f0'].shape\n"
        "assert transcribe_folder(d, engine='financial', device='cpu')\n"
        "from aegis_tpu_torch.config import AudioConfig\n"
        "from aegis_tpu_torch.engine.realtime import StreamingTranscriber\n"
        "for live_fin in (False, True):\n"
        "    rt = StreamingTranscriber(audio=AudioConfig(sample_rate=22050),\n"
        "                              financial=live_fin, device='cpu')\n"
        "    for i in range(0, len(y), 5000):\n"
        "        rt.feed(y[i:i + 5000])\n"
        "    assert rt.poll_events() and rt.finalize(), live_fin\n"
        + _POLY_PATHS +
        "loaded = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert all(sys.modules[m] is None for m in loaded), loaded\n"
        "print('ok', len(events))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("ok")


# what a user of the port runs, on the CPU: fused v1, tiles, stream,
# financial, the folder sweep, the live transcribers
_PORT_PATHS = (
    "import io, os, tempfile\n"
    "import numpy as np\n"
    "from aegis_tpu_torch.engine.engine import AegisEngine\n"
    "from aegis_tpu_torch.engine.financial import AegisFinancialEngine\n"
    "from aegis_tpu_torch.engine.folder import transcribe_folder\n"
    "from aegis_tpu_torch.io import write_wav\n"
    "from aegis_tpu_torch.midi import midi_to_notes\n"
    "from aegis_tpu_torch.tools.signal_gen import generate_test_track\n"
    "y = generate_test_track(sr=22050)[0][:2 * 22050]\n"
    "eng = AegisEngine(sample_rate=22050, device='cpu')\n"
    "for mode in (False, 'tiles', 'stream'):\n"
    "    raw = eng.audio_to_midi(y, turbo_mode=mode)\n"
    "    buf = io.BytesIO()\n"
    "    events = eng.extract_events(raw, buf, confidence_threshold=0.5,\n"
    "                                bpm='auto')\n"
    "    assert events and midi_to_notes(buf.getvalue()), mode\n"
    "fin = AegisFinancialEngine(device='cpu')\n"
    "d = tempfile.mkdtemp()\n"
    "write_wav(os.path.join(d, 'a.wav'), y, 22050)\n"
    "assert fin.audio_to_midi_financial(y, os.path.join(d, 'f.mid'))\n"
    "assert fin.analyze(y, turbo_mode='stream')['trend'].shape == raw['f0'].shape\n"
    "for engine in ('v1', 'financial'):\n"
    "    assert transcribe_folder(d, engine=engine, device='cpu')\n"
    "from aegis_tpu_torch.config import AudioConfig\n"
    "from aegis_tpu_torch.engine.realtime import StreamingTranscriber\n"
    "for live_fin in (False, True):\n"
    "    rt = StreamingTranscriber(audio=AudioConfig(sample_rate=22050),\n"
    "                              financial=live_fin, device='cpu')\n"
    "    for i in range(0, len(y), 5000):\n"
    "        rt.feed(y[i:i + 5000])\n"
    "    assert rt.poll_events() and rt.finalize(), live_fin\n"
) + _POLY_PATHS


def test_port_never_imports_the_jax_package():
    """With an import system that refuses ``aegis_tpu``, ``aegis_tpu.*`` and
    jax, the port still runs every path it has."""
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('aegis_tpu', 'jax', 'jaxlib'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        + _PORT_PATHS +
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('aegis_tpu', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('ok', len(events))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(REPO),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("ok")


def test_no_port_file_names_the_jax_package_in_an_import():
    """Static: no file of the port, nor chip_smoke.py, imports aegis_tpu or
    jax, at the top or inside a function."""
    pat = re.compile(
        r"^\s*(from|import)\s+(aegis_tpu|jax|jaxlib)(\.|\s|$)"
        r"|import_module\(\s*[\"'](aegis_tpu|jax)[.\"']"
        r"|__import__\(\s*[\"'](aegis_tpu|jax)[.\"']", re.M)
    files = sorted((REPO / "aegis_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    bad = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def _port_and_original(name):
    import importlib
    return (importlib.import_module(f"aegis_tpu_torch.{name}"),
            importlib.import_module(f"aegis_tpu.{name}"))


def _events_for_copies():
    return [{"note": 40 + 5 * k, "start": 10 * k, "end": 10 * k + 8,
             "confidence": 0.9 - 0.1 * k, "velocity": 100 - 7 * k,
             "track": "main" if k % 2 else "safe", "rms_energy": -12.0 - k,
             "technique": (None, "bend", "vibrato", "hammer_on")[k % 4],
             "slope": 0.06 * (k % 3), "financial_artic": None,
             "financial_slide": None} for k in range(6)]


def _copy_config():
    t, j = _port_and_original("config")
    import dataclasses
    for cls in ("AudioConfig", "PyinConfig", "TurboConfig"):
        a, b = getattr(t, cls)(), getattr(j, cls)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b), cls
        assert hash(a) == hash(getattr(t, cls)())
    for sr in (22050, 44100, 48000):
        assert (t.PyinConfig().transition_width(sr, 512)
                == j.PyinConfig().transition_width(sr, 512))
        assert t.AudioConfig(sample_rate=sr).n_frames(12345) == \
            j.AudioConfig(sample_rate=sr).n_frames(12345)
    assert t.midi_to_hz(57) == j.midi_to_hz(57)


def _copy_filters():
    t, j = _port_and_original("core.filters")
    np.testing.assert_array_equal(t.hann_window(2048), j.hann_window(2048))
    np.testing.assert_array_equal(t.mel_filterbank(22050, 2048, 128),
                                  j.mel_filterbank(22050, 2048, 128))
    for a, b in zip(t.dft_matrices(256), j.dft_matrices(256)):
        np.testing.assert_array_equal(a, b)


def _copy_ref():
    for name, calls in {
            "ref.dsp_ref": [("amplitude_to_db", (np.linspace(1e-6, 1, 50),)),
                            ("hz_to_midi", (np.linspace(80, 900, 40),)),
                            ("melspectrogram",
                             (np.sin(np.arange(9000) * 0.05), 22050, 2048,
                              512)),
                            ("frame_signal", (np.arange(3000.0), 256, 64,
                                              "constant"))],
            "ref.pyin_ref": [("local_transition", (60, 7)),
                             ("local_transition", (9, 7))],
            "ref.trend_ref": [("_savgol_kernel", (11, 3)),
                              ("rsi", (np.sin(np.arange(80.0)),)),
                              ("adaptive_confidence_threshold",
                               (np.linspace(0, 1, 30),))]}.items():
        t, j = _port_and_original(name)
        for fn, args in calls:
            np.testing.assert_array_equal(getattr(t, fn)(*args),
                                          getattr(j, fn)(*args))
    t, j = _port_and_original("ref.pyin_ref")
    for a, b in zip(t.beta_threshold_probs(tconfig.PyinConfig()),
                    j.beta_threshold_probs(PyinConfig())):
        np.testing.assert_array_equal(a, b)
    t, j = _port_and_original("ref.trend_ref")
    assert (t.ARTIC_NAMES, t.SLIDE_NAMES) == (j.ARTIC_NAMES, j.SLIDE_NAMES)


def _copy_signal_gen():
    t, j = _port_and_original("tools.signal_gen")
    for fn, kw in (("generate_test_track", {"sr": 22050}),
                   ("generate_scale_benchmark", {"sr": 22050}),
                   ("generate_bench_track", {"duration": 3.0, "sr": 22050,
                                             "return_truth": True})):
        for a, b in zip(getattr(t, fn)(**kw), getattr(j, fn)(**kw)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _copy_io(tmp_path):
    t, j = _port_and_original("io")
    y = generate_test_track(sr=22050)[0][:22050]
    t.write_wav(str(tmp_path / "t.wav"), y, 22050)
    j.write_wav(str(tmp_path / "j.wav"), y, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    for sr in (22050, 16000):   # as stored, and resampled
        (a, ra), (b, rb) = (m.load_audio(str(tmp_path / "t.wav"), sr=sr)
                            for m in (t, j))
        assert ra == rb
        np.testing.assert_array_equal(a, b)


def _copy_midi():
    t, j = _port_and_original("midi")
    events = _events_for_copies()
    for fn, kw in (("events_to_midi", {"bpm": 96}), ("events_to_midi", {}),
                   ("events_to_midi_financial", {})):
        a, b = io.BytesIO(), io.BytesIO()
        getattr(t, fn)([dict(e) for e in events], 22050, 512, output=a, **kw)
        getattr(j, fn)([dict(e) for e in events], 22050, 512, output=b, **kw)
        assert a.getvalue() == b.getvalue() and a.getvalue()[:4] == b"MThd"
        assert t.midi_to_notes(a.getvalue()) == j.midi_to_notes(b.getvalue())


def _copy_metrics_tempo_harmony():
    t, j = _port_and_original("verify.metrics")
    events = _events_for_copies()
    sa, sb = (m.events_to_seconds(events, 22050, 512) for m in (t, j))
    assert sa == sb
    assert t.note_event_f1(sa, sb[:-1]) == j.note_event_f1(sa, sb[:-1])
    t, j = _port_and_original("core.tempo")
    env = np.abs(np.sin(np.arange(900) * 2 * np.pi / 21.5)) ** 8
    raw = {"onset_env": env}
    assert t.estimate_bpm(raw, 22050, 512) == j.estimate_bpm(raw, 22050, 512)
    assert t.parse_bpm("auto") == j.parse_bpm("auto")
    t, j = _port_and_original("harmony.key")
    notes = np.array([60, 62, 64, 65, 67, 69, 71, 72, 61, 64, 67])
    assert t.HarmonicAnalyzer().detect_key(notes) == \
        j.HarmonicAnalyzer().detect_key(notes)


def _copy_events_helpers():
    """The copied extractors and helpers on the JAX engine's own rows."""
    t, j = _port_and_original("core.events")
    y = generate_scale_benchmark(sr=22050)[0]
    raw = JaxEngine(sample_rate=22050, backend="device").audio_to_midi(y)
    args = (raw["rake_mask"], raw["f0"], raw["voiced_flag"],
            raw["voiced_probs"], raw["rms"], 22050, 512)
    for kw in ({}, {"onset_env": raw["onset_env"]},
               {"onset_env": raw["onset_env"], "onset_fwd_snap_ms": 60.0}):
        assert t.extract_events_v1(*args, confidence_threshold=0.3, **kw) == \
            j.extract_events_v1(*args, confidence_threshold=0.3, **kw)
    ev = j.extract_events_v1(*args, confidence_threshold=0.3)
    many = [dict(e, start=e["start"] + 3 * k, end=e["end"] + 3 * k)
            for k in range(4) for e in ev]
    assert t.filter_ghost_notes_rsi(many, 22050, 512, 55.0) == \
        j.filter_ghost_notes_rsi(many, 22050, 512, 55.0)
    a = t.apply_harmonic_context([dict(e) for e in ev], 22050, 512, 0.5)
    b = j.apply_harmonic_context([dict(e) for e in ev], 22050, 512, 0.5)
    assert a == b


def _copy_native(monkeypatch):
    """The C++ host cores against their NumPy twins, and a library of their
    own beside the JAX package's."""
    from aegis_tpu_torch import native as tnat
    from aegis_tpu_torch.core import events as tev
    from aegis_tpu_torch.core import trend_fast
    from aegis_tpu_torch.ref import trend_ref
    import aegis_tpu.native as jnat
    assert tnat._cache_dir() != jnat._cache_dir()
    if tnat.get_lib() is None:
        pytest.skip("no C++ compiler: the NumPy twins are the only path")
    y = generate_test_track(sr=22050)[0]
    raw = AegisEngine(sample_rate=22050, device="cpu").audio_to_midi(y)
    args = (raw["rake_mask"], raw["f0"], raw["voiced_flag"],
            raw["voiced_probs"], raw["rms"], 22050, 512)
    fast = tev.extract_events_v1(*args, confidence_threshold=0.3)
    monkeypatch.setattr(tnat, "segment_events_v1_native",
                        lambda *a, **k: None)
    assert tev.extract_events_v1(*args, confidence_threshold=0.3) == fast
    x = np.abs(np.sin(np.arange(200.0) / 7.0)) * 5.0
    np.testing.assert_array_equal(trend_fast.rsi(x), trend_ref.rsi(x))


def _copy_quantize_pcm4():
    from aegis_tpu.core import analyze as janalyze
    from aegis_tpu_torch.core import analyze as tanalyze
    assert tanalyze.PCM4_BLOCK == janalyze.PCM4_BLOCK
    rng = np.random.default_rng(4)
    y = rng.standard_normal(4096).astype(np.float32) * 0.3
    y[:128] = 0.0   # a silent block: scale 0
    for block in (128, 256):
        for a, b in zip(tanalyze.quantize_pcm4(y, block),
                        janalyze.quantize_pcm4(y, block)):
            np.testing.assert_array_equal(a, b)
    for mod in (tanalyze, janalyze):
        with pytest.raises(ValueError):
            mod.quantize_pcm4(y[:100])


def _copy_masks_ref():
    t, j = _port_and_original("ref.masks_ref")
    rng = np.random.default_rng(5)
    S = (rng.random((300, 128)) * -90.0).astype(np.float32)
    S[40] = -3.0             # a broadband burst of one frame (23 ms)
    S[100:110, :64] = -10.0  # low-heavy frames
    f0 = np.where(rng.random(300) < 0.7, rng.uniform(40, 400, 300), np.nan)
    voiced = ~np.isnan(f0)
    rake = t.detect_rake(S, 512, 22050, 0.6)
    assert rake.any()
    np.testing.assert_array_equal(rake, j.detect_rake(S, 512, 22050, 0.6))
    np.testing.assert_array_equal(t.detect_palm_mute(S, 512, 22050),
                                  j.detect_palm_mute(S, 512, 22050))
    np.testing.assert_array_equal(t.enhance_rake(S, 512, 22050, rake),
                                  j.enhance_rake(S, 512, 22050, rake))
    for a, b in zip(t.filter_subharmonic(f0, voiced),
                    j.filter_subharmonic(f0, voiced)):
        np.testing.assert_array_equal(a, b)
    assert t.distortion_score(S) == j.distortion_score(S)
    np.testing.assert_array_equal(t.run_length_keep(rake, 1, 3),
                                  j.run_length_keep(rake, 1, 3))


def _copy_pitchnet_post_ref():
    t, j = _port_and_original("ref.pitchnet_post_ref")
    rng = np.random.default_rng(6)
    voiced = rng.random(80) < 0.6
    f0 = np.where(voiced, rng.uniform(80, 900, 80), 1.0)
    np.testing.assert_array_equal(t.smooth_f0_median_ref(f0, voiced),
                                  j.smooth_f0_median_ref(f0, voiced))
    env = rng.random(80) * 0.2
    env[rng.integers(0, 80, 5)] = 1.0
    pitch = {"f0": np.where(voiced, f0, np.nan), "voiced_flag": voiced,
             "voiced_probs": np.where(voiced, 0.9, 0.1)}
    for fps in (43.07, 86.13):
        a, b = (m.onset_backfill_ref(dict(pitch), env, fps) for m in (t, j))
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("what", [
    "config", "filters", "ref", "signal_gen", "io", "midi",
    "metrics_tempo_harmony", "events_helpers", "native", "quantize_pcm4",
    "masks_ref", "pitchnet_post_ref"])
def test_copy_equals_its_original(what, tmp_path, monkeypatch):
    """The port keeps its own copy of each host module it uses; a copy that
    drifts from ``aegis_tpu``'s (other arrays, other MIDI bytes, other
    events) fails here."""
    fn = globals()[f"_copy_{what}"]
    kw = {"io": {"tmp_path": tmp_path}, "native": {"monkeypatch": monkeypatch}}
    fn(**kw.get(what, {}))


def test_cuda_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        AegisEngine(sample_rate=22050, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        AegisEngine(sample_rate=22050)  # the default device is cuda
    with pytest.raises(RuntimeError, match="is_available"):
        AegisFinancialEngine(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        AegisFinancialEngine()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No result without a card, and none from the script outside the repo."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
