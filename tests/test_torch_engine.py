"""aegis_tpu_torch v1 engine vs the JAX engine, end to end on the CPU, and
the guards that keep the port honest (no JAX, no silent CPU run, no
silent success without a card)."""

import io
import os
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
    got = run_analyze(y, audio, cfg, transport=transport)
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
    """What stays unported raises: the neural pitch backend on both facades,
    the poly and auto folder engines; an unknown turbo mode is an error."""
    y = np.zeros(22050, np.float32)
    eng = AegisEngine(sample_rate=22050, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.audio_to_midi(y, pitch_backend="neural")
    with pytest.raises(NotImplementedError):
        AegisFinancialEngine(device="cpu").analyze(y, pitch_backend="neural")
    for engine in ("poly", "auto"):
        with pytest.raises(NotImplementedError):
            transcribe_folder(str(tmp_path), engine=engine, device="cpu")
    with pytest.raises(NotImplementedError):
        transcribe_folder(str(tmp_path), pitch_backend="neural", device="cpu")
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


# ------------------------------------------------------------------ guards

def test_port_never_imports_jax():
    """With jax made unimportable, the port still runs the v1 path fused,
    tiled and streamed, the financial engine, and the folder sweep."""
    code = (
        "import sys, os, tempfile\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, io\n"
        "from aegis_tpu.io import write_wav\n"
        "from aegis_tpu_torch.engine.engine import AegisEngine\n"
        "from aegis_tpu_torch.engine.financial import AegisFinancialEngine\n"
        "from aegis_tpu_torch.engine.folder import transcribe_folder\n"
        "from aegis_tpu.tools.signal_gen import generate_test_track\n"
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
        "loaded = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert all(sys.modules[m] is None for m in loaded), loaded\n"
        "print('ok', len(events))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO),
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("ok")


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
