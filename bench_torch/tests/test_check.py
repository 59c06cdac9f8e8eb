"""CPU tests of what decides ``correct``: the frozen host copies equal the
program's today; at a test size each cell's run on the program comes out
correct, and its control (a lower-precision ingest) and each fault the
cell can have come out not correct.  The same comparisons run on the chip
at the cells' own sizes (``python3 bench_torch/run.py ... --control``).

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import run, takes  # noqa: E402
from bench_torch.reference import host_poly, host_v1  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 77


def _cell(workload: str):
    wl = next(w for w in BENCH["workloads"] if w["name"] == workload)
    cfg = run.load_json(run.HERE / "configs" / f"{wl['config']}.json")
    mix = run.load_json(run.HERE / "traffic" / f"{wl['traffic']}.json")
    # a test size: short takes (a long one for the live session), a short
    # window; every width as the cell has it
    mix["takes"]["lengths_s"] = [40] if mix["load"] == "live" else [3, 5]
    mix["trace_items"] = 2
    return cfg, mix


def _run(workload: str, control: bool = False) -> dict:
    cfg, mix = _cell(workload)
    run.set_cache_dirs()
    return run.run_cell(BENCH, workload, SEED, 2.0, 0, "cpu", control,
                        cfg, mix)


def _take(seconds: float, sr: int = 44100):
    (_, pcm), = takes.make_takes({"generator": "bench_track",
                                  "lengths_s": [seconds]}, 5, sr)
    return pcm


# ------------------------------------------------------- the frozen copies

def test_host_v1_copy_equals_the_programs_extractor_and_encoder():
    from aegis_tpu_torch.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=44100, device="cpu")
    raw = eng.audio_to_midi(takes.pcm_float(_take(6.0)))
    for kw in ({}, {"min_note_duration_ms": 100, "sustain_ms": 200}):
        want = eng.extract_events(raw, None, **kw)
        got = host_v1.extract_events_v1(
            rake_mask=raw["rake_mask"], f0=raw["f0"],
            voiced_flag=raw["voiced_flag"], active_probs=raw["voiced_probs"],
            rms=raw["rms"], sr=44100, hop_length=512,
            onset_env=raw["onset_env"], **kw)
        assert got == want and len(got) > 3
    from aegis_tpu_torch.midi.encode import events_to_midi

    assert host_v1.events_to_midi(got, 44100, 512, midi_program=27) == \
        events_to_midi(got, 44100, 512, midi_program=27)


def test_host_poly_copy_equals_the_programs_chain():
    from aegis_tpu_torch.engine.poly import AegisPolyEngine

    y, _ = takes.generate_chord_progression(9, 44100)
    eng = AegisPolyEngine(sample_rate=44100, device="cpu")
    analysis = eng.analyze(y)
    want = eng.extract_events(analysis, None, confidence_threshold=0.5)
    got = host_poly.extract_events_poly(analysis, 44100, eng.hop_length,
                                        eng.n_fft, confidence_threshold=0.5)
    assert got == want and len(got) > 3


# ---------------------------------------- correct, and its control is not

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_comes_out_correct_and_its_control_not(workload):
    ok = _run(workload)
    assert ok["correct"], ok["checks"]
    bad = _run(workload, control=True)
    assert not bad["correct"], bad["checks"]


# ----------------------------------------------------------------- faults

def _shift_first_note(events):
    events = [dict(e) for e in events]
    if events:
        events[0]["note"] += 1
    return events


def test_an_altered_answer_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine import engine as engine_mod

    real = engine_mod.extract_events_v1
    monkeypatch.setattr(engine_mod, "extract_events_v1",
                        lambda **kw: _shift_first_note(real(**kw)))
    assert not _run("v1_rest_mono")["correct"]


def test_an_altered_chord_answer_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine.poly import AegisPolyEngine

    real = AegisPolyEngine.extract_events
    monkeypatch.setattr(AegisPolyEngine, "extract_events",
                        lambda self, *a, **kw: _shift_first_note(
                            real(self, *a, **kw)))
    assert not _run("poly_rest_chords")["correct"]


def test_an_altered_live_answer_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine.realtime import StreamingTranscriber

    real = StreamingTranscriber.poll_events
    monkeypatch.setattr(StreamingTranscriber, "poll_events",
                        lambda self: _shift_first_note(real(self)))
    assert not _run("v1_live_mono")["correct"]


def test_an_altered_folder_answer_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine import folder as folder_mod

    real = folder_mod.extract_events_v1
    monkeypatch.setattr(folder_mod, "extract_events_v1",
                        lambda **kw: _shift_first_note(real(**kw)))
    assert not _run("v1_folder_mono")["correct"]


def test_half_of_a_folder_left_out_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine import folder as folder_mod

    real = folder_mod.glob.glob
    monkeypatch.setattr(folder_mod.glob, "glob",
                        lambda pat: sorted(real(pat))[::2])
    res = _run("v1_folder_mono")
    assert not res["correct"] and res["failed"] > 0


def test_half_of_a_take_left_out_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine.engine import AegisEngine

    real = AegisEngine.audio_to_midi
    monkeypatch.setattr(AegisEngine, "audio_to_midi",
                        lambda self, y, *a, **kw: real(
                            self, np.asarray(y)[:len(y) // 2], *a, **kw))
    assert not _run("v1_rest_mono")["correct"]


def test_half_of_each_chunk_left_out_is_not_correct(monkeypatch):
    from aegis_tpu_torch.engine.realtime import StreamingTranscriber

    real = StreamingTranscriber.feed
    monkeypatch.setattr(StreamingTranscriber, "feed",
                        lambda self, chunk: real(self,
                                                 chunk[:len(chunk) // 2]))
    assert not _run("v1_live_mono")["correct"]


# ------------------------------------- the configuration reaches the program

def _changed(cfg: dict, group: str, **numbers) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg[group].update(numbers)
    return cfg


def test_a_finer_pitch_grid_reaches_the_rest_servers_engine(monkeypatch):
    """A configuration at resolution 0.05 (n = 900) runs the server's v1
    engine at 900 pitch bins, and the reference agrees with it there."""
    from aegis_tpu_torch.engine import engine as engine_mod

    seen = []
    real = engine_mod.analyze_pyin

    def spy(y, audio, pyin_cfg, *a, **kw):
        seen.append(pyin_cfg.n_pitch_bins)
        return real(y, audio, pyin_cfg, *a, **kw)

    monkeypatch.setattr(engine_mod, "analyze_pyin", spy)
    cfg, mix = _cell("v1_rest_mono")
    cfg = _changed(cfg, "pyin", resolution=0.05)
    res = run.run_cell(BENCH, "v1_rest_mono", SEED, 2.0, 0, "cpu", False,
                       cfg, mix)
    assert seen and set(seen) == {900}
    assert res["correct"], res["checks"]


def test_a_finer_pitch_grid_reaches_the_live_session(monkeypatch):
    from aegis_tpu_torch.engine import realtime

    seen = []
    real = realtime._tile_program

    def spy(audio, pyin_cfg, *a, **kw):
        seen.append(pyin_cfg.n_pitch_bins)
        return real(audio, pyin_cfg, *a, **kw)

    monkeypatch.setattr(realtime, "_tile_program", spy)
    cfg, mix = _cell("v1_live_mono")
    cfg = _changed(cfg, "pyin", resolution=0.05)
    res = run.run_cell(BENCH, "v1_live_mono", SEED, 2.0, 0, "cpu", False,
                       cfg, mix)
    assert seen and set(seen) == {900}
    assert res["correct"], res["checks"]


def test_fewer_voices_reach_the_chord_engine(monkeypatch):
    from aegis_tpu_torch.engine import poly as poly_mod

    seen = []
    real = poly_mod.dispatch_analyze_poly

    def spy(y, sr, n_fft, hop_length, n_bins, bins_per_octave, max_voices,
            **kw):
        seen.append((n_fft, hop_length, max_voices))
        return real(y, sr, n_fft, hop_length, n_bins, bins_per_octave,
                    max_voices, **kw)

    monkeypatch.setattr(poly_mod, "dispatch_analyze_poly", spy)
    cfg, mix = _cell("poly_rest_chords")
    cfg = _changed(cfg, "peel", max_voices=4)
    res = run.run_cell(BENCH, "poly_rest_chords", SEED, 2.0, 0, "cpu", False,
                       cfg, mix)
    assert seen and set(seen) == {(4096, 1024, 4)}
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload,group,numbers,named", [
    ("v1_folder_mono", "pyin", {"resolution": 0.05}, "pyin.resolution"),
    ("v1_folder_mono", "audio", {"hop_length": 256}, "audio.hop_length"),
    ("poly_rest_chords", "peel", {"alpha": 0.5}, "peel.alpha"),
    ("v1_rest_mono", "ingest", {"block": 512}, "ingest.block"),
])
def test_numbers_the_program_cannot_be_given_are_refused(workload, group,
                                                         numbers, named):
    cfg, mix = _cell(workload)
    cfg = _changed(cfg, group, **numbers)
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        run.run_cell(BENCH, workload, SEED, 2.0, 0, "cpu", False, cfg, mix)


# --------------------------------------------- a live take that runs out

def test_a_live_session_that_outruns_its_take_starts_again():
    from bench_torch.checks import live as live_check
    from bench_torch.loads import live as live_load

    cfg, mix = _cell("v1_live_mono")
    mix["takes"]["lengths_s"] = [3]
    mix["live"]["warm_chunks"] = 2
    load = live_load.Load(cfg, mix, SEED, "cpu", str(ROOT))
    load.setup()
    items = load.traced(14, warm=False)          # 6 chunks a session
    assert len(items) == 14
    assert len({id(rt) for rt, _, _ in load.polls}) == 3
    samples = load.samples(np.random.default_rng(3))
    numbers = live_check.check(samples, cfg, mix, "cpu")
    limits = cfg["check"]["limits"]["live"]
    assert all(numbers[k] <= limits[k] for k in numbers), numbers
