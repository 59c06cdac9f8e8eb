"""The financial folder batch as ``bench_torch/configs/financial_22k.json``
runs it, on the CPU (no JAX).  The program's financial tail against the
float64 reference (``bench_torch/reference/financial_device.py``) on seeded
NaN-gapped, octave-jumping f0 tracks; the frozen host chain
(``reference/host_financial.py``) against the program's; the cell's check
on seeded bench takes through ``transcribe_folder(engine="financial",
device="cpu")``: correct on the program, not correct under the int4
control and two planted faults; the new spans, nested as the program opens
them, and outputs bitwise the same with the spans off; the new per-layer
readers against recorded slices."""

import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aegis_tpu_torch.config import AudioConfig, PyinConfig  # noqa: E402
from aegis_tpu_torch.core import analyze, events as events_mod  # noqa: E402
from aegis_tpu_torch.core import trend  # noqa: E402
from aegis_tpu_torch.engine import folder as folder_mod  # noqa: E402
from aegis_tpu_torch.midi.encode import events_to_midi_financial  # noqa: E402
from aegis_tpu_torch.utils import prof  # noqa: E402
from bench_torch import run, takes  # noqa: E402
from bench_torch.checks import financial as fin_check  # noqa: E402
from bench_torch.reference import financial_device, host_financial  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
CFG = run.load_json(run.HERE / "configs" / "financial_22k.json")
MIX = run.load_json(run.HERE / "traffic" / "folder_financial.json")
LIMITS = CFG["check"]["limits"][MIX["check"]]
SR, HOP = CFG["audio"]["sample_rate"], CFG["audio"]["hop_length"]
AUDIO = AudioConfig(sample_rate=SR)
SEED = 2**31 + 61
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the reference's decode is thousands of small
    ops, which a worker sharing its cores with other workers' threads
    would otherwise spend spinning at barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _take(seconds: float, seed: int = SEED) -> np.ndarray:
    (_, pcm), = takes.make_takes({"generator": "bench_track",
                                  "lengths_s": [seconds]}, seed, SR)
    return pcm


def _run(seed: int = SEED, control: bool = False, lengths=(8, 15)) -> dict:
    mix = copy.deepcopy(MIX)
    mix["takes"]["lengths_s"] = list(lengths)
    mix["trace_items"] = 1
    run.set_cache_dirs()
    return run.run_cell(BENCH, "financial_folder", seed, 1.0, 0, "cpu",
                        control, CFG, mix)


# -------------------------------------------- the tail against the reference

def _f0_track(seed: int, T: int = 900) -> np.ndarray:
    """Held pitches of the configuration's grid in runs of 3-40 frames,
    with NaN gaps, octave jumps up and down, sub-E2 pitches (an octave
    error where twice lies in [82.4, 329.6) Hz, else dropped)."""
    rng = np.random.default_rng(seed)
    p = CFG["pyin"]
    grid = financial_device.v1_device.bin_hz(p["fmin"], 450, 10)
    f0 = np.full(T, np.nan, np.float32)
    f0[:5], f0[5:10] = grid[3] / np.float32(2), grid[5]   # dropped, doubled
    t = 10
    while t < T:
        n = int(rng.integers(3, 40))
        kind = rng.random()
        if kind < 0.15:
            pass                                     # unvoiced gap
        elif kind < 0.25:                            # under E2
            f0[t:t + n] = grid[int(rng.integers(0, 10))] / np.float32(
                rng.choice([1.0, 2.0]))
        else:
            f0[t:t + n] = grid[int(rng.integers(40, 450))]
            if rng.random() < 0.3:                   # an octave jump inside
                k = t + n // 2
                f0[k:t + n] = f0[k:t + n] * np.float32(rng.choice([0.5, 2]))
        t += n
    return f0


def _mel(seed: int, T: int) -> np.ndarray:
    """(T, 128) dB: a level that wanders, jumps of 12-20 dB that decay,
    and runs whose low bands sit far under the high ones."""
    rng = np.random.default_rng(seed + 1)
    level = np.clip(-40 + np.cumsum(rng.normal(0, 1.5, T)), -75, -8)
    for k in rng.choice(T - 10, T // 60, replace=False):
        level[k:k + 8] += np.linspace(18, 0, 8)
    slope = np.linspace(0, -1, 128)[None, :] * rng.uniform(5, 30, (T, 1))
    mel = level[:, None] + slope + rng.normal(0, 2, (T, 128))
    for k in rng.choice(T - 3, T // 40, replace=False):
        mel[k:k + 2, :64] -= 60
    return np.clip(mel, -80, 0).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_tail_is_the_float64_reference(seed):
    """The guitar filters and the trend stack of ``core/analyze.py::
    financial_tail`` against the reference's loops: masks, f0 and codes
    equal (articulation codes off the rounding ties), the trend and the
    confidences within the check's limits."""
    f0 = _f0_track(seed)
    T = len(f0)
    rng = np.random.default_rng(seed + 2)
    base = {"f0": f0, "voiced_flag": ~np.isnan(f0),
            "voiced_probs": rng.uniform(0, 1, T).astype(np.float32),
            "rake_mask": rng.random(T) < 0.03, "mel_db": _mel(seed, T)}
    got = {k: v.numpy() for k, v in analyze.financial_tail(
        {k: torch.as_tensor(v) for k, v in base.items()}, AUDIO).items()}
    ref = financial_device.tail(
        {k: (np.asarray(v, np.float64) if v.dtype == np.float32 else v)
         for k, v in base.items()}, CFG)
    assert np.array_equal(np.asarray(got["f0"], np.float64), ref["f0"],
                          equal_nan=True)
    assert np.isnan(ref["f0"]).sum() > np.isnan(f0).sum()   # sub-E2 dropped
    assert (ref["f0"][~np.isnan(f0)] != f0[~np.isnan(f0)]).any()  # doubled
    for key in ("voiced_flag", "rake_mask", "mute_mask", "slide_codes"):
        assert np.array_equal(got[key], ref[key]), key
    # at hop 512 and 22 050 Hz the rake enhancement's 30 ms window is one
    # frame, whose mean is the jump itself: it never fires
    assert ref["mute_mask"].any()
    assert np.array_equal(ref["rake_mask"], base["rake_mask"])
    open_ = ~ref["artic_ties"]
    assert open_.sum() > T // 4
    assert np.array_equal(got["artic_codes"][open_], ref["artic_codes"][open_])
    assert set(np.unique(ref["artic_codes"])) >= {0, 1, 2, 4}
    assert np.array_equal(np.isnan(got["trend"]), np.isnan(ref["trend"]))
    assert fin_check.trend_gap_p99(got, ref) <= LIMITS["trend_gap_p99"]
    # a held pitch's band has no width in float64 and a float32 one of a
    # few ulps of its Hz (1.2e-4 at 2 kHz), four of them in 1 / (1 + width)
    for key in ("financial_confidence", "combined_confidence"):
        gap = np.abs(np.asarray(got[key], np.float64) - ref[key])
        assert np.percentile(gap, 99) <= 2e-3, key
    assert abs(float(got["adaptive_threshold"])
               - ref["adaptive_threshold"]) <= LIMITS["threshold_gap"]
    assert abs(float(got["distortion_score"]) - ref["distortion_score"]) \
        <= 1e-5 * abs(ref["distortion_score"])


def test_the_frozen_host_chain_is_the_programs():
    """On the reference's rows of a 12 s take, the program's financial
    extractor and writer give the frozen copy's events and bytes."""
    ref = financial_device.analyze(_take(12.0), CFG, "cpu")
    kw = dict(rake_mask=ref["rake_mask"], f0=ref["f0"],
              voiced_flag=ref["voiced_flag"], active_probs=ref["voiced_probs"],
              rms=ref["rms"], sr=SR, hop_length=HOP, trend=ref["trend"],
              artic_codes=ref["artic_codes"], slide_codes=ref["slide_codes"],
              financial_confidence=ref["financial_confidence"],
              onset_env=ref["onset_env"])
    want, want_info = events_mod.extract_events_financial(**kw)
    got, got_info = host_financial.extract_events_financial(**kw)
    assert got == want and len(got) > 10
    assert got_info == want_info and want_info["key_info"] is not None
    assert {e["track"] for e in got} == {"main", "safe"}
    assert host_financial.events_to_midi_financial(got, SR, HOP) == \
        events_to_midi_financial(want, SR, HOP)


# ------------------------------------------------- the cell's check

@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_folder_is_the_reference(seed):
    """Every number within its limit, rows and MIDI of both named tracks."""
    res = _run(seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(LIMITS)


def test_the_int4_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"], res["checks"]


def test_a_trend_of_raw_f0_is_not_correct(monkeypatch):
    """The consensus skipped: the trend row is the cleaned f0 itself."""
    monkeypatch.setattr(trend, "multi_filter_consensus",
                        lambda data: (data, torch.ones_like(data)))
    res = _run()
    assert not res["correct"]
    assert res["checks"]["trend_gap_p99"]["value"] > LIMITS["trend_gap_p99"]


def test_articulation_codes_a_frame_late_are_not_correct(monkeypatch):
    """One take's articulation codes, as fetched, shifted one frame on."""
    real = folder_mod.fetch_analyze
    fetched = []

    def late(handle):
        rows = real(handle)
        if len(fetched) % 2 == 0:
            codes = rows["artic_codes"]
            rows["artic_codes"] = np.concatenate([codes[:1], codes[:-1]])
        fetched.append(1)
        return rows

    monkeypatch.setattr(folder_mod, "fetch_analyze", late)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["code_miss_pct"]["value"] > LIMITS["code_miss_pct"]


# ------------------------------------------------------------ the spans

SECONDS = (6.0, 7.0)


def _folder(tmp: str, seconds=SECONDS) -> str:
    src = os.path.join(tmp, "in")
    os.makedirs(src)
    for i, s in enumerate(seconds):
        with open(os.path.join(src, f"t{i}.wav"), "wb") as f:
            f.write(takes.wav_bytes(_take(s, SEED + i), SR))
    return src


def _transcribe(src: str, out: str, engine: str = "financial"):
    return folder_mod.transcribe_folder(src, output_dir=out, sample_rate=SR,
                                        engine=engine, device="cpu")


def _new_spans(before: set) -> list:
    """The spans recorded since ``before``, less the interpreter's
    collections, which land wherever one happens to run."""
    return [s for s in prof.spans()
            if s.index not in before and s.name != prof.GC_SPAN]


@pytest.mark.parametrize("engine", ["financial", "v1"])
def test_the_folder_records_its_spans_nested(engine):
    """Financial: one ``aegis.fin_extract`` a track (frames, Main and Safe
    events) over ``aegis.fin_segment``, ``aegis.fin_ghost`` and
    ``aegis.fin_harmonic`` in order, inside ``folder.extract``; both
    engines: one ``folder.midi`` a track, inside ``folder.extract``."""
    with tempfile.TemporaryDirectory() as tmp:
        src = _folder(tmp)
        before = {s.index for s in prof.spans()}
        with torch.profiler.profile(activities=CPU):
            res = _transcribe(src, os.path.join(tmp, "out"), engine)
        new = _new_spans(before)
    extract = sorted((s for s in new if s.name == "folder.extract"),
                     key=lambda s: s.start_ns)
    midi = sorted((s for s in new if s.name == "folder.midi"),
                  key=lambda s: s.start_ns)
    assert [s.attrs for s in midi] == [{"track": 0}, {"track": 1}]
    assert [s.parent for s in midi] == [s.index for s in extract]
    fin = sorted((s for s in new if s.name == "aegis.fin_extract"),
                 key=lambda s: s.start_ns)
    if engine == "v1":
        assert not fin
        return
    assert [s.parent for s in fin] == [s.index for s in extract]
    for root, (_, _, n), track, seconds in zip(fin, res, extract, SECONDS):
        assert root.attrs["frames"] == 1 + int(seconds * SR) // HOP
        assert root.attrs["events_main"] + root.attrs["events_safe"] == n > 10
        kids = sorted((s for s in new if s.parent == root.index),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["aegis.fin_segment",
                                          "aegis.fin_ghost",
                                          "aegis.fin_harmonic"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert root.end_ns <= midi[track.attrs["track"]].start_ns


def test_the_spans_change_no_output():
    """Rows and MIDI bytes the same with no profiler, with one, and with
    the span recorder taken out of the extractor and the folder."""
    with tempfile.TemporaryDirectory() as tmp:
        src = _folder(tmp)
        rows = []
        real = folder_mod.fetch_analyze

        def tap(handle):
            rows.append(real(handle))
            return rows[-1]

        outs = []
        folder_mod.fetch_analyze = tap
        try:
            for k in range(3):
                out = os.path.join(tmp, f"o{k}")
                if k == 1:
                    with torch.profiler.profile(activities=CPU):
                        _transcribe(src, out)
                elif k == 2:
                    off = lambda name, **attrs: prof._OFF  # noqa: E731
                    saved = events_mod.phase, folder_mod.phase
                    events_mod.phase = folder_mod.phase = off
                    try:
                        _transcribe(src, out)
                    finally:
                        events_mod.phase, folder_mod.phase = saved
                else:
                    _transcribe(src, out)
                outs.append([open(os.path.join(out, f"t{i}.mid"), "rb").read()
                             for i in range(2)])
        finally:
            folder_mod.fetch_analyze = real
    assert outs[0] == outs[1] == outs[2] and all(outs[0])
    assert len(rows) == 6
    for a, b in zip(rows[:2] * 2, rows[2:]):
        assert set(a) == set(b)
        for key in a:
            assert np.asarray(a[key]).tobytes() == \
                np.asarray(b[key]).tobytes(), key


# ---------------------------------------------------------- the readers

def _reader(name):
    return run.load_file_module(run.HERE / "metrics" / f"{name}.py").read


def test_the_span_readers_read_a_recorded_folder_pass():
    """A pass of two tracks recorded under the profiler: each reader's
    number from the spans it names, the events from the folder's answer;
    a slice with none of the spans reads None."""
    with tempfile.TemporaryDirectory() as tmp:
        src = _folder(tmp)
        t0 = time.time_ns()
        with torch.profiler.profile(activities=CPU):
            res = _transcribe(src, os.path.join(tmp, "out"))
        t1 = time.time_ns()
    item = {"t0": t0, "t1": t1, "ms": (t1 - t0) / 1e6, "n_tracks": 2}
    sl = Slice(ops=[], t0=t0, t1=t1, items=[item], spans=[], cfg=CFG)
    spans = [s for s in prof.spans() if t0 <= s.start_ns <= t1]

    def mean_ms(name):
        return sum(s.end_ns - s.start_ns for s in spans
                   if s.name == name) / 1e6 / 2

    for metric, span in (("fin_extract_ms.batch", "aegis.fin_extract"),
                         ("fin_harmonic_ms.batch", "aegis.fin_harmonic"),
                         ("midi_ms.batch", "folder.midi")):
        got = _reader(metric)(sl)
        assert got is not None and got > 0
        assert got == pytest.approx(mean_ms(span), rel=1e-12), metric
    assert _reader("fin_events.batch")(sl) == sum(n for _, _, n in res) / 2
    empty = Slice(ops=[], t0=t1 + 1, t1=t1 + 2, items=[item], spans=[],
                  cfg=CFG)
    for metric in ("fin_extract_ms.batch", "fin_harmonic_ms.batch",
                   "midi_ms.batch", "fin_events.batch", "fin_tail_ms.batch"):
        assert _reader(metric)(empty) is None, metric


def test_the_tail_reader_places_the_tail_in_recorded_replays():
    """Two replays of the fused financial graph recorded on the card (a
    150 s take): the tail is each replay's 1 348 operations after the
    decode's back walk, up to the clone of its packed rows, ~2.02 ms;
    without the boundary kernel the reader reads None."""
    fx = json.loads((Path(__file__).parent / "fin_replay_ops.json")
                    .read_text())
    ops = [(fx["names"][i], float(s), float(e)) for i, s, e in fx["ops"]]
    item = {"t0": 0.0, "t1": ops[-1][2], "n_tracks": 2}
    sl = Slice(ops=ops, t0=0.0, t1=ops[-1][2], items=[item], spans=[],
               cfg=CFG)
    marks = json.loads((run.HERE / "metrics" / "fin_tail_kernels.json")
                       .read_text())
    walks = [k for k, op in enumerate(ops) if marks["boundary"] in op[0]]
    outs = [k for k, op in enumerate(ops)
            if op[0].startswith("Memcpy DtoD") and k > walks[0]]
    assert len(walks) == len(outs) == 2
    assert [b - a - 1 for a, b in zip(walks, outs)] == [1348, 1348]
    want = sum(e - s for a, b in zip(walks, outs)
               for _, s, e in ops[a + 1:b]) / 1e6 / 2
    got = _reader("fin_tail_ms.batch")(sl)
    assert got == pytest.approx(want, rel=1e-12)
    assert 1.9 < got < 2.2
    before = Slice(ops=ops[:walks[0]], t0=0.0, t1=ops[-1][2], items=[item],
                   spans=[], cfg=CFG)
    assert _reader("fin_tail_ms.batch")(before) is None
