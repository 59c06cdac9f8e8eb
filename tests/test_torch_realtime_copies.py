"""The host pieces of the port's live path held equal to their originals in
``aegis_tpu`` (byte for byte where they are float recurrences), the
``stream`` command end to end on the CPU, and the guards of the live entry
points (the card by default, no CPU pick)."""

import importlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aegis_tpu_torch.config import AudioConfig
from aegis_tpu_torch.engine.realtime import StreamingTranscriber
from aegis_tpu_torch.tools.signal_gen import generate_test_track

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 22050


def _both(name):
    return (importlib.import_module(f"aegis_tpu_torch.{name}"),
            importlib.import_module(f"aegis_tpu.{name}"))


def _f0_rows():
    """Seeded f0 rows with NaN gaps, float64 and float32: held pitches, a
    glide, vibrato, noise; leading NaNs; all NaN; one and two valid
    samples."""
    rng = np.random.default_rng(11)
    T = 700
    t = np.arange(T)
    base = np.where(t < 200, 110.0, np.where(t < 400, 146.83, 196.0))
    base = base + np.where((t > 250) & (t < 330), (t - 250) * 0.4, 0.0)
    base = base + 3.0 * np.sin(t / 3.0) * (t > 500)
    noisy = base + rng.normal(0, 0.7, T)
    gaps = noisy.copy()
    gaps[rng.random(T) < 0.15] = np.nan
    gaps[:9] = np.nan
    gaps[300:340] = np.nan
    one = np.full(40, np.nan)
    one[7] = 220.0
    two = one.copy()
    two[20] = 233.0
    rows = [gaps, base.copy(), noisy, np.full(50, np.nan), one, two]
    return [r.astype(dt) for r in rows for dt in (np.float64, np.float32)]


def _same_bytes(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same_bytes(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bytes(x, y, f"{what}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what


_TREND_CALLS = ("ema", "kalman", "holt_winters", "forward_fill", "savgol",
                "macd", "detect_slides_macd", "detect_articulation_bollinger",
                "bollinger_confidence", "multi_filter_consensus",
                "analyze_pitch_financial")


def _copy_trend_fast():
    """Every function of core/trend_fast.py: the copy's bytes equal the
    original's and the oracle's."""
    t, j = _both("core.trend_fast")
    tr, _ = _both("ref.trend_ref")
    public = {n for n, f in vars(j).items()
              if inspect.isfunction(f) and f.__module__ == j.__name__
              and not n.startswith("_")}
    assert public == set(_TREND_CALLS) | {"rsi"}
    for row in _f0_rows():
        for fn in _TREND_CALLS:
            got = getattr(t, fn)(row)
            _same_bytes(got, getattr(j, fn)(row), f"{fn} vs original")
            _same_bytes(got, getattr(tr, fn)(row), f"{fn} vs oracle")
    for x in (np.abs(np.sin(np.arange(200.0) / 7.0)) * 5.0, np.arange(5.0)):
        _same_bytes(t.rsi(x), j.rsi(x), "rsi")
        _same_bytes(t.rsi(x), tr.rsi(x), "rsi vs oracle")


def _copy_trend_ref():
    t, j = _both("ref.trend_ref")
    names = ("sma", "ema", "bollinger", "detect_articulation_bollinger",
             "macd", "detect_slides_macd", "kalman", "holt_winters",
             "forward_fill", "savgol", "multi_filter_consensus",
             "bollinger_confidence", "analyze_pitch_financial", "rsi")
    for row in _f0_rows():
        for fn in names:
            _same_bytes(getattr(t, fn)(row), getattr(j, fn)(row), fn)
    conf = np.linspace(0, 1, 30)
    for method in ("bollinger", "percentile", "other"):
        assert t.adaptive_confidence_threshold(conf, method) == \
            j.adaptive_confidence_threshold(conf, method)
    assert t.adaptive_confidence_threshold(np.zeros(4)) == 0.5


def _copy_native_trend():
    """Each native recurrence against its NumPy twin (the oracle's loop) and
    against the JAX package's binding, bytes equal."""
    t, j = _both("native")
    R, _ = _both("ref.trend_ref")
    if t.get_lib() is None or j.get_lib() is None:
        pytest.skip("no C++ compiler: the NumPy twins are the only path")
    for row in _f0_rows():
        valid = ~np.isnan(row)
        if row.dtype == np.float64:
            a = 2.0 / 13.0
            _same_bytes(t.trend_ema_native(row, a), R.ema(row, 12), "ema")
            _same_bytes(t.trend_ema_native(row, a), j.trend_ema_native(row, a),
                        "ema vs binding")
        sfx = "" if row.dtype == np.float64 else "_f32"
        kal_t, kal_j = (getattr(m, f"trend_kalman{sfx}_native") for m in (t, j))
        holt_t, holt_j = (getattr(m, f"trend_holt{sfx}_native") for m in (t, j))
        if valid.any():
            x0 = float(row[int(np.argmax(valid))])
            got = kal_t(row, 1e-5, 1e-1, x0)
            _same_bytes(got, R.kalman(row), "kalman")
            _same_bytes(got, kal_j(row, 1e-5, 1e-1, x0), "kalman vs binding")
        fv = np.where(valid)[0]
        if len(fv) >= 2:
            l0, t0 = float(row[fv[0]]), float(row[fv[1]] - row[fv[0]])
            got = holt_t(row, 0.3, 0.1, l0, t0)
            _same_bytes(got, R.holt_winters(row), "holt")
            _same_bytes(got, holt_j(row, 0.3, 0.1, l0, t0), "holt vs binding")
        _, up, lo = R.bollinger(row, 10, 2.0)
        got = t.trend_artic_native(row, up, lo)
        _same_bytes(got, R.detect_articulation_bollinger(row), "artic")
        _same_bytes(got, j.trend_artic_native(row, up, lo), "artic vs binding")
    x = np.abs(np.sin(np.arange(90.0) / 5.0))
    d = np.diff(x)
    g, l = np.where(d > 0, d, 0.0), np.where(d < 0, -d, 0.0)
    outs = []
    for m in (t, j):
        ag, al = np.full(90, np.nan), np.full(90, np.nan)
        ag[14], al[14] = np.mean(g[:14]), np.mean(l[:14])
        m.trend_wilder_native(g, l, 90, 14, float(ag[14]), float(al[14]),
                              ag, al)
        outs.append((ag, al))
    _same_bytes(outs[0], outs[1], "wilder vs binding")


def _copy_pick_onsets_incremental():
    """Equal to pick_onsets at every growth step, and to the original."""
    t, j = _both("core.cqt")
    rng = np.random.default_rng(5)
    env = np.abs(rng.normal(0, 0.05, 1500))
    env[rng.integers(0, 1500, 60)] += rng.uniform(0.5, 2.0, 60)
    env[900] = 5.0   # a new global max mid-stream: the full-pick fallback
    st_t = st_j = None
    T = 0
    while T < len(env):
        T = min(T + int(rng.integers(1, 90)), len(env))
        on_t, st_t = t.pick_onsets_incremental(env[:T], SR, 512, st_t)
        on_j, st_j = j.pick_onsets_incremental(env[:T], SR, 512, st_j)
        np.testing.assert_array_equal(on_t, t.pick_onsets(env[:T], SR, 512))
        np.testing.assert_array_equal(on_t, on_j)
    again, _ = t.pick_onsets_incremental(env, SR, 512, st_t)
    assert again is st_t["onsets"]
    assert t.pick_onsets_incremental(np.zeros(0), SR, 512, None)[1] is None


def _events(rng, n=60):
    out, start = [], 0
    for _ in range(n):
        start += int(rng.integers(1, 40))
        out.append({"note": int(rng.integers(40, 46)), "start": start,
                    "end": start + int(rng.integers(2, 50))})
    return out


def _copy_horizon_helpers():
    """_find_cut, _span_cross_fn and _shift_events on seeded events."""
    t, j = _both("engine.realtime")
    assert (t._HZN_K, t._HZN_PRE, t._HZN_QUIET) == \
        (j._HZN_K, j._HZN_PRE, j._HZN_QUIET)
    rng = np.random.default_rng(8)
    for trial in range(6):
        events = _events(rng)
        hi = max(e["end"] for e in events)
        onsets = np.sort(rng.choice(hi, 40, replace=False)).astype(np.int64)
        for gap in (None, 0, 4):
            ct, cj = (m._span_cross_fn(events, chain_gap=gap) for m in (t, j))
            bs = list(range(0, hi + 5, 3))
            assert [ct(b) for b in bs] == [cj(b) for b in bs]
            for quiet in (0, 16):
                for starts in (None, [e["start"] for e in events]):
                    args = dict(lo=trial * 20, hi=hi - 10, quiet=quiet)
                    assert t._find_cut(onsets, cross_fn=ct,
                                       event_starts=starts, **args) == \
                        j._find_cut(onsets, cross_fn=cj,
                                    event_starts=starts, **args)
        assert t._find_cut(np.zeros(0, np.int64), 0, 100, 0, ct) is None
        assert t._span_cross_fn([])(5) is False
        a = t._shift_events([dict(e) for e in events], 17)
        b = j._shift_events([dict(e) for e in events], 17)
        assert a == b


def _copy_rowcat():
    """Append-only use: the two classes return the same bytes at every
    growth step, equal to a fresh concatenate."""
    t, j = _both("engine.realtime")
    rng = np.random.default_rng(1)
    ct, cj = t._RowCat(), j._RowCat()
    rows = []
    for _ in range(40):
        rows.append(rng.normal(0, 1, (int(rng.integers(1, 50)), 7))
                    .astype(np.float32))
        got, want = ct.view(rows), np.concatenate(rows, axis=0)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes() == cj.view(rows).tobytes()
    rows = rows[:5]
    assert ct.view(rows).tobytes() == np.concatenate(rows).tobytes()


@pytest.mark.parametrize("what", [
    "trend_fast", "trend_ref", "native_trend", "pick_onsets_incremental",
    "horizon_helpers", "rowcat"])
def test_copy_equals_its_original(what):
    """The live path's host modules are the port's own copies; one that
    drifts from ``aegis_tpu``'s fails here."""
    globals()[f"_copy_{what}"]()


def test_rowcat_resets_when_the_list_was_regrown():
    """A list truncated and regrown to the same length (or longer) between
    two calls holds other blocks at the cached positions: the cache must
    notice and give the fresh concatenation."""
    from aegis_tpu_torch.engine.realtime import _RowCat

    rng = np.random.default_rng(2)

    def block():
        return rng.normal(0, 1, (8, 3)).astype(np.float32)

    cat = _RowCat()
    rows = [block() for _ in range(6)]
    assert cat.view(rows).tobytes() == np.concatenate(rows).tobytes()
    for regrown in (6, 9):
        rows = rows[:2] + [block() for _ in range(regrown - 2)]
        got = cat.view(rows)
        assert got.tobytes() == np.concatenate(rows).tobytes()
    rows.append(block())    # and goes on appending after the reset
    assert cat.view(rows).tobytes() == np.concatenate(rows).tobytes()


def test_float32_fast_path_needs_numpy_2_promotion(monkeypatch):
    """Under NumPy 1.x's promotion the oracle's kalman / holt run in
    float64 on a float32 row, so the float32 C++ variants must not be
    taken: the gate sends such rows to the oracle."""
    from aegis_tpu_torch import native
    from aegis_tpu_torch.core import trend_fast
    from aegis_tpu_torch.ref import trend_ref

    row = _f0_rows()[1]
    assert row.dtype == np.float32
    assert trend_fast._WEAK_PROMOTION == (int(np.__version__.split(".")[0]) >= 2)
    monkeypatch.setattr(trend_fast, "_WEAK_PROMOTION", False)

    def refuse(*a, **k):
        raise AssertionError("float32 native variant taken")
    monkeypatch.setattr(native, "trend_kalman_f32_native", refuse)
    monkeypatch.setattr(native, "trend_holt_f32_native", refuse)
    monkeypatch.setattr(native, "trend_artic_native", refuse)
    assert not trend_fast._fast_ok32(row)
    _same_bytes(trend_fast.analyze_pitch_financial(row),
                trend_ref.analyze_pitch_financial(row), "gated")
    if native.get_lib() is not None:
        assert trend_fast._fast_ok32(row.astype(np.float64))


def test_native_build_turns_fp_contraction_off(monkeypatch, tmp_path):
    """The host library is built with -ffp-contract=off (no fused
    multiply-add in the recurrences on any ISA), into its own cache."""
    from aegis_tpu_torch import native

    seen = []
    real_run = subprocess.run

    def run(cmd, *a, **k):
        seen.append(list(cmd))
        return real_run(cmd, *a, **k)

    monkeypatch.setenv("AEGIS_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.subprocess, "run", run)
    lib = native.get_lib()
    assert seen and seen[0][0] == "g++" and "-ffp-contract=off" in seen[0]
    assert "-ffast-math" not in seen[0] and not any(
        f.startswith("-march") for f in seen[0])
    if lib is not None:
        assert list((tmp_path / "native").glob("aegis_torch_native_*.so"))
        for sym in ("aegis_trend_ema", "aegis_trend_kalman", "aegis_trend_holt",
                    "aegis_trend_artic", "aegis_trend_kalman_f32",
                    "aegis_trend_holt_f32", "aegis_trend_wilder",
                    "aegis_segment_v1"):
            assert hasattr(lib, sym), sym


# --------------------------------------------------------------------- the CLI

@pytest.mark.parametrize("engine", ["v1", "financial"])
def test_cli_stream_round_trip(engine, tmp_path):
    """s16le PCM on stdin, handed to the command 4097 bytes a read (a pipe
    whose writer flushes at odd counts), so that every other read ends on
    an odd byte: the JSON lines parse, the final list is finalize()'s, the
    MIDI file is the engine-matched encoder's."""
    from aegis_tpu_torch.midi.encode import (events_to_midi,
                                             events_to_midi_financial)

    y, _ = generate_test_track(sr=SR)
    pcm16 = np.round(np.clip(y, -1, 1) * 32767.0).astype("<i2")
    mid = tmp_path / "live.mid"
    short_reads = (
        "import sys, types\n"
        "from aegis_tpu_torch.__main__ import main\n"
        "raw = sys.stdin.buffer\n"
        "sys.stdin = types.SimpleNamespace(buffer=types.SimpleNamespace(\n"
        "    read=lambda n: raw.read(min(n, 4097))))\n"
        "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", short_reads, "stream", str(mid),
         "--engine", engine, "--sr", str(SR), "--device", "cpu",
         "--poll-every", "1.0"],
        input=pcm16.tobytes(), cwd=REPO, capture_output=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr.decode()
    lines = [json.loads(l) for l in proc.stdout.decode().splitlines()]
    assert len(lines) >= 4 and all(d["live"] for d in lines[:-1])
    assert lines[-1]["live"] is False and lines[-1]["n"] > 0
    assert all(d["n"] == len(d["events"]) for d in lines)

    kw = {"confidence_threshold": 0.5} if engine == "v1" else {}
    rt = StreamingTranscriber(audio=AudioConfig(sample_rate=SR),
                              financial=engine == "financial", device="cpu",
                              **kw)
    rt.feed(pcm16.astype(np.float32) / 32768.0)
    events = rt.finalize()
    assert [(d["note"], d["start"], d["end"], d["velocity"], d["track"])
            for d in lines[-1]["events"]] == \
        [(e["note"], e["start"], e["end"], e["velocity"], e["track"])
         for e in events]
    ref = tmp_path / "ref.mid"
    if engine == "financial":
        events_to_midi_financial(events, SR, 512, output=str(ref))
    else:
        events_to_midi(events, SR, 512, midi_program=27, output=str(ref))
    assert mid.read_bytes() == ref.read_bytes()
    assert mid.read_bytes().startswith(b"MThd")


def test_cli_stream_poly_raises():
    """It no longer raises (the test keeps its earlier name):
    ``stream --engine poly`` prints JSON polls and writes the poly
    encoder's MIDI (GM program 25), the finalized transcriber's events."""
    from aegis_tpu_torch.engine.realtime import StreamingPolyTranscriber
    from aegis_tpu_torch.midi.encode import events_to_midi
    from aegis_tpu_torch.tools.signal_gen import generate_chord_progression
    import tempfile

    y, _ = generate_chord_progression(7, SR)
    pcm16 = np.round(np.clip(y, -1, 1) * 32767.0).astype("<i2")
    with tempfile.TemporaryDirectory() as d:
        mid = os.path.join(d, "live.mid")
        proc = subprocess.run(
            [sys.executable, "-m", "aegis_tpu_torch", "stream", mid,
             "--engine", "poly", "--sr", str(SR), "--device", "cpu",
             "--poll-every", "1.0"],
            input=pcm16.tobytes(), cwd=REPO, capture_output=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO),
                 "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stderr.decode()
        assert b"engine=poly" in proc.stderr
        lines = [json.loads(l) for l in proc.stdout.decode().splitlines()]
        assert len(lines) >= 3 and lines[-1]["live"] is False
        assert lines[-1]["n"] > 0 and any(d_["n"] for d_ in lines[:-1])
        rt = StreamingPolyTranscriber(sample_rate=SR, device="cpu")
        rt.feed(pcm16.astype(np.float32) / 32768.0)
        events = rt.finalize()
        assert [(e["note"], e["start"], e["end"], e["velocity"], e["track"])
                for e in lines[-1]["events"]] == \
            [(e["note"], e["start"], e["end"], e["velocity"], e["track"])
             for e in events]
        ref = os.path.join(d, "ref.mid")
        events_to_midi(events, SR, 512, midi_program=25, output=ref)
        with open(mid, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read()


# ------------------------------------------------------------------- guards

def test_live_transcriber_defaults_to_the_card(monkeypatch):
    p = inspect.signature(StreamingTranscriber).parameters["device"]
    assert p.default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        StreamingTranscriber()
    with pytest.raises(RuntimeError, match="is_available"):
        StreamingTranscriber(financial=True, device="cuda")
    with pytest.raises(ValueError):
        StreamingTranscriber(device="meta")


def test_cli_stream_needs_a_card_by_default():
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "stream"], input=b"\0\0",
        cwd=REPO, capture_output=True, timeout=120, env=env)
    assert proc.returncode != 0 and b"is_available" in proc.stderr
    assert b'"live"' not in proc.stdout
