"""Whole songs over REST: the streamed slab program
(``engine/turbo.py::run_analyze_streamed``) as ``bench_torch/configs/
v1_long_44k.json`` serves it, on the CPU.  The program against the plain
streamed reference (``bench_torch/reference/v1_stream.py``) at a small
tiling, seams included; the server the file builds streaming a take past
a lowered threshold; the reference at one tile against the whole-track
reference; the program's spans and slab counter, and outputs bitwise the
same with the spans on and off.  The last two tests run on the card and
skip without one: the slab decode, and whole songs staged on the device
against the host-staged program."""

import base64
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aegis_tpu_torch.config import TurboConfig  # noqa: E402
from aegis_tpu_torch.engine import turbo  # noqa: E402
from aegis_tpu_torch.utils import prof  # noqa: E402
from bench_torch import program, run, takes  # noqa: E402
from bench_torch.checks import v1 as v1_check  # noqa: E402
from bench_torch.checks import v1_grid  # noqa: E402
from bench_torch.checks import v1_stream as stream_check  # noqa: E402
from bench_torch.reference import host_v1, v1_device, v1_stream  # noqa: E402
from test_torch_stream_ingest import host_stage_int8  # noqa: E402

LONG = run.load_json(run.HERE / "configs" / "v1_long_44k.json")
MIX = run.load_json(run.HERE / "traffic" / "rest_long.json")
SR, HOP = LONG["audio"]["sample_rate"], LONG["audio"]["hop_length"]
LIMITS = LONG["check"]["limits"][MIX["check"]]
SEED = 2**31 + 41
CPU = [torch.profiler.ProfilerActivity.CPU]
# a small tiling: 64-frame tiles with 8 halo frames, two tiles a slab
SMALL = {"tile_frames": 64, "halo_frames": 8, "slab_tiles": 2}


def _take(seconds: float, seed: int = SEED) -> np.ndarray:
    (_, pcm), = takes.make_takes({"generator": "bench_track",
                                  "lengths_s": [seconds]}, seed, SR)
    return pcm


def _small_cfg(**stream) -> dict:
    cfg = copy.deepcopy(LONG)
    cfg["stream"].update(SMALL, **stream)
    return cfg


def _stream(pcm, cfg, fetch_group: int = 8) -> dict:
    """The program at the configuration's stream numbers."""
    st = cfg["stream"]
    return turbo.run_analyze_streamed(
        takes.pcm_float(pcm), program.audio_config(cfg),
        program.pyin_config(cfg), cfg["analysis"]["rake_sensitivity"],
        turbo=TurboConfig(tile_frames=st["tile_frames"],
                          halo_frames=st["halo_frames"]),
        slab_tiles=st["slab_tiles"], fetch_mel=True, fetch_group=fetch_group,
        device="cpu")


def _rows(out: dict) -> dict:
    """The program's rows as the engine keeps them (f0 0 where unvoiced)."""
    return dict(out, f0=np.nan_to_num(np.asarray(out["f0"], np.float64)))


def _bins(rows) -> np.ndarray:
    p = LONG["pyin"]
    return v1_grid.bins(rows["f0"], rows["voiced_flag"], p["fmin"],
                        round(1 / p["resolution"]))


@pytest.mark.parametrize("seconds,seed", [(7.0, SEED), (6.2, SEED + 1)])
def test_the_stream_is_the_streamed_reference_at_a_small_tiling(seconds,
                                                                 seed):
    """Three or more slabs of two 64-frame tiles: every row within the
    check's limits, and the decoded states the reference's on 99.9 % of
    the frames or more, the seams between tiles and slabs among them."""
    cfg = _small_cfg()
    pcm = _take(seconds, seed)
    lay = v1_stream.layout(len(pcm), cfg)
    assert lay["slabs"] >= 3 and lay["tiles"] >= 5
    got = _rows(_stream(pcm, cfg))
    ref = v1_stream.analyze(pcm, cfg, "cpu")
    assert len(got["f0"]) == len(ref["f0"]) == lay["frames"]
    gaps = stream_check.row_gaps(got, ref, cfg)
    for key, value in gaps.items():
        assert value <= LIMITS[key], (key, value, LIMITS[key])
    same = _bins(got) == _bins(ref)
    assert np.mean(same) >= 0.999
    seams = np.arange(cfg["stream"]["tile_frames"], lay["frames"],
                      cfg["stream"]["tile_frames"])
    assert same[seams].all() and same[seams - 1].all()
    # the first frame's onset strength is 0 on both sides; the rest is not
    assert got["onset_env"][0] == ref["onset_env"][0] == 0
    assert np.count_nonzero(ref["onset_env"]) > lay["frames"] // 2


def test_the_configured_server_streams_past_a_lowered_threshold():
    """The server ``program.py`` builds from the file, at its own stream
    numbers (1 024-frame tiles), given a 12 s take and a 5 s threshold:
    the answer says "stream", the slab counter moved, and the events and
    MIDI are what the reference host chain makes of the reference's rows
    (start, end and velocity exact, confidence within ``tol``; MIDI
    bytes equal)."""
    pcm = _take(12.0)
    srv = program.server(LONG, "cpu", tempfile.mkdtemp(prefix="long_"))
    up = srv.router.dispatch("POST", "/api/upload", {"name": "take.wav"},
                             takes.wav_bytes(pcm, SR), "audio/wav")
    sid = json.loads(up.content)["session_id"]
    query = {"rake_sensitivity": repr(LONG["analysis"]["rake_sensitivity"]),
             "stream_threshold_s": "5"}
    before = turbo.STREAM_SLABS
    out = srv.router.dispatch("POST", f"/api/analyze/{sid}", query, b"",
                              "application/json")
    assert out.status == 200, out.content[:500]
    body = json.loads(out.content)
    assert body["analysis_mode"] == "stream"
    lay = v1_stream.layout(len(pcm), LONG)
    assert (lay["tiles"], lay["slabs"]) == (2, 1)
    assert turbo.STREAM_SLABS - before == lay["slabs"]
    sess = srv.sessions.get(sid)
    ref = v1_stream.analyze(pcm, LONG, "cpu")
    ref_events = v1_check._events_of(ref, LONG, MIX["extract"])
    got = sess["events"]
    assert len(got) == len(ref_events) >= 5
    keys = ("note", "track", "start", "end", "velocity")
    assert [tuple(e[k] for k in keys) for e in got] == \
        [tuple(e[k] for k in keys) for e in ref_events]
    tol = LONG["check"]["tol"]["confidence"]
    assert all(abs(float(a["confidence"]) - float(b["confidence"])) <= tol
               for a, b in zip(got, ref_events))
    midi = base64.b64decode(body["midi_base64"])
    assert midi == host_v1.events_to_midi(ref_events, SR, HOP, **MIX["midi"])
    # the rows within the check's limits, every decoded state the same
    rows = {k: np.asarray(v) for k, v in sess["raw_data"].items()
            if k != "y" and np.ndim(v) >= 1}
    gaps = stream_check.row_gaps(rows, ref, LONG)
    assert all(gaps[k] <= LIMITS[k] for k in gaps), gaps
    assert gaps["state_miss_pct"] == 0


def test_the_one_tile_reference_is_the_whole_track_reference():
    """With one tile over the whole take, the streamed reference computes
    what the fused reference does on every frame more than a halo from
    either end: the same int8 samples, frame-local observations, and a
    decode that forgets its ends within a halo."""
    pcm = _take(4.0)
    frames = 1 + len(pcm) // HOP
    cfg = _small_cfg(tile_frames=512, halo_frames=16, slab_tiles=16)
    assert v1_stream.layout(len(pcm), cfg)["tiles"] == 1 < frames <= 512
    got = v1_stream.analyze(pcm, cfg, "cpu")
    want = v1_device.analyze(pcm, LONG, "cpu")
    inner = slice(16, frames - 16)
    for key in ("voiced_probs", "rms", "mel_db", "onset_env"):
        np.testing.assert_allclose(got[key][inner], want[key][inner],
                                   rtol=1e-9, atol=1e-9, err_msg=key)
    for key in ("voiced_flag", "rake_mask", "f0"):
        assert np.array_equal(got[key][inner], want[key][inner]), key
    assert np.count_nonzero(want["voiced_flag"][inner]) > frames // 4


def test_the_stream_records_its_spans_in_order_and_counts_its_slabs():
    """Three slabs fetched two at a time: one ``aegis.stream`` with its
    attributes over stage, peak, slab 0, slab 1, a fetch of two, slab 2,
    a fetch of one, unpack; the slab counter moves by three."""
    cfg = _small_cfg()
    pcm = _take(4.2)
    lay = v1_stream.layout(len(pcm), cfg)
    assert lay["slabs"] == 3
    before_idx = {s.index for s in prof.spans()}
    before = turbo.STREAM_SLABS
    with torch.profiler.profile(activities=CPU):
        _stream(pcm, cfg, fetch_group=2)
    assert turbo.STREAM_SLABS - before == 3
    new = [s for s in prof.spans()
           if s.index not in before_idx and s.name != prof.GC_SPAN]
    root, = [s for s in new if s.name == "aegis.stream"]
    assert root.attrs == {"frames": lay["frames"], "tiles": lay["tiles"],
                          "slab_tiles": 2, "slabs": 3, "padded_tiles": 6,
                          "transport": "int8"}
    kids = sorted((s for s in new if s.parent == root.index),
                  key=lambda s: s.start_ns)
    assert [(s.name, s.attrs) for s in kids] == [
        ("aegis.stream_stage", {"ingest": "device"}),
        ("aegis.stream_peak", {}),
        ("aegis.stream_slab", {"slab": 0}), ("aegis.stream_slab", {"slab": 1}),
        ("aegis.stream_fetch", {"slabs": 2}),
        ("aegis.stream_slab", {"slab": 2}),
        ("aegis.stream_fetch", {"slabs": 1}), ("aegis.stream_unpack", {})]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    # each slab's decode is a batch of its tiles, haloed
    decodes = [s for s in new if s.name == "aegis.viterbi"]
    assert len(decodes) == 3
    assert all(s.attrs["B"] == 2 and s.attrs["T"] == 64 + 2 * 8
               for s in decodes)
    slabs = {s.index for s in kids if s.name == "aegis.stream_slab"}
    assert {s.parent for s in decodes} == slabs


def test_the_slab_counter_loses_no_count_across_threads():
    """Request threads of the server stream at once: every dispatched slab
    is counted."""
    import threading

    before = turbo.STREAM_SLABS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [turbo._count_slab() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert turbo.STREAM_SLABS - before == 16 * 2000


def test_the_spans_change_no_output():
    """With no profiler, with one, and with the span recorder taken out,
    every row is bitwise the same, NaN f0 included."""
    cfg = _small_cfg()
    pcm = _take(4.2)
    off = _stream(pcm, cfg)
    with torch.profiler.profile(activities=CPU):
        on = _stream(pcm, cfg)
    real = turbo.phase
    turbo.phase = lambda name, **attrs: prof._OFF
    try:
        bare = _stream(pcm, cfg)
    finally:
        turbo.phase = real
    assert set(off) == set(on) == set(bare)
    for key in off:
        a, b, c = (np.asarray(x[key]) for x in (off, on, bare))
        assert a.dtype == b.dtype == c.dtype
        assert a.tobytes() == b.tobytes() == c.tobytes(), key


@pytest.mark.cuda
def test_a_whole_song_decodes_its_slabs_at_b16_on_the_card():
    """A 250 s take at the file's numbers: 22 tiles run as two slabs of 16,
    each decoded as one B = 16, T = 1 152 launch of the one-pass forward
    kernel in clusters of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark's v1_rest_long runs "
                    "this path on the card")
    pcm = _take(250.0)
    before = {s.index for s in prof.spans()}
    acts = CPU + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        out = turbo.run_analyze_streamed(
            takes.pcm_float(pcm), program.audio_config(LONG),
            program.pyin_config(LONG), 0.6, fetch_mel=True, device="cuda")
        torch.cuda.synchronize()
    new = [s for s in prof.spans() if s.index not in before]
    root, = [s for s in new if s.name == "aegis.stream"]
    assert (root.attrs["tiles"], root.attrs["slabs"],
            root.attrs["padded_tiles"]) == (22, 2, 32)
    decodes = [s.attrs for s in new if s.name == "aegis.viterbi"]
    assert len(decodes) == 2
    assert all((a["B"], a["T"], a["n"], a["w"], a["kernel"], a["cluster"])
               == (16, 1152, 450, 51, "viterbi_fwd_kernel", 4)
               for a in decodes)
    assert len(out["f0"]) == 1 + len(pcm) // HOP


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [250.0, 600.0])
def test_a_whole_song_stages_on_the_card_as_the_host_staged_program(
        seconds, monkeypatch):
    """A 250 s and a 600 s take at the file's numbers: the stage span says
    the int8 slabs were quantized on the device, and every row is bitwise
    the program's over the host staging (the unchanged host quantizers,
    ``host_stage_int8``), NaN f0 included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark's v1_rest_long runs "
                    "this path on the card")
    y = takes.pcm_float(_take(seconds))

    def stream():
        return turbo.run_analyze_streamed(
            y, program.audio_config(LONG), program.pyin_config(LONG),
            LONG["analysis"]["rake_sensitivity"], fetch_mel=True,
            device="cuda")

    before = {s.index for s in prof.spans()}
    with torch.profiler.profile(activities=CPU):
        got = stream()
    stage, = [s for s in prof.spans()
              if s.index not in before and s.name == "aegis.stream_stage"]
    assert stage.attrs == {"ingest": "device"}
    monkeypatch.setattr(turbo, "stage_int8", host_stage_int8)
    want = stream()
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
