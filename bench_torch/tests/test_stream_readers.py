"""CPU tests of the streamed cell's parts: the readers of the streamed
program (``stream_readers.py``) on synthetic traced slices, the
configuration's ``stream`` numbers held to the port's, and the cell's
check (``checks/v1_stream.py``) at a test size: correct on the program,
not correct under its control or with the server's streams at halo 0.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import copy
import functools
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import program_spans, roofline, run, stream_readers  # noqa: E402
from bench_torch.checks import v1_stream as stream_check  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "v1_rest_long"
LONG = run.load_json(run.HERE / "configs" / "v1_long_44k.json")
MIX = run.load_json(run.HERE / "traffic" / "rest_long.json")
FWD = "void (anonymous namespace)::viterbi_fwd_kernel<4, 16, true, float>(...)"
BACK = "void (anonymous namespace)::viterbi_back_walk_kernel(...)"
SEED = 2**31 + 77
NEW = ("stream_stage_ms.request", "stream_fetch_ms.request",
       "stream_slabs.request", "slab_viterbi_roofline.request")


class _Span:
    def __init__(self, name, start_ns, end_ns, **attrs):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.attrs = attrs


def _slice(ops, n_items=2):
    items = [{"t0": 0.0, "t1": 1e9, "decodes": [(1, 40000)]}
             for _ in range(n_items)]
    return Slice(ops=ops, t0=0.0, t1=1e9, items=items, spans=[], cfg=LONG)


def _decode(start, B=16, T=1152):
    return _Span("aegis.viterbi", start, start + 1e6, B=B, T=T, n=450, w=51,
                 kernel="viterbi_fwd_kernel", tile=88, cluster=4, passes=1)


SPANS = [_Span("aegis.stream", 0.0, 9e8, frames=25840, tiles=26,
               slab_tiles=16, slabs=2, padded_tiles=32, transport="int8"),
         _Span("aegis.stream_stage", 1e6, 31e6),
         _Span("aegis.stream_peak", 31e6, 40e6),
         _Span("aegis.stream_slab", 40e6, 60e6, slab=0), _decode(45e6),
         _Span("aegis.stream_slab", 60e6, 80e6, slab=1), _decode(65e6),
         _Span("aegis.stream_fetch", 80e6, 130e6, slabs=2),
         _Span("aegis.stream_unpack", 130e6, 140e6),
         _Span("aegis.stream_stage", 2e8, 2.1e8),
         _Span("aegis.stream_slab", 2.1e8, 2.2e8, slab=0),
         _decode(2.15e8, B=10),
         _Span("aegis.stream_fetch", 2.2e8, 2.5e8, slabs=1)]


def test_the_stage_fetch_and_slab_readers(monkeypatch):
    sl = _slice([(FWD, 0.0, 1e7)])
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: SPANS)
    assert stream_readers.stage_ms(sl) == pytest.approx((30 + 10) / 2)
    assert stream_readers.fetch_ms(sl) == pytest.approx((50 + 30) / 2)
    assert stream_readers.slabs(sl) == pytest.approx(3 / 2)
    # a program without the spans, or a slice of fused requests
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: [])
    assert stream_readers.stage_ms(sl) is None
    assert stream_readers.fetch_ms(sl) is None
    assert stream_readers.slabs(sl) is None


def test_the_slab_roofline_is_the_decode_bound_at_the_spans_shapes(
        monkeypatch):
    busy = [(FWD, 0.0, 6e6), (FWD, 1e7, 16e6), (BACK, 2e7, 2.1e7),
            (FWD, 3e7, 33e6), ("elementwise", 4e7, 9e7)]
    sl = _slice(busy)
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: SPANS)
    n, w = roofline.pitch_grid(LONG["pyin"], 44100, 512)
    assert (n, w) == (450, 51)
    want = roofline.decode_bound_s([(16, 1152), (16, 1152), (10, 1152)],
                                   n, w)
    busy_s = (6 + 6 + 1 + 3) / 1e3
    assert stream_readers.decode_roofline_pct(sl) == pytest.approx(
        100.0 * want / busy_s)
    # the items' fused shape (1, 40000) is not what it reads
    assert stream_readers.decode_roofline_pct(sl) != pytest.approx(
        100.0 * roofline.decode_bound_s([(1, 40000)] * 2, n, w) / busy_s)
    assert 0 < stream_readers.decode_roofline_pct(sl) < 100
    monkeypatch.setattr(program_spans, "in_slice",
                        lambda _sl: [s for s in SPANS
                                     if s.name != "aegis.viterbi"])
    assert stream_readers.decode_roofline_pct(sl) is None
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: SPANS)
    assert stream_readers.decode_roofline_pct(_slice([])) is None


@pytest.mark.parametrize("key,value", [("tile_frames", 512),
                                       ("halo_frames", 32),
                                       ("slab_tiles", 8),
                                       ("fetch_group", 4),
                                       ("threshold_s", 120)])
def test_a_stream_number_the_port_does_not_run_is_refused(key, value):
    cfg = copy.deepcopy(LONG)
    cfg["stream"][key] = value
    with pytest.raises(ValueError, match=rf"stream\.{key}"):
        stream_check.check([], cfg, MIX, "cpu")
    # the file's own numbers are the port's
    assert set(stream_check.check([], LONG, MIX, "cpu")) == set(
        LONG["check"]["limits"]["v1_stream"])


def test_the_new_entries_list_only_the_new_cell():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "request_p95_ms"
        assert (run.HERE / "metrics" / f"{name}.py").is_file()
    # the load records the fused decode shape; the stream never runs it
    assert CELL not in per_layer["viterbi_roofline.request"]["workloads"]
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "v1_long_44k", "rest_long", 1)
    conf = next(c for c in BENCH["configs"] if c["name"] == "v1_long_44k")
    assert conf["reduced"] == [] and len(conf["source"]) <= 200


# ---------------------------------------------- the cell at a test size

def _small_stream(monkeypatch, served_halo: int = 8):
    """The port's stream at 64-frame tiles, 8 halo frames, two tiles a slab
    and a 2 s threshold, and the configuration stating the same;
    ``served_halo`` is the halo the server's streams run at."""
    from aegis_tpu_torch import config
    from aegis_tpu_torch.engine import turbo
    from aegis_tpu_torch.serve import server

    real = config.TurboConfig
    monkeypatch.setattr(config, "TurboConfig", functools.partial(
        real, tile_frames=64, halo_frames=8))
    monkeypatch.setattr(turbo, "TurboConfig", functools.partial(
        real, tile_frames=64, halo_frames=served_halo))
    monkeypatch.setattr(turbo, "STREAM_SLAB_TILES", 2)
    monkeypatch.setattr(server, "STREAM_THRESHOLD_S", 2.0)
    cfg = copy.deepcopy(LONG)
    cfg["stream"].update(tile_frames=64, halo_frames=8, slab_tiles=2,
                         threshold_s=2.0)
    mix = copy.deepcopy(MIX)
    mix["takes"]["lengths_s"] = [3, 5]
    mix["trace_items"] = 2
    return cfg, mix, turbo


def _run(monkeypatch, control=False, served_halo=8):
    cfg, mix, turbo = _small_stream(monkeypatch, served_halo)
    before = turbo.STREAM_SLABS
    run.set_cache_dirs()
    res = run.run_cell(BENCH, CELL, SEED, 2.0, 0, "cpu", control, cfg, mix)
    return res, turbo.STREAM_SLABS - before


def test_the_streamed_cell_comes_out_correct(monkeypatch):
    res, slabs = _run(monkeypatch)
    # the warm-up streamed both takes (3 + 4 slabs), the window one or more
    assert slabs >= 3 + 4 + 3
    assert res["correct"], res["checks"]
    assert res["checks"]["state_miss_pct"]["value"] == 0


def test_the_streamed_cells_control_is_not_correct(monkeypatch):
    res, _ = _run(monkeypatch, control=True)
    assert not res["correct"], res["checks"]


def test_streams_served_at_halo_0_are_not_correct(monkeypatch):
    res, slabs = _run(monkeypatch, served_halo=0)
    assert slabs > 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["onset_gap"]["value"] > res["checks"]["onset_gap"][
        "limit"]
