"""CPU tests of the readers of the fused program's graph replays
(``metrics/fused_graphs.request.py``, ``metrics/fused_graphs.batch.py``) on
synthetic traced slices.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import program_spans, run  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


class _Span:
    def __init__(self, name, start_ns, **attrs):
        self.name, self.start_ns, self.attrs = name, start_ns, attrs


def _reader(name):
    return run.load_file_module(run.HERE / "metrics" / f"{name}.py").read


def _slice(items):
    return Slice(ops=[], t0=0.0, t1=1e9, items=items, spans=[], cfg={})


@pytest.mark.parametrize("name,items,per", [
    # four requests, one replay each
    ("fused_graphs.request", [{"t0": 0.0, "t1": 1e9}] * 4, 1.0),
    # two folder passes of six tracks: twelve replays, one a track
    ("fused_graphs.batch", [{"t0": 0.0, "t1": 1e9, "n_tracks": 6}] * 2,
     1.0),
])
def test_replays_are_counted_a_request_or_a_track(name, items, per,
                                                  monkeypatch):
    n = round(per * sum(it.get("n_tracks", 1) for it in items))
    spans = ([_Span("aegis.fused_graph", 1.0 + k, bucket=671744)
              for k in range(n)]
             + [_Span("aegis.enqueue", 1.0), _Span("aegis.viterbi", 2.0)])
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: spans)
    assert _reader(name)(_slice(items)) == pytest.approx(per)
    # half the items replayed: the rest ran eagerly
    monkeypatch.setattr(program_spans, "in_slice",
                        lambda _sl: spans[:n // 2] + spans[n:])
    assert _reader(name)(_slice(items)) == pytest.approx(per / 2)


@pytest.mark.parametrize("name", ["fused_graphs.request",
                                  "fused_graphs.batch"])
def test_a_program_without_the_span_reads_none(name, monkeypatch):
    items = [{"t0": 0.0, "t1": 1e9, "n_tracks": 6}]
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: [
        _Span("aegis.enqueue", 1.0), _Span("aegis.fetch", 2.0)])
    assert _reader(name)(_slice(items)) is None
    monkeypatch.setattr(program_spans, "in_slice", lambda _sl: [])
    assert _reader(name)(_slice(items)) is None


def test_the_metrics_are_the_device_programs_layers_in_their_cells():
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    req, batch = by_name["fused_graphs.request"], by_name["fused_graphs.batch"]
    assert req["workloads"] == ["v1_rest_mono", "v1_fine_rest"]
    assert req["moves"] == "request_p95_ms"
    assert batch["workloads"] == ["v1_folder_mono"]
    assert batch["moves"] == "audio_x_rt"
    for m in (req, batch):
        assert m["source"] == "program_span"
        assert m["layer"] == by_name["graph_tiles.live"]["layer"]
