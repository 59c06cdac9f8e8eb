"""The benchmark's readers that place the device's idle time
(``bench_torch/idle_readers.py`` and the ``metrics/`` files that call it),
on a made-up traced slice and made-up program spans (no JAX, no card): the
idle time outside every span, spans that opened before the slice
included; the collections', the HTTP reads' and writes' and the named
spans' milliseconds; the graph captures, 0.0 against None; and their
``BENCHMARK.json`` entries."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from aegis_tpu_torch.utils import prof  # noqa: E402
from bench_torch import idle_readers, run  # noqa: E402
from bench_torch.trace import Slice  # noqa: E402

BENCH = run.load_json(ROOT / "BENCHMARK.json")
MS = 1_000_000
REST = ["v1_rest_mono", "poly_rest_chords", "v1_fine_rest", "v1_rest_long"]
BATCH = ["v1_folder_mono", "financial_folder"]
LIVE = ["v1_live_mono"]


def _span(name, start_ms, end_ms, index=0, parent=None, thread=1, **attrs):
    return prof.Span(name, int(start_ms * MS), int(end_ms * MS), thread,
                     index, parent, 1, attrs)


def _slice(ops, units=2, t0=10.0, t1=20.0):
    """A slice of ``units`` requests from ``t0`` to ``t1`` ms, with device
    operations at the (start, end) ms given."""
    items = [{"t0": t0 * MS, "t1": t1 * MS, "ms": t1 - t0, "ok": True}
             for _ in range(units)]
    return Slice(ops=[("k", s * MS, e * MS) for s, e in ops], t0=t0 * MS,
                 t1=t1 * MS, items=items, spans=[], cfg={})


@pytest.fixture
def recorded(monkeypatch):
    """Put made-up spans where the program's recorder keeps its own."""
    def put(spans):
        monkeypatch.setattr(prof, "spans", lambda: list(spans))
    return put


def _reader(name):
    return run.load_file_module(run.HERE / "metrics" / f"{name}.py").read


def test_unspanned_counts_only_the_idle_time_outside_every_span(recorded):
    """Device busy 10-11 and 15-16 ms; a span open from 9 ms (before the
    slice) to 12, one of another thread 13-14, one inside a device
    operation, and two outside the slice: idle 11-15 and 16-20 less the
    spans, 12-13, 14-15 and 16-20 = 6 ms over two requests."""
    recorded([_span("a", 9, 12), _span("b", 13, 14, thread=2),
              _span("c", 15.2, 15.8), _span("old", 1, 5),
              _span("late", 21, 25)])
    sl = _slice([(10, 11), (15, 16)])
    assert idle_readers.unspanned_ms(sl) == pytest.approx(3.0, abs=1e-9)
    for suffix in ("request", "batch", "live"):
        assert _reader(f"idle_unspanned_ms.{suffix}")(sl) == \
            pytest.approx(3.0, abs=1e-9)
    # the slice's own spans alone leave out the span open at its start
    recorded([_span("b", 13, 14), _span("c", 15.2, 15.8)])
    assert idle_readers.unspanned_ms(sl) == pytest.approx(3.5, abs=1e-9)


def test_unspanned_reads_nothing_without_device_operations_or_recorder(
        recorded, monkeypatch):
    recorded([_span("a", 9, 12)])
    assert idle_readers.unspanned_ms(_slice([])) is None
    sl = _slice([(10, 11)])
    # no span at all: every idle ms is unplaced
    recorded([])
    assert idle_readers.unspanned_ms(sl) == pytest.approx(4.5, abs=1e-9)
    monkeypatch.delattr(prof, "spans")
    assert idle_readers.unspanned_ms(sl) is None


def test_gc_ms_sums_the_collections_of_every_generation(recorded,
                                                        monkeypatch):
    recorded([_span("py.gc", 11, 11.5, generation=0),
              _span("py.gc", 12, 14, generation=2),
              _span("py.gc", 5, 6, generation=2),         # before the slice
              _span("aegis.extract", 11, 15)])
    sl = _slice([(10, 11)])
    for suffix in ("request", "batch", "live"):
        assert _reader(f"gc_ms.{suffix}")(sl) == pytest.approx(1.25)
    recorded([_span("aegis.extract", 11, 15)])
    assert idle_readers.gc_ms(sl) == 0.0
    # a recorder that records no collections (the parent's) reads nothing
    monkeypatch.delattr(prof, "GC_SPAN")
    assert idle_readers.gc_ms(sl) is None


def test_http_io_ms_sums_the_reads_and_writes(recorded):
    exchange = [_span("serve.http", 10, 19, 0),
                _span("serve.read", 10, 11.5, 1, 0),
                _span("serve.request", 11.5, 18, 2, 0),
                _span("serve.write", 18, 18.5, 3, 0)]
    recorded(exchange)
    sl = _slice([(12, 13)])
    assert _reader("http_io_ms.request")(sl) == pytest.approx(1.0)
    # an exchange whose spans lack reads and writes reads 0.0, a program
    # that records no exchange nothing
    recorded(exchange[:1] + exchange[2:3])
    assert idle_readers.http_io_ms(sl) == 0.0
    recorded(exchange[1:])
    assert idle_readers.http_io_ms(sl) is None


@pytest.mark.parametrize("metric,names", [
    ("aegis_perception_ms.request", ("aegis.perception",
                                     "aegis.poly_perception")),
    ("aegis_extract_ms.request", ("aegis.extract", "aegis.poly_extract")),
    ("live_feed_ms.live", ("live.feed",)),
    ("live_poll_ms.live", ("live.poll",)),
    ("stream_peak_ms.request", ("aegis.stream_peak",)),
    ("stream_slab_ms.request", ("aegis.stream_slab",)),
    ("stream_unpack_ms.request", ("aegis.stream_unpack",)),
])
def test_the_span_readers_sum_their_spans(recorded, metric, names):
    """Each reader sums the spans it names that started in the slice, per
    unit, and none of the others; None where none of them ran."""
    spans = [_span(name, 11 + k, 11.5 + 2 * k)
             for k, name in enumerate(names)]
    others = [_span("aegis.stream", 10, 19), _span("live.other", 12, 13),
              _span(names[0], 5, 7)]                      # before the slice
    recorded(spans + others)
    sl = _slice([(10, 11)])
    want = sum(0.5 + k for k in range(len(names))) / 2
    assert _reader(metric)(sl) == pytest.approx(want)
    recorded(others[:2])
    assert _reader(metric)(sl) is None


def test_graph_captures_read_zero_against_none(recorded, monkeypatch):
    sl = _slice([(10, 11)], units=4)
    recorded([_span("aegis.capture", 11, 12, program="fused"),
              _span("aegis.capture", 13, 14, program="live"),
              _span("aegis.capture", 2, 3, program="fused")])
    assert _reader("graph_captures.request")(sl) == 0.5
    recorded([_span("aegis.enqueue", 11, 12)])
    assert _reader("graph_captures.request")(sl) == 0.0
    monkeypatch.delattr(prof, "spans")
    assert _reader("graph_captures.request")(sl) is None
    assert idle_readers.gc_ms(sl) is None


@pytest.mark.parametrize("name,moves,cells", [
    ("idle_unspanned_ms.request", "request_p95_ms", REST),
    ("idle_unspanned_ms.batch", "audio_x_rt", BATCH),
    ("idle_unspanned_ms.live", "chunk_p95_ms", LIVE),
    ("gc_ms.request", "request_p95_ms", REST),
    ("gc_ms.batch", "audio_x_rt", BATCH),
    ("gc_ms.live", "chunk_p95_ms", LIVE),
    ("http_io_ms.request", "request_p95_ms", REST),
    ("graph_captures.request", "request_p95_ms", REST),
    ("aegis_perception_ms.request", "request_p95_ms", REST),
    ("aegis_extract_ms.request", "request_p95_ms", REST),
    ("live_feed_ms.live", "chunk_p95_ms", LIVE),
    ("live_poll_ms.live", "chunk_p95_ms", LIVE),
    ("stream_peak_ms.request", "request_p95_ms", ["v1_rest_long"]),
    ("stream_slab_ms.request", "request_p95_ms", ["v1_rest_long"]),
    ("stream_unpack_ms.request", "request_p95_ms", ["v1_rest_long"]),
])
def test_each_metric_is_entered_for_its_cells(name, moves, cells):
    entry, = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert entry["moves"] == moves and entry["workloads"] == cells
    assert entry["better"] == "lower"
    assert (run.HERE / "metrics" / f"{name}.py").is_file()
