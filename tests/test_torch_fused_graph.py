"""The fused program's CUDA graph cache (``core/analyze.py``) on the CPU.

On the card ``dispatch_analyze`` replays one captured graph a key
(``fused_graph_key``); ``tests/test_torch_cuda.py`` holds the replays to
the eager program there.  Here: the key separates every field that fixes
the launch sequence, the cache keeps at most its bound and tells the
capturing call apart (a stub in place of the capture), the bound holds
every bucket of the fused path, the CPU path stays eager with the rows it
gave before, the rake as a 0-d float32 tensor (a graph's input) gives the
rows of the Python float, a replay makes its spans and counts its launches
(a stub in place of the graph), and the capture's warm-up answers its
dispatch once.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import analyze, graphs, pyin_cuda
from aegis_tpu_torch.core.tables import tables_from_numpy
from aegis_tpu_torch.tools.signal_gen import generate_test_track
from aegis_tpu_torch.utils import prof

CPU = torch.device("cpu")
SR = 22050
AUDIO = AudioConfig(sample_rate=SR)
CFG = PyinConfig()

# fused_graph_key's arguments, and another value of each
BASE = dict(bucket=671744, audio=AUDIO, pyin_cfg=CFG, transport="int8",
            fetch_mel=True, financial=False, use_guitar_filters=True,
            device=torch.device("cuda", 0))
OTHER = dict(bucket=688128, audio=AudioConfig(sample_rate=44100),
             pyin_cfg=PyinConfig(resolution=0.05), transport="int16",
             fetch_mel=False, financial=True, use_guitar_filters=False,
             device=torch.device("cuda", 1))


@pytest.fixture(scope="module")
def clip():
    """The canonical test track (two rakes among three notes), 22 050 Hz."""
    return generate_test_track(sr=SR)[0]


@pytest.mark.parametrize("field", sorted(BASE))
def test_the_key_separates_each_field(field):
    base = analyze.fused_graph_key(**BASE)
    assert analyze.fused_graph_key(**BASE) == base
    assert hash(analyze.fused_graph_key(**BASE)) == hash(base)
    assert analyze.fused_graph_key(**{**BASE, field: OTHER[field]}) != base


def test_the_two_grids_and_the_transports_take_separate_keys():
    keys = {analyze.fused_graph_key(**{**BASE, "pyin_cfg": cfg,
                                       "transport": t})
            for cfg in (PyinConfig(), PyinConfig(resolution=0.05))
            for t in ("int8", "int4", "int16", "float32")}
    assert len(keys) == 8


def _pool(device):
    """A stand-in for ``shared_replays`` (which needs a card)."""
    return object()


class _Stub:
    """What a capture returns, in place of a ``_FusedGraph``."""

    def __init__(self, key, pool):
        self.key, self.pool = key, pool


def _cache():
    captured = []

    def capture_of(key):
        def capture(pool):
            captured.append(key)
            return _Stub(key, pool)
        return capture
    return (analyze.FusedGraphs(BASE["device"], new_replays=_pool),
            captured, capture_of)


def test_the_cache_keeps_its_bound_and_evicts_the_least_recently_used(
        monkeypatch):
    monkeypatch.setattr(analyze, "FUSED_GRAPHS", 3)
    graphs, captured, capture_of = _cache()
    for k in (0, 1, 2):
        assert graphs.get(k, capture_of(k))[1]        # this call captured
    first, fresh = graphs.get(0, capture_of(0))  # a hit: 0 is the newest
    assert captured == [0, 1, 2] and first.key == 0 and not fresh
    graphs.get(3, capture_of(3))              # evicts 1, the oldest
    assert len(graphs) == 3 and 1 not in graphs
    assert all(k in graphs for k in (0, 2, 3))
    assert graphs.get(0, capture_of(0)) == (first, False)
    again, fresh = graphs.get(1, capture_of(1))   # captured anew, evicts 2
    assert captured == [0, 1, 2, 3, 1] and again.key == 1 and fresh
    assert len(graphs) == 3 and 2 not in graphs
    # every graph of the card shares one pool
    assert len({id(graphs.get(k, capture_of(k))[0].pool)
                for k in (0, 1, 3)}) == 1


def test_the_module_bound_holds_the_bench_buckets_at_both_grids():
    assert analyze.FUSED_GRAPHS >= 12
    graphs, captured, capture_of = _cache()
    for k in range(analyze.FUSED_GRAPHS + 5):
        graphs.get(k, capture_of(k))
        assert len(graphs) == min(k + 1, analyze.FUSED_GRAPHS)
    assert captured == list(range(analyze.FUSED_GRAPHS + 5))


def test_the_module_bound_holds_every_bucket_of_the_fused_path():
    """Tracks of any length up to the 240 s the fused path takes by
    default (44 100 Hz) fall in no more buckets than the cache keeps, so
    traffic of arbitrary lengths captures each bucket once."""
    top = analyze.bucket_length(240 * 44100)
    buckets = [analyze.bucket_length(1)]
    while buckets[-1] < top:                  # each bucket, the next one up
        buckets.append(analyze.bucket_length(buckets[-1] + 1))
    assert len(buckets) == 218
    assert len(buckets) <= analyze.FUSED_GRAPHS


def test_a_failed_capture_raises_caches_nothing_and_takes_a_fresh_pool():
    pools = []

    def new_pool(device):
        pools.append(object())
        return pools[-1]

    graphs = analyze.FusedGraphs(BASE["device"], new_replays=new_pool)

    def fails(pool):
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.get("a", fails)
    assert len(graphs) == 0
    got, fresh = graphs.get("a", lambda pool: _Stub("a", pool))
    # the failed capture's pool may be held by no live graph: not reused
    assert len(pools) == 2 and got.pool is pools[1] and fresh
    graphs.get("b", lambda pool: _Stub("b", pool))
    assert len(pools) == 2


def test_threads_capture_each_key_once():
    """Eight threads ask for four keys at once: each key is captured once,
    one capture at a time, and every thread gets the cached graph."""
    graphs = analyze.FusedGraphs(BASE["device"], new_replays=_pool)
    captured, active, overlap = [], [], []
    lock = threading.Lock()

    def capture_of(key):
        def capture(pool):
            with lock:
                active.append(key)
                overlap.append(len(active) > 1)
            time.sleep(0.002)
            with lock:
                active.remove(key)
                captured.append(key)
            return _Stub(key, pool)
        return capture

    got, fresh = {}, []

    def worker(i):
        for r in range(20):
            k = (i + r) % 4
            g, captured_here = graphs.get(k, capture_of(k))
            got.setdefault(k, set()).add(id(g))
            if captured_here:
                fresh.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(captured) == [0, 1, 2, 3] and not any(overlap)
    assert all(len(ids) == 1 for ids in got.values())
    # one call a key was told that it captured (its warm-up answers it)
    assert sorted(fresh) == [0, 1, 2, 3]


def _eager_before(y, transport, financial, fetch_mel, rake=0.6):
    """The packed rows as dispatch_analyze computed them on the CPU before
    the graph cache: upload, scale tensor, the packed program."""
    y_pad = analyze.pad_to_bucket(np.asarray(y, np.float32))
    tables = tables_from_numpy(AUDIO, CFG, CPU)
    if transport == "int8":
        s, sc = analyze.quantize_pcm8(y_pad)
        y_dev, scale = analyze.upload(s, CPU), analyze.upload(sc, CPU)
    elif transport == "int16":
        s, sc = analyze.quantize_pcm16(y_pad)
        y_dev = analyze.upload(s, CPU)
        scale = torch.full((), sc, dtype=torch.float32)
    else:
        y_dev = analyze.upload(y_pad, CPU)
        scale = torch.ones((), dtype=torch.float32)
    if financial:
        return analyze.analyze_financial_program_packed(
            y_dev, scale, rake, AUDIO, CFG, tables, True, fetch_mel)
    return analyze.analyze_program_packed(y_dev, scale, rake, AUDIO, CFG,
                                          tables, fetch_mel)


@pytest.mark.parametrize("transport,financial,fetch_mel", [
    ("int8", False, True), ("int16", False, False), ("float32", True, False),
    ("int8", True, True)])
def test_the_cpu_path_stays_eager_with_the_same_rows(clip, transport,
                                                     financial, fetch_mel):
    packed, rows, true_frames, n_mels = analyze.dispatch_analyze(
        clip, AUDIO, CFG, financial=financial, fetch_mel=fetch_mel,
        transport=transport, device="cpu")
    want = _eager_before(clip, transport, financial, fetch_mel)
    assert packed.device == CPU
    assert packed.numpy().tobytes() == want.numpy().tobytes()
    assert rows == (analyze._FIN_ROWS if financial else analyze._V1_ROWS)
    assert true_frames == AUDIO.n_frames(len(clip))
    assert n_mels == (AUDIO.n_mels if fetch_mel else 0)
    # the CPU keeps no graph cache
    assert CPU not in analyze._CARDS


@pytest.mark.parametrize("financial", [False, True])
def test_the_rake_as_a_0d_tensor_gives_the_rows_of_the_float(clip,
                                                              financial):
    y_pad = analyze.pad_to_bucket(np.asarray(clip, np.float32))
    args = analyze.ingest(y_pad, "int8", CPU)
    program = analyze.packed_program(AUDIO, CFG,
                                     tables_from_numpy(AUDIO, CFG, CPU),
                                     financial, True, True)
    col = AUDIO.n_mels + analyze._V1_ROWS.index("rake_mask")
    masks = []
    for rake in (0.3, 0.9):
        as_float = program(*args, rake)
        as_tensor = program(*args, torch.tensor(rake, dtype=torch.float32))
        assert as_tensor.numpy().tobytes() == as_float.numpy().tobytes()
        masks.append(as_float[:, col].numpy())
    # the rake is read, not fixed: the two sensitivities' masks differ
    assert (masks[0] != masks[1]).any()


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_captured(attrs, shape):
    c = graphs.CapturedProgram.__new__(graphs.CapturedProgram)
    c.graph, c.decodes = _Graph(), [attrs]
    c.launched = c.first_launched = [("viterbi_fwd", shape + (attrs["w"],)),
                                     ("viterbi_back", shape)]
    return c


def _stub_fused_graph(attrs, shape):
    g = analyze._FusedGraph.__new__(analyze._FusedGraph)
    g.bucket, g.captured = 671744, _stub_captured(attrs, shape)
    return g


ATTRS = {"B": 1, "T": 1313, "n": 900, "w": 101,
         "kernel": "viterbi_fwd_wide_kernel", "tile": 96, "cluster": 8,
         "passes": 2}


def _fresh_counts(monkeypatch):
    for name in ("LAUNCHES", "LAST_BATCH", "SEQUENCES"):
        monkeypatch.setattr(pyin_cuda, name,
                            {"viterbi_fwd": 0, "viterbi_back": 0})
    monkeypatch.setattr(pyin_cuda, "SHAPES",
                        {"viterbi_fwd": {}, "viterbi_back": {}})


def test_a_replay_makes_its_span_and_the_captured_decodes_span(monkeypatch):
    _fresh_counts(monkeypatch)
    g = _stub_fused_graph(ATTRS, (1, 1313, 900))
    before = {s.index for s in prof.spans()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        with prof.phase("aegis.enqueue"):
            g.replay()
    got = [s for s in prof.spans()
           if s.index not in before and s.name != prof.GC_SPAN]
    by_name = {s.name: s for s in got}
    assert sorted(s.name for s in got) == ["aegis.enqueue",
                                           "aegis.fused_graph",
                                           "aegis.viterbi"]
    graph, decode = by_name["aegis.fused_graph"], by_name["aegis.viterbi"]
    assert graph.attrs == {"bucket": 671744}
    assert graph.parent == by_name["aegis.enqueue"].index
    assert decode.attrs == ATTRS and decode.parent == graph.index
    assert g.captured.graph.replays == 1
    # the recorded launches are counted once a replay, traced or not
    g.replay()
    assert g.captured.graph.replays == 2
    assert pyin_cuda.LAUNCHES == {"viterbi_fwd": 2, "viterbi_back": 2}
    assert pyin_cuda.SHAPES == {"viterbi_fwd": {(1, 1313, 900, 101): 2},
                                "viterbi_back": {(1, 1313, 900): 2}}


def test_off_a_replay_makes_no_span(monkeypatch):
    _fresh_counts(monkeypatch)
    g = _stub_fused_graph(ATTRS, (1, 1313, 900))
    before = len(prof.spans())
    g.replay()
    assert len(prof.spans()) == before and g.captured.graph.replays == 1


class _Rows:
    """A stand-in for the warm-up's packed rows (a card tensor)."""

    def __init__(self):
        self.streams = []

    def record_stream(self, stream):
        self.streams.append(stream)


def test_the_warm_up_answers_the_capturing_dispatch_once(monkeypatch):
    """The capture's eager warm-up is the first dispatch's answer: handed
    out once, marked as read on the caller's stream, its launches counted
    as one dispatch's; later dispatches replay."""
    _fresh_counts(monkeypatch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "caller")
    g = _stub_fused_graph(ATTRS, (1, 1313, 900))
    rows = g.captured.first = _Rows()
    assert g.first() is rows and rows.streams == ["caller"]
    assert g.first() is None
    assert g.captured.graph.replays == 0
    assert pyin_cuda.LAUNCHES == {"viterbi_fwd": 1, "viterbi_back": 1}
    assert pyin_cuda.SHAPES == {"viterbi_fwd": {(1, 1313, 900, 101): 1},
                                "viterbi_back": {(1, 1313, 900): 1}}
