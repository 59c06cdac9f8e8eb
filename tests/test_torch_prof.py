"""The port's span recorder (aegis_tpu_torch/utils/prof.py) on the CPU: it
records nothing without a profiler; with one it records spans of every
thread, nested, numbered by request and on kineto's clock, the
interpreter's collections among them; and the served paths (the REST
server and its HTTP exchange, a live session, a folder pass, a graph
capture) leave their span trees."""

import gc
import http.client
import importlib.util
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer

import torch

from aegis_tpu_torch.core import analyze
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.io.wav import write_wav
from aegis_tpu_torch.serve.http import make_handler
from aegis_tpu_torch.serve.server import AegisServer
from aegis_tpu_torch.tools.signal_gen import generate_test_track
from aegis_tpu_torch.utils import prof

CPU = [torch.profiler.ProfilerActivity.CPU]
SR = 22050


def _recorded(body, collections=False):
    """The spans recorded while ``body`` runs under a CPU profiler, and the
    profiler; the interpreter's collections, which land wherever one
    happens to run, only with ``collections``."""
    before = {s.index for s in prof.spans()}
    with torch.profiler.profile(activities=CPU) as p:
        body()
    return [s for s in prof.spans() if s.index not in before
            and (collections or s.name != prof.GC_SPAN)], p


def _on_thread(fn):
    out = {}

    def run():
        out["result"] = fn()
        out["tid"] = threading.get_native_id()
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive()
    return out


def _tree(spans, root):
    """{name: [children's names]} under ``root``, by the parent links."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = {}

    def walk(s):
        out.setdefault(s.name, [])
        for c in kids.get(s.index, []):
            out[s.name].append(c.name)
            walk(c)
    walk(root)
    return out


def test_off_records_nothing():
    n = len(prof.spans())
    assert not prof.recording()
    with prof.phase("test.off", k=1) as got:
        torch.ones(4).sum()
    assert got is None
    assert prof.phase("test.off") is prof.phase("test.other")
    assert len(prof.spans()) == n
    assert not [s for s in prof.spans() if s.name == "test.off"]


def test_spans_of_another_thread_nest_with_request_and_attrs():
    def work():
        with prof.phase("test.root", path="/x"):
            with prof.phase("test.child", track=3):
                torch.ones(4).sum()
            with prof.phase("test.child", track=4):
                pass

    def body():
        assert prof.recording()
        out.update(_on_thread(work))
    out = {}
    spans, _ = _recorded(body)
    root, = [s for s in spans if s.name == "test.root"]
    kids = [s for s in spans if s.name == "test.child"]
    assert root.parent is None and root.attrs == {"path": "/x"}
    assert [k.attrs["track"] for k in kids] == [3, 4]
    assert all(k.parent == root.index and k.request == root.request
               for k in kids)
    assert {s.thread for s in spans} == {out["tid"]}
    assert root.start_ns <= kids[0].start_ns <= kids[1].end_ns <= root.end_ns
    # a second root takes a new request number
    again, _ = _recorded(lambda: _on_thread(work))
    assert {s.request for s in again} != {root.request}


def test_a_span_directly_inside_one_of_its_name_is_that_span():
    def body():
        with prof.phase("test.same", track=1):
            with prof.phase("test.same"):
                pass
    spans, _ = _recorded(body)
    assert [(s.name, s.attrs) for s in spans] == [("test.same",
                                                    {"track": 1})]


def test_span_encloses_kineto_event_on_the_same_clock():
    def body():
        with prof.phase("test.clock"):
            with torch.profiler.record_function("test.kineto"):
                torch.ones(64).sum()
    spans, p = _recorded(body)
    sp, = [s for s in spans if s.name == "test.clock"]
    ev, = [e for e in p.profiler.kineto_results.events()
           if e.name() == "test.kineto"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    ms = 1_000_000
    assert sp.start_ns - ms <= start <= end <= sp.end_ns + ms
    assert start - sp.start_ns < ms and sp.end_ns - end < ms


def _wav(seconds):
    buf = io.BytesIO()
    write_wav(buf, generate_test_track(sr=SR)[0][:int(seconds * SR)], SR)
    return buf.getvalue()


def test_server_request_tree():
    srv = AegisServer(engine=AegisEngine(sample_rate=SR, device="cpu"))

    def call(path, body=b""):
        return json.loads(srv.router.dispatch(
            "POST", path, {"name": "a.wav"}, body, "audio/wav").content)

    def body():
        def both():
            sid = call("/api/upload", _wav(1.5))["session_id"]
            return call(f"/api/analyze/{sid}")
        out.update(_on_thread(both))
    out = {}
    spans, _ = _recorded(body)
    assert out["result"]["num_events"] >= 1
    upload, analyze = [s for s in spans if s.name == "serve.request"]
    assert _tree(spans, upload) == {"serve.request": ["serve.upload"],
                                    "serve.upload": []}
    tree = _tree(spans, analyze)
    assert tree["serve.request"] == ["serve.decode", "aegis.perception",
                                     "aegis.extract", "serve.session",
                                     "serve.respond"]
    assert tree["aegis.perception"] == ["aegis.enqueue", "aegis.fetch"]
    mine = [s for s in spans if s.request == analyze.request]
    assert len(mine) == sum(map(len, tree.values())) + 1
    assert upload.request != analyze.request
    assert {s.thread for s in spans} == {out["tid"]}
    assert analyze.attrs["path"].startswith("/api/analyze/")


def test_live_chunk_tree():
    from aegis_tpu_torch.engine.realtime import StreamingTranscriber

    rt = StreamingTranscriber(device="cpu")
    sr = rt.audio.sample_rate
    y = generate_test_track(sr=sr)[0]

    def body():
        out["tiles"] = rt.feed(y[:int(1.5 * sr)])
        rt.poll_events()
    out = {}
    spans, _ = _recorded(body)
    assert out["tiles"] == 2
    feed, = [s for s in spans if s.name == "live.feed"]
    tree = _tree(spans, feed)
    assert tree["live.feed"] == ["aegis.live_tile",
                                 "aegis.live_fetch"] * out["tiles"]
    assert [s.parent for s in spans if s.name == "live.poll"] == [None]


def test_folder_pass_spans_per_track(tmp_path):
    from aegis_tpu_torch.engine.folder import transcribe_folder

    y = generate_test_track(sr=SR)[0]
    for k, seconds in enumerate((1.0, 1.5)):
        with open(tmp_path / f"t{k}.wav", "wb") as f:
            write_wav(f, y[:int(seconds * SR)], SR)
    res = []
    spans, _ = _recorded(lambda: res.extend(transcribe_folder(
        str(tmp_path), output_dir=str(tmp_path / "out"), sample_rate=SR,
        device="cpu")))
    assert len(res) == 2
    for name in ("folder.load", "aegis.enqueue", "aegis.fetch",
                 "folder.extract"):
        got = [s for s in spans if s.name == name]
        assert [s.attrs.get("track") for s in got] == [0, 1], name
        assert all(s.parent is None for s in got), name


def test_device_trace_holds_every_threads_spans(tmp_path):
    def work():
        with prof.phase("test.worker", k=7):
            torch.ones(4).sum()
    with prof.device_trace(str(tmp_path)):
        out = _on_thread(work)
    trace = json.loads((tmp_path / "trace.json").read_text())
    ev, = [e for e in trace["traceEvents"] if e.get("name") == "test.worker"
           and e.get("cat") == "aegis.span"]
    assert ev["ph"] == "X" and ev["tid"] == out["tid"]
    assert ev["pid"] == os.getpid() and ev["args"]["k"] == 7
    assert ev["dur"] >= 0


def test_spans_are_bounded_and_complete():
    def body():
        for _ in range(1000):
            with prof.phase("test.many"):
                pass
    spans, _ = _recorded(body)
    many = [s for s in spans if s.name == "test.many"]
    assert len(many) == 1000 and len(prof.spans()) <= prof.MAX_SPANS
    assert all(s.end_ns >= s.start_ns for s in many)


def test_an_http_exchange_is_one_request_of_spans():
    """One upload through the handler on a real server: ``serve.http`` over
    ``serve.read``, the router's ``serve.request`` and ``serve.write``, in
    order, on the server's thread, with one request number; the byte
    counts are the body's and the response's."""
    srv = AegisServer(engine=AegisEngine(sample_rate=SR, device="cpu"))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv.router))
    serving = threading.Thread(target=httpd.serve_forever,
                               kwargs={"poll_interval": 0.05})
    serving.start()
    wav = _wav(1.0)
    out = {}

    def body():
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1])
        conn.request("POST", "/api/upload?name=a.wav", wav,
                     {"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        out["status"], out["body"] = resp.status, resp.read()
        conn.close()
        httpd.shutdown()
        httpd.server_close()        # joins the exchange's thread
    try:
        spans, _ = _recorded(body)
    finally:
        httpd.shutdown()
        serving.join(timeout=60)
    assert out["status"] == 200 and json.loads(out["body"])["session_id"]
    root, = [s for s in spans if s.name == "serve.http"]
    assert _tree(spans, root) == {
        "serve.http": ["serve.read", "serve.request", "serve.write"],
        "serve.read": [], "serve.request": ["serve.upload"],
        "serve.upload": [], "serve.write": []}
    assert root.parent is None and root.attrs == {
        "method": "POST", "path": "/api/upload", "bytes_in": len(wav),
        "status": 200, "bytes_out": len(out["body"])}
    by_name = {s.name: s for s in spans}
    assert by_name["serve.read"].attrs == {"bytes": len(wav)}
    assert by_name["serve.write"].attrs == {"bytes": len(out["body"])}
    assert by_name["serve.request"].attrs == {"method": "POST",
                                              "path": "/api/upload"}
    assert {s.request for s in spans} == {root.request}
    assert len({s.thread for s in spans}) == 1
    assert root.thread != threading.get_native_id()
    kids = sorted((s for s in spans if s.parent == root.index),
                  key=lambda s: s.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_a_collection_is_a_span_under_the_open_phase():
    """``gc.collect(2)`` inside a phase: one ``py.gc`` span of generation
    2, the phase its parent, on its thread, with what it collected."""
    def body():
        with prof.phase("test.gc"):
            cycle = [None]
            cycle[0] = cycle
            del cycle
            gc.collect(2)
    spans, _ = _recorded(body, collections=True)
    outer, = [s for s in spans if s.name == "test.gc"]
    got = [s for s in spans if s.name == prof.GC_SPAN
           and s.parent == outer.index and s.attrs["generation"] == 2]
    assert len(got) == 1
    sp = got[0]
    assert sp.attrs["collected"] >= 1 and sp.attrs["uncollectable"] >= 0
    assert set(sp.attrs) == {"generation", "collected", "uncollectable"}
    assert sp.thread == outer.thread == threading.get_native_id()
    assert sp.request == outer.request
    assert outer.start_ns <= sp.start_ns <= sp.end_ns <= outer.end_ns


def test_off_a_collection_records_nothing():
    assert not prof.recording()
    before = {s.index for s in prof.spans()}
    gc.collect()
    gc.collect(0)
    assert not [s for s in prof.spans() if s.index not in before]


def test_a_second_load_of_the_recorder_installs_no_second_hook():
    def hooks():
        return [cb for cb in gc.callbacks
                if getattr(cb, "__module__", None) == prof.__name__]
    assert len(hooks()) == 1
    spec = importlib.util.spec_from_file_location(prof.__name__,
                                                  prof.__file__)
    again = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(again)
    assert hooks() == [prof._on_gc]


class _Graph:
    """What a capture returns, in place of a ``_FusedGraph``."""

    def __init__(self, bucket):
        self.bucket = bucket


def test_a_capture_is_one_span_a_miss(monkeypatch):
    """A stand-in graph cache of two: each miss is one ``aegis.capture``
    with the graph's bucket, a hit none, and the miss that overflows the
    bound counts the graph it evicted."""
    monkeypatch.setattr(analyze, "FUSED_GRAPHS", 2)
    graphs = analyze.FusedGraphs(torch.device("cuda", 0),
                                 new_replays=lambda device: object())

    def body():
        for key, bucket in ((0, 100), (0, 100), (1, 200), (2, 300),
                            (2, 300)):
            graphs.get(key, lambda pool, b=bucket: _Graph(b))
    spans, _ = _recorded(body)
    assert [(s.name, s.attrs) for s in spans] == [
        ("aegis.capture", {"program": "fused", "bucket": b, "evicted": e})
        for b, e in ((100, 0), (200, 0), (300, 1))]
    assert len(graphs) == 2 and 0 not in graphs
