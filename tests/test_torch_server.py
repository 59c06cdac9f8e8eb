"""The port's REST server (aegis_tpu_torch/serve) on the CPU: its copies
against the JAX package's, every case of tests/test_server.py against the
port's server, one scripted session against the JAX server, the tiled and
streamed modes against the port's facade, concurrent requests against
sequential ones, and the ``serve`` command."""

import base64
import copy
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import test_server as jts
from aegis_tpu.engine.engine import AegisEngine as JAegisEngine
from aegis_tpu.serve import http as jhttp
from aegis_tpu.serve import sessions as jsessions
from aegis_tpu.serve.server import AegisServer as JAegisServer
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.io import read_wav, write_wav
from aegis_tpu_torch.io.audio import load_audio
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.serve import http as thttp
from aegis_tpu_torch.serve import sessions as tsessions
from aegis_tpu_torch.serve.server import AegisServer
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                              generate_chord_progression,
                                              generate_mixed_clip, two_tone)

REPO = Path(__file__).resolve().parents[1]
SR = jts.SR
_req = jts._req
# the SPA's lines that name the device (1-based): the title, the header,
# the status line of an analysis; the port's copy names the GPU there
SPA_DEVICE_LINES = (6, 60, 260)
# event float fields against the JAX engine's: row sums in another order
# (ROADMAP Queue 3, "Within tolerance")
EVENT_FLOAT_TOL = 2e-6


def _start(srv, http=thttp):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                http.make_handler(srv.router))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def port_server():
    srv = AegisServer(engine=AegisEngine(sample_rate=SR, device="cpu"))
    httpd, url = _start(srv)
    yield srv, url
    httpd.shutdown()


@pytest.fixture(scope="module")
def server_url(port_server):
    """The fixture tests/test_server.py's cases take, on the port."""
    return port_server[1]


# ----------------------------------------------------- the copies

def _copy_http():
    ctype = 'multipart/form-data; boundary="xyz"'
    body = (b"--xyz\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"a.wav\"\r\n\r\nRIFFdata\r\n--xyz\r\n"
            b"Content-Disposition: form-data; name=\"note\"\r\n\r\nhi\r\n"
            b"--xyz--\r\n")
    for b, c in ((body, ctype), (b"", ctype), (b"junk", "multipart/form-data")):
        assert _outcome(jhttp.parse_multipart, b, c) == _outcome(
            thttp.parse_multipart, b, c)
    query = {"a": "1.5", "b": "inf", "c": "nan", "d": "7", "e": "yes",
             "f": "x", "g": "1e400", "h": "2.9"}
    for name, default, cast in (("a", 0.0, None), ("b", 0.0, None),
                                ("c", 1.0, None), ("d", 3, None),
                                ("e", False, bool), ("f", "s", None),
                                ("f", 1, None), ("g", 1, None),
                                ("h", 1, None), ("zz", 5, None),
                                ("a", None, float), ("d", None, int)):
        assert _outcome(jhttp.coerce, query, name, default, cast) == \
            _outcome(thttp.coerce, query, name, default, cast), name
    for mod in (jhttp, thttp):
        assert mod.json_response({"x": [1, 2.5, None]}, 201).__dict__ == {
            "content": b'{"x": [1, 2.5, null]}',
            "media_type": "application/json", "status": 201, "headers": {}}

    def routed(mod):
        r = mod.Router()
        r.get("/api/x/{sid}")(lambda sid, **kw: mod.json_response(
            {"sid": sid, "q": kw["query"]}))
        r.post("/api/x/{sid}")(lambda sid, body, **kw: mod.Response(
            body, "text/plain", 202, {"X": sid}))
        out = []
        for method, path in (("GET", "/api/x/ab"), ("POST", "/api/x/cd"),
                             ("GET", "/api/x/a/b"), ("PUT", "/api/x/ab")):
            out.append(_outcome(lambda: vars(r.dispatch(
                method, path, {"k": "v"}, b"body", "text/plain"))))
        return out

    assert routed(jhttp) == routed(thttp)


def _outcome(fn, *args):
    """fn's result, or its HTTPError as (status, detail)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return ("raised", type(e).__name__, getattr(e, "status", None),
                getattr(e, "detail", str(e)))


def _copy_sessions(tmp_path):
    y = generate_bench_track(3.0, sr=SR, seed=5)
    raw = AegisEngine(sample_rate=SR, device="cpu").audio_to_midi(y)
    seen = []
    for mod in (jsessions, tsessions):
        store = mod.SessionStore(persist_dir=str(tmp_path / mod.__name__),
                                 ttl=0.2)
        sid = store.create(file_name="x.wav", raw_data=None)
        kept = store.create(file_name="k.wav")
        path = tmp_path / f"{mod.__name__}.upload"
        path.write_bytes(b"RIFF")
        store.update(sid, raw_data=raw, file_path=str(path))
        ckpt = store.checkpoint_raw(sid)
        assert ckpt and os.path.exists(ckpt)
        assert store.checkpoint_raw(kept) is None   # nothing to persist
        time.sleep(0.15)
        store.update(kept, events=[1])
        time.sleep(0.1)
        swept = store.sweep()                       # sid idle past the TTL
        gone = (store.get(sid) is None, not path.exists(),
                not os.path.exists(ckpt))
        store.update(sid, raw_data=raw)             # no such session now
        store2 = mod.SessionStore(persist_dir=str(tmp_path / mod.__name__))
        ckpt = store2.checkpoint_raw(store2.create(raw_data=raw))
        sid2 = os.path.basename(ckpt)[:-4]
        fresh = mod.SessionStore(persist_dir=str(tmp_path / mod.__name__))
        restored = fresh.restore_raw(sid2)
        back = fresh.get(sid2)["raw_data"]
        seen.append((swept, gone, len(store), store.get(kept)["events"],
                     restored, fresh.restore_raw("nope"), sorted(back),
                     mod.SessionStore().restore_raw(sid2)))
        for k, v in raw.items():   # all NumPy and str: no pickle needed
            np.testing.assert_array_equal(back[k], np.asarray(v))
    assert seen[0] == seen[1]
    assert seen[0][:2] == (1, (True, True, True)) and seen[0][4] is True


def _copy_index_html():
    orig = (REPO / "aegis_tpu/serve/static/index.html").read_bytes()
    port = (REPO / "aegis_tpu_torch/serve/static/index.html").read_bytes()
    a, b = orig.split(b"\n"), port.split(b"\n")
    assert len(a) == len(b)
    differ = [i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y]
    assert differ == list(SPA_DEVICE_LINES)
    for i in SPA_DEVICE_LINES:
        assert b[i - 1] == a[i - 1].replace(b"TPU", b"GPU")
        assert b"GPU" in b[i - 1] and b"TPU" not in b[i - 1]


@pytest.mark.parametrize("what", ["http", "sessions", "index_html"])
def test_copy_equals_its_original(what, tmp_path):
    """serve/http.py and serve/sessions.py are copies of the JAX package's:
    the same inputs give the same results; the SPA is byte for byte the
    original's outside the lines that name the device."""
    fn = globals()[f"_copy_{what}"]
    fn(**({"tmp_path": tmp_path} if what == "sessions" else {}))


def test_server_serves_its_own_spa_on_its_device(port_server):
    srv, url = port_server
    status, ctype, data = _req(url + "/")
    assert data == (REPO / "aegis_tpu_torch/serve/static/index.html"
                    ).read_bytes()
    assert srv.device.type == "cpu" and srv.engine.device == srv.device
    assert srv.poly_engine.device == srv.device
    assert srv.auto_engine.device == srv.device


# ------------------------------- every case of tests/test_server.py, ported

test_full_session_lifecycle = jts.test_full_session_lifecycle
test_polyphonic_endpoints = jts.test_polyphonic_endpoints
test_error_paths = jts.test_error_paths
test_verify_endpoints_over_http = jts.test_verify_endpoints_over_http
test_analyze_turbo_modes = jts.test_analyze_turbo_modes
test_streaming_endpoints = jts.test_streaming_endpoints
test_analyze_neural_backend = jts.test_analyze_neural_backend
test_event_edit_validation_and_filename_sanitization = \
    jts.test_event_edit_validation_and_filename_sanitization
test_param_validation_400s = jts.test_param_validation_400s
test_streaming_poly_endpoints = jts.test_streaming_poly_endpoints
test_streaming_financial_endpoint = jts.test_streaming_financial_endpoint
test_stream_client_rate = jts.test_stream_client_rate
test_spa_live_tab_call_sequence = jts.test_spa_live_tab_call_sequence


def test_health(server_url):
    """As the JAX case, on a CPU server: "cpu" and one device."""
    status, _, data = _req(f"{server_url}/api/health")
    assert status == 200
    j = json.loads(data)
    assert j["status"] == "ok"
    assert isinstance(j["sessions"], int)
    assert isinstance(j["neural_backend"], bool)
    assert j["engine_sr"] == SR
    status, _, data = _req(f"{server_url}/api/health?probe_device=1")
    j = json.loads(data)
    assert j["platform"] == "cpu" and j["n_devices"] == 1


def test_health_never_initializes_cuda(monkeypatch):
    """A card server's unprobed ping leaves CUDA alone; the probe reports
    "gpu" and the device count."""
    import torch

    srv = AegisServer(engine=AegisEngine(sample_rate=SR, device="cpu"))
    srv.device = torch.device("cuda")
    state = {"init": False}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: state["init"])
    monkeypatch.setattr(torch.cuda, "init",
                        lambda: state.__setitem__("init", True))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def health(query):
        return json.loads(srv.router.dispatch("GET", "/api/health", query,
                                              b"", "").content)

    assert health({})["platform"] == "uninitialized" and not state["init"]
    j = health({"probe_device": "1"})
    assert (j["platform"], j["n_devices"], state["init"]) == ("gpu", 4, True)
    assert health({})["platform"] == "gpu"


def test_poly_session_hop_consistency_44k():
    """tests/test_server.py's case on the port's server at 44 100 Hz: poly
    sessions run the poly grid (hop 1024) through tabs and edit-sync."""
    srv = AegisServer(engine=AegisEngine(sample_rate=44100, device="cpu"))
    httpd, base = _start(srv)
    try:
        y, _ = generate_chord_progression(7, sr=44100)
        buf = io.BytesIO()
        write_wav(buf, y, 44100)
        status, _, data = _req(f"{base}/api/upload?name=c.wav", "POST",
                               buf.getvalue())
        sid = json.loads(data)["session_id"]
        status, _, data = _req(f"{base}/api/analyze-poly/{sid}", "POST")
        j = json.loads(data)
        assert status == 200 and j["num_events"] > 0
        assert j["hop_length"] == srv.poly_engine.hop_length == 1024
        assert j["sample_rate"] == 44100
        status, _, data = _req(f"{base}/api/tabs/{sid}")
        tabs = json.loads(data)["tabs"]
        assert tabs
        spf = 1024 / 44100
        for t in tabs:
            assert abs(t["time_sec"] - t["m_start"] * spf) < 5e-5
        status, _, midi_pre = _req(f"{base}/api/midi/{sid}")
        status, _, data = _req(f"{base}/api/events/{sid}", "POST",
                               json.dumps(j["events"]).encode())
        assert status == 200
        status, _, midi_post = _req(f"{base}/api/midi/{sid}")
        key = lambda n: (n["start"], n["note"])  # noqa: E731
        n_pre = sorted(midi_to_notes(midi_pre), key=key)
        n_post = sorted(midi_to_notes(midi_post), key=key)
        assert len(n_pre) == len(n_post)
        for a, b in zip(n_pre, n_post):
            assert a["note"] == b["note"]
            assert abs(a["start"] - b["start"]) < 0.01, (a, b)
    finally:
        httpd.shutdown()


def test_session_store_update_touches_and_ids_unique():
    """tests/test_server.py's case on the port's store."""
    store = tsessions.SessionStore(ttl=0.2)
    sid = store.create(file_name="x.wav")
    assert len(sid) == 16
    time.sleep(0.15)
    store.update(sid, events=[1])
    time.sleep(0.15)
    assert store.sweep() == 0
    assert store.get(sid)["events"] == [1]
    time.sleep(0.25)
    assert store.sweep() == 1


def test_spa_toplevel_js_declarations_unique():
    """tests/test_server.py's scan on the port's copy of the SPA."""
    import re

    src = (REPO / "aegis_tpu_torch/serve/static/index.html").read_text(
        encoding="utf-8")
    m = re.search(r"<script>(.*)</script>", src, re.S)
    assert m, "SPA lost its script block"
    names = []
    for decl in re.finditer(
            r"^(?:const|let|var)\s+([A-Za-z_$][\w$]*(?:\s*=[^,;]*)?"
            r"(?:\s*,\s*[A-Za-z_$][\w$]*(?:\s*=[^,;]*)?)*)",
            m.group(1), re.M):
        for part in decl.group(1).split(","):
            names.append(part.split("=")[0].strip())
    dupes = {n for n in names if names.count(n) > 1}
    assert not dupes, f"duplicate top-level JS declarations: {dupes}"


# ---------------------------------------- one session against the JAX server

def _call(base, path, method="GET", body=None):
    """(status, content type, body); an HTTP error is an answer too."""
    req = urllib.request.Request(base + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _wav(y, sr=SR):
    buf = io.BytesIO()
    write_wav(buf, y, sr)
    return buf.getvalue()


def _pcm(y):
    return np.round(np.clip(y, -1, 1) * 32767).astype("<i2").tobytes()


def _scripted_session(srv, base):
    """The steps a user of the SPA and the API takes, with each answer and
    the session's events at full precision after it."""
    steps = []

    def step(name, path, method="GET", body=None, sid=None):
        status, ctype, data = _call(base, path, method, body)
        sess = srv.sessions.get(sid) if sid else None
        events = copy.deepcopy(sess.get("events")) if sess else None
        steps.append((name, status, ctype, data, events))
        return json.loads(data) if ctype == "application/json" else data

    y = generate_bench_track(6.0, sr=SR, seed=42)
    sid = step("upload", "/api/upload?name=bench.wav", "POST",
               _wav(y))["session_id"]
    step("analyze", f"/api/analyze/{sid}?turbo=off&confidence_threshold=0.5",
         "POST", sid=sid)
    step("refilter", f"/api/refilter/{sid}?confidence_threshold=0.4"
         "&min_note_duration_ms=80&sustain_ms=150&noise_gate_db=-45"
         "&midi_program=30&bpm=96.5", "POST", sid=sid)
    step("refilter_no_onsets", f"/api/refilter/{sid}?confidence_threshold=0.5"
         "&use_onsets=false", "POST", sid=sid)
    step("midi", f"/api/midi/{sid}")
    step("tabs", f"/api/tabs/{sid}")
    step("spectrogram", f"/api/spectrogram/{sid}?max_cols=100")
    step("fret_filter", f"/api/fret-filter/{sid}?max_fret_speed=30", "POST",
         sid=sid)
    step("adsr_synth", f"/api/adsr-synth/{sid}?preset=electric_clean",
         "POST")
    step("midi_wav", f"/api/midi-wav/{sid}")
    edited = [{"note": 64, "start": 0, "end": 40, "velocity": 90,
               "track": "main", "technique": "normal"},
              {"note": 60, "start": 12, "end": 12, "velocity": 0}]
    step("events", f"/api/events/{sid}", "POST", json.dumps(edited).encode(),
         sid=sid)
    step("midi_edited", f"/api/midi/{sid}")

    chord, _ = generate_chord_progression(3, sr=SR)
    psid = step("upload_chord", "/api/upload?name=chord.wav", "POST",
                _wav(chord))["session_id"]
    step("analyze_poly", f"/api/analyze-poly/{psid}", "POST", sid=psid)
    step("refilter_poly", f"/api/refilter-poly/{psid}?min_note_duration_ms=100"
         "&use_onsets=false&confidence_threshold=0.4", "POST", sid=psid)
    step("tabs_poly", f"/api/tabs/{psid}")
    mixed, _ = generate_mixed_clip(1, sr=SR)
    asid = step("upload_mixed", "/api/upload?name=mixed.wav", "POST",
                _wav(mixed))["session_id"]
    step("analyze_auto", f"/api/analyze-auto/{asid}", "POST", sid=asid)
    step("refilter_auto", f"/api/refilter-auto/{asid}?confidence_threshold=0.6"
         "&sustain_ms=150", "POST", sid=asid)
    step("midi_auto", f"/api/midi/{asid}")

    for engine, query in (("v1", "&confidence_threshold=0.5"),
                          ("financial", ""), ("poly", "")):
        clip = two_tone(sr=SR) if engine != "poly" else chord
        ssid = step(f"stream_start_{engine}",
                    f"/api/stream-start?engine={engine}&tile_frames=16"
                    f"&halo_frames=8{query}", "POST")["session_id"]
        pcm = _pcm(clip)
        third = len(pcm) // 3 // 2 * 2
        for i in range(3):
            step(f"stream_feed_{engine}_{i}", f"/api/stream-feed/{ssid}",
                 "POST", pcm[i * third:(i + 1) * third])
            step(f"stream_events_{engine}_{i}", f"/api/stream-events/{ssid}")
        step(f"stream_finalize_{engine}", f"/api/stream-finalize/{ssid}",
             "POST", sid=ssid)
        step(f"stream_feed_after_{engine}", f"/api/stream-feed/{ssid}", "POST",
             pcm[:third])

    bad = step("upload_bad", "/api/upload?name=x.wav", "POST",
               b"RIFF")["session_id"]
    for name, path, method, body in (
            ("unknown_session", "/api/analyze/zzzzzzzz", "POST", None),
            ("refilter_first", f"/api/refilter/{bad}", "POST", None),
            ("undecodable", f"/api/analyze/{bad}", "POST", None),
            ("unknown_route", "/api/nope", "GET", None),
            ("bad_turbo", f"/api/analyze/{sid}?turbo=bogus", "POST", None),
            ("bad_backend", f"/api/analyze/{sid}?pitch_backend=psychic",
             "POST", None),
            ("bad_region", f"/api/analyze/{sid}?start_time=1&end_time=0.5",
             "POST", None),
            ("bad_bpm", f"/api/refilter/{sid}?bpm=fast", "POST", None),
            ("bad_gate", f"/api/refilter/{sid}?noise_gate_db=inf", "POST",
             None),
            ("bad_events", f"/api/events/{sid}", "POST", b"{}"),
            ("bad_note", f"/api/events/{sid}", "POST",
             b'[{"note": 200, "start": 0, "end": 1}]'),
            ("bad_track", f"/api/events/{sid}", "POST",
             b'[{"note": 60, "start": 0, "end": 4, "track": "Main"}]'),
            ("poly_refilter_first", f"/api/refilter-poly/{bad}", "POST",
             None),
            ("auto_refilter_first", f"/api/refilter-auto/{bad}", "POST",
             None),
            ("spectrogram_first", f"/api/spectrogram/{bad}", "GET", None),
            ("midi_first", f"/api/midi/{bad}", "GET", None),
            ("reverse_first", f"/api/reverse-analysis/{bad}", "POST", None),
            ("stream_engine", "/api/stream-start?engine=nope", "POST", None),
            ("stream_rate", "/api/stream-start?engine=v1&sr=4000", "POST",
             None),
            ("feed_not_stream", f"/api/stream-feed/{sid}", "POST",
             b"\x00\x00"),
            ("feed_empty", f"/api/stream-feed/{sid}", "POST", None),
            ("upload_empty", "/api/upload", "POST", None)):
        step(name, path, method, body)
    return steps


def _same_events(a, b, where):
    """Dict for dict: discrete fields equal, float fields within
    EVENT_FLOAT_TOL."""
    assert len(a) == len(b), where
    for ea, eb in zip(a, b):
        assert ea.keys() == eb.keys(), where
        for k in ea:
            if isinstance(ea[k], float):
                assert abs(ea[k] - eb[k]) <= EVENT_FLOAT_TOL, (where, k)
            else:
                assert ea[k] == eb[k], (where, k, ea, eb)


def _wav_samples(data):
    y, sr = read_wav(data)
    return np.round(np.asarray(y, np.float64) * 32768).astype(np.int64), sr


def _same_json(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        if k == "session_id":
            continue
        if k == "events":
            # the served confidence is rounded to 3 places: the session's
            # own events are held within EVENT_FLOAT_TOL below
            strip = lambda evs: [{f: v for f, v in e.items()  # noqa: E731
                                  if f != "confidence"} for e in evs]
            assert strip(a[k]) == strip(b[k]), where
        elif k == "wav_base64":
            ya, ra = _wav_samples(base64.b64decode(a[k]))
            yb, rb = _wav_samples(base64.b64decode(b[k]))
            assert ra == rb and ya.shape == yb.shape, where
            assert np.abs(ya - yb).max() <= 1, where
        elif k == "grid_base64":
            ga = np.frombuffer(base64.b64decode(a[k]), np.uint8)
            gb = np.frombuffer(base64.b64decode(b[k]), np.uint8)
            assert ga.shape == gb.shape, where
            assert np.abs(ga.astype(int) - gb.astype(int)).max() <= 1, where
        elif k == "db_range":
            assert np.allclose(a[k], b[k], atol=0.1 + 1e-9), where
        else:
            assert a[k] == b[k], (where, k, a[k], b[k])


def test_scripted_session_matches_the_jax_server(port_server):
    """One session on both servers with the same seeded clips: equal
    statuses, messages and MIDI bytes; events dict for dict; the
    spectrogram grid within one step; WAV bodies within one int16 step."""
    jsrv = JAegisServer(engine=JAegisEngine(sample_rate=SR,
                                            backend="device"))
    httpd, jurl = _start(jsrv, jhttp)
    try:
        ref = _scripted_session(jsrv, jurl)
    finally:
        httpd.shutdown()
    got = _scripted_session(*port_server)
    assert [s[:3] for s in got] == [s[:3] for s in ref]
    assert len(got) > 50
    for (name, status, ctype, data, events), ref_step in zip(got, ref):
        if ctype == "application/json":
            _same_json(json.loads(data), json.loads(ref_step[3]), name)
        elif ctype == "audio/wav":
            ya, ra = _wav_samples(data)
            yb, rb = _wav_samples(ref_step[3])
            assert ra == rb and ya.shape == yb.shape, name
            assert np.abs(ya - yb).max() <= 1, name
        else:
            assert data == ref_step[3], name
        if events is not None or ref_step[4] is not None:
            _same_events(events, ref_step[4], name)
    by_name = {s[0]: s for s in got}
    assert by_name["analyze"][1] == 200 and by_name["analyze_poly"][1] == 200
    assert json.loads(by_name["analyze_auto"][3])["num_events"] > 0
    assert json.loads(by_name["stream_finalize_poly"][3])["num_events"] > 0


# ------------------------------------------- the tiled and streamed modes

@pytest.mark.parametrize("turbo", ["tiles", "stream"])
def test_tiled_and_streamed_modes_match_the_facade(port_server, turbo,
                                                   tmp_path):
    """The server's tiled and streamed analyses equal the port's facade
    (the JAX server pads its tiles on the test suite's 8-device mesh)."""
    srv, url = port_server
    y = generate_bench_track(8.0, sr=SR, seed=7)
    status, _, data = _req(f"{url}/api/upload?name=t.wav", "POST", _wav(y))
    sid = json.loads(data)["session_id"]
    query = (f"turbo={turbo}&confidence_threshold=0.5"
             + ("&stream_threshold_s=1" if turbo == "stream" else ""))
    status, _, data = _req(f"{url}/api/analyze/{sid}?{query}", "POST")
    j = json.loads(data)
    assert status == 200 and j["analysis_mode"] == turbo
    path = tmp_path / "t.wav"
    path.write_bytes(_wav(y))
    y_dec, _ = load_audio(str(path), sr=SR)
    eng = AegisEngine(sample_rate=SR, device="cpu")
    raw = eng.audio_to_midi(y_dec, None, turbo_mode=turbo,
                            stream_threshold_s=1.0)
    buf = io.BytesIO()
    events = eng.extract_events(raw, buf, confidence_threshold=0.5)
    assert base64.b64decode(j["midi_base64"]) == buf.getvalue()
    assert srv.sessions.get(sid)["events"] == events
    assert j["num_events"] == len(events) > 0


# ------------------------------------------------------------ the decode

def test_analyze_decodes_its_upload_once_on_the_direct_route(port_server):
    """A PCM16 upload is analyzed from one direct decode, and the answer is
    the facade's on the JAX package's decode of the same bytes."""
    from aegis_tpu.io.audio import load_audio as jload_audio
    from aegis_tpu_torch.io import wav as twav

    srv, url = port_server
    body = _wav(generate_bench_track(6.0, sr=SR, seed=11))
    status, _, data = _req(f"{url}/api/upload?name=d.wav", "POST", body)
    sid = json.loads(data)["session_id"]
    before = dict(twav.READS)
    status, _, data = _req(
        f"{url}/api/analyze/{sid}?turbo=off&confidence_threshold=0.5", "POST")
    j = json.loads(data)
    assert status == 200 and j["num_events"] > 0
    assert twav.READS["direct"] - before["direct"] == 1
    assert twav.READS["general"] == before["general"]
    y, _ = jload_audio(body, sr=SR)
    eng = AegisEngine(sample_rate=SR, device="cpu")
    buf = io.BytesIO()
    events = eng.extract_events(eng.audio_to_midi(y, None), buf,
                                confidence_threshold=0.5)
    assert base64.b64decode(j["midi_base64"]) == buf.getvalue()
    assert srv.sessions.get(sid)["events"] == events


# -------------------------------------------------------------- concurrency

def test_concurrent_requests_answer_as_sequential_ones(port_server):
    """Four clients POST /api/analyze on four sessions at once: each answer
    equals that session's sequential answer."""
    _, url = port_server
    sids = []
    for seed in range(4):
        y = generate_bench_track(3.0, sr=SR, seed=50 + seed)
        status, _, data = _req(f"{url}/api/upload?name=c{seed}.wav", "POST",
                               _wav(y))
        sids.append(json.loads(data)["session_id"])
    query = "?turbo=off&confidence_threshold=0.5"

    def analyze(sid):
        status, _, data = _req(f"{url}/api/analyze/{sid}{query}", "POST")
        return status, json.loads(data)

    sequential = [analyze(sid) for sid in sids]
    results = [None] * len(sids)
    barrier = threading.Barrier(len(sids))

    def client(i):
        barrier.wait(timeout=30)
        results[i] = analyze(sids[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert results == sequential
    assert all(s == 200 and j["num_events"] > 0 for s, j in sequential)


# ------------------------------------------------------------ the command

def test_serve_command_parses_as_the_jax_one(monkeypatch):
    """``serve`` takes the JAX command's --host / --port defaults plus
    --device (cuda by default) and hands them to serve.server.main."""
    from aegis_tpu_torch import __main__ as cli
    from aegis_tpu_torch.serve import server

    seen = []
    monkeypatch.setattr(server, "main",
                        lambda host, port, device: seen.append(
                            (host, port, device)))
    assert cli.main(["serve"]) == 0
    assert cli.main(["serve", "--host", "127.0.0.1", "--port", "9001",
                     "--device", "cpu"]) == 0
    assert seen == [("0.0.0.0", 8508, "cuda"), ("127.0.0.1", 9001, "cpu")]
    with pytest.raises(SystemExit):
        cli.main(["serve", "--bogus"])


@pytest.mark.parametrize("argv", [
    ["-m", "aegis_tpu_torch", "serve", "--port", "0"],
    ["-m", "aegis_tpu_torch.serve.server", "--port", "0"]])
def test_serve_command_raises_without_a_card(argv):
    """No device named means the card: without one both ways to start the
    server raise before they listen."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "is_available" in proc.stderr
