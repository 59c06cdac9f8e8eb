"""REST API server — the framework's primary serving surface, on the port.

The counterpart of ``aegis_tpu/serve/server.py`` on the port's engines: the
same routes in the same order, the same statuses and messages.  Every
device call of a request runs on the server's device (the engine's; the
card unless the caller names ``device="cpu"``), and none falls back to a
default.  The server is threaded: the lazy builds its request threads
reach (the kernel library, the native host library, the PitchNet weights,
the lazy engines here) are each made once, under a lock.

Same endpoint surface as the reference FastAPI backend (server.py, port
8508; SURVEY.md §2.3), on the stdlib HTTP layer (serve.http):

  GET  /                            SPA
  GET  /api/presets
  POST /api/upload                  multipart "file" or raw body
  POST /api/analyze/{sid}           Phase 1 + 2
  POST /api/refilter/{sid}          Phase 2 only (cached raw_data)
  GET  /api/midi/{sid}
  POST /api/crossfade/{sid}
  GET  /api/midi-wav/{sid}  GET /api/original-wav/{sid}
  POST /api/adsr-synth/{sid}
  POST /api/reverse-analysis/{sid}
  POST /api/auto-match/{sid}
  POST /api/effect-loop/{sid}
  POST /api/per-note-optimize/{sid}
  POST /api/fret-filter/{sid}
  POST /api/events/{sid}            sync client piano-roll edits
  POST /api/stream-start | /api/stream-feed/{sid} | GET /api/stream-events/
       {sid} | POST /api/stream-finalize/{sid}   live-source streaming
       (stream-start?engine=v1|financial|poly&sr=<client rate> — the
       session runs at the CLIENT's PCM rate; every frame->time consumer
       converts through the session's own sr+hop grid)
  GET  /api/tabs/{sid}

Fixed vs the reference (SURVEY.md Appendix A): /api/fret-filter regenerates
the downloadable MIDI from the *filtered* events, not the unfiltered
raw_data.
"""

from __future__ import annotations

import base64
import io
import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.io.audio import load_audio
from aegis_tpu_torch.io.wav import read_wav, write_wav
from aegis_tpu_torch.midi.encode import events_to_midi
from aegis_tpu_torch.serve.http import (HTTPError, Response, Router,
                                        coerce, json_response,
                                        parse_multipart)
from aegis_tpu_torch.serve.sessions import SessionStore
from aegis_tpu_torch.synth.adsr import analyze_envelope, synthesize_midi_adsr
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.synth.presets import EFFECT_PRESETS, GUITAR_ADSR_PRESETS
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.utils.prof import phase

log = get_logger("Server")

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


def _parse_bpm_400(value):
    """Shared bpm query validation (core.tempo.parse_bpm) as a 400, not a
    500: 0 and nan pass float() but crash the MIDI tick math downstream."""
    from aegis_tpu_torch.core.tempo import parse_bpm

    try:
        return parse_bpm(value)
    except ValueError:
        raise HTTPError(400, "bpm must be a positive number or 'auto'")


def _events_json(events):
    return [
        {
            "note": e["note"],
            "start": int(e["start"]),
            "end": int(e["end"]),
            "velocity": int(e["velocity"]),
            "confidence": round(float(e.get("confidence", 0.0)), 3),
            "track": e.get("track", "main"),
            "technique": e.get("technique") or "normal",
            # surfaced only when the poly chain measured an UNPROVABLE
            # octave doubling over this note (VALIDATION.md round 4)
            **({"octave_uncertain": True} if e.get("octave_uncertain")
               else {}),
        }
        for e in events
    ]


def _wav_bytes(y: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, y, sr)
    return buf.getvalue()


class _SpanRouter(Router):
    """The routes, each routed call one root span, ``serve.request``, that
    the server's and the engines' spans of the call nest under."""

    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 body: bytes, content_type: str) -> Response:
        with phase("serve.request", method=method, path=path):
            return super().dispatch(method, path, query, body, content_type)


class AegisServer:
    """All state + routes.  ``router`` can be mounted by serve.http.

    ``device`` ("cuda" by default, "cpu" for the plain versions) builds the
    default engine, ``AegisEngine(sample_rate=44100, device=device)``; a
    given ``engine`` brings its own device, which the server takes."""

    def __init__(self, engine: Optional[AegisEngine] = None,
                 persist_dir: Optional[str] = None,
                 temp_dir: Optional[str] = None, device="cuda"):
        if engine is None:
            engine = AegisEngine(sample_rate=44100,
                                 device=resolve_device(device))
        self.engine = engine
        self.device = engine.device
        self._poly_engine = None  # lazy: chord transcription is optional
        self._auto_engine = None  # lazy: the polyphony-aware router
        self._lazy_lock = threading.Lock()
        self.sessions = SessionStore(persist_dir=persist_dir)
        self.temp_dir = temp_dir or tempfile.mkdtemp(prefix="aegis_")
        self.router = _SpanRouter()
        self._register()

    @property
    def poly_engine(self):
        with self._lazy_lock:
            if self._poly_engine is None:
                from aegis_tpu_torch.engine.poly import AegisPolyEngine

                # sr-proportional window DEFAULTS (4096/1024 at 44.1 kHz) —
                # the accuracy-validated configs (engine/poly.py docstring);
                # poly sessions carry their own hop (_sess_hop) through
                # every frame->time consumer.
                self._poly_engine = AegisPolyEngine(
                    sample_rate=self.engine.sr, device=self.device)
            return self._poly_engine

    @property
    def auto_engine(self):
        with self._lazy_lock:
            if self._auto_engine is None:
                from aegis_tpu_torch.engine.auto import AegisAutoEngine

                # the polyphony-aware router (mixed chords + fast lines);
                # runs the poly engine's sr-proportional grid
                self._auto_engine = AegisAutoEngine(
                    sample_rate=self.engine.sr, device=self.device)
            return self._auto_engine

    # ------------------------------------------------------------------ util

    def _sess(self, sid: str) -> Dict:
        sess = self.sessions.get(sid)
        if sess is None and self.sessions.restore_raw(sid):
            # resume from the on-disk raw_data checkpoint after a restart:
            # the Phase-2 endpoints (refilter, midi, events, tabs) work on
            # the restored analysis; file-backed ones still need re-upload
            sess = self.sessions.get(sid)
        if sess is None:
            raise HTTPError(404, "Session not found. Upload a file first.")
        return sess

    def _sess_hop(self, sess: Dict) -> int:
        """Frame hop of the session's CURRENT event list.  Events are
        frame-indexed, and different producers use different grids: v1/
        financial analyze = the engine hop, offline poly = the poly
        engine's sr-proportional hop (1024 at 44.1 kHz), live streams =
        the transcriber's hop.  Each producer stores it on the session;
        every frame->time consumer (events edit-sync, tabs, fret filter,
        per-note optimizer) must convert with THIS, not the engine hop
        (review finding: live-poly tabs/edits came out at half speed)."""
        return int(sess.get("hop_length") or self.engine.hop_length)

    def _sess_sr(self, sess: Dict) -> int:
        """Sample rate of the session's event grid: live streaming sessions
        may run at a client-chosen rate (/api/stream-start?sr=...); every
        other producer uses the server engine's rate."""
        return int(sess.get("sample_rate") or self.engine.sr)

    def _load_original(self, sess: Dict,
                       duration: Optional[float] = None) -> np.ndarray:
        if not sess.get("file_path"):
            raise HTTPError(400, "Session has no uploaded audio file "
                                 "(live-stream or restored session).")
        y, _ = load_audio(sess["file_path"], sr=self.engine.sr,
                          duration=duration)
        return y

    def _decode_region(self, sess: Dict, start: float,
                       end: Optional[float],
                       sr: Optional[int] = None) -> np.ndarray:
        """Decode the session upload's [start, end] region at the engine
        rate.  Range errors and undecodable uploads are CLIENT errors (400);
        anything past this point is the server's problem (500)."""
        if end is not None and end <= start:
            raise HTTPError(400, f"end_time ({end}) must be greater than "
                                 f"start_time ({start})")
        if not sess.get("file_path"):
            raise HTTPError(400, "Session has no uploaded audio "
                                 "(live-stream sessions use "
                                 "/api/stream-feed)")
        try:
            with phase("serve.decode"):
                y, _ = load_audio(sess["file_path"],
                                  sr=sr or self.engine.sr, offset=start,
                                  duration=(end - start) if end else None)
        except ValueError as e:
            raise HTTPError(400, f"could not decode audio: {e}")
        return y

    def _extract(self, sess: Dict, query: Dict[str, str]):
        params = {
            "confidence_threshold": coerce(query, "confidence_threshold", 0.70),
            "min_note_duration_ms": coerce(query, "min_note_duration_ms", 100),
            "sustain_ms": coerce(query, "sustain_ms", 200),
            "midi_program": coerce(query, "midi_program", 27),
            "noise_gate_db": coerce(query, "noise_gate_db", -40.0),
            # library default True; False restores the reference's exact
            # sustain-merge/lag semantics (core/events.py onset refinement)
            "use_onsets": coerce(query, "use_onsets", True, bool),
        }
        bpm_q = _parse_bpm_400(query.get("bpm"))
        if bpm_q is not None:
            params["bpm"] = bpm_q
        if params.get("bpm") == "auto":
            # resolve ONCE: the number feeds the encode below, the response,
            # and later re-encodes (fret-filter / edit-sync) via
            # sess["params"]
            params["bpm"] = self.engine.estimate_bpm(sess["raw_data"])
        buf = io.BytesIO()
        events = self.engine.extract_events(sess["raw_data"], buf, **params)
        return events, buf.getvalue(), params

    def _extract_auto(self, analysis: Dict, query: Dict[str, str]):
        """Phase-2 of the routed engine: route + merge + encode from the
        cached dual analysis.  Tuning knobs pass through ONLY when the
        client sent them — the router's defaults are the measured routing
        semantics (engine/auto.py), and they feed BOTH sub-pipelines."""
        eng = self.auto_engine
        bpm = _parse_bpm_400(query.get("bpm"))
        if bpm == "auto":
            from aegis_tpu_torch.core.tempo import estimate_tempo

            bpm = estimate_tempo(analysis["poly"]["onset_env"],
                                 eng.sr, eng.hop_length)
        tuning = {name: coerce(query, name, None, float)
                  for name in ("confidence_threshold",
                               "min_note_duration_ms", "sustain_ms",
                               "v1_sustain_ms")
                  if name in query}
        buf = io.BytesIO()
        events = eng.extract_events(
            analysis, buf,
            midi_program=coerce(query, "midi_program", 25),
            bpm=bpm, **tuning)
        return events, buf.getvalue(), bpm

    def _extract_poly(self, sess: Dict, query: Dict[str, str]):
        bpm = _parse_bpm_400(query.get("bpm"))
        if bpm == "auto":
            # resolve ONCE here: the number goes to the encoder AND the
            # response, so the SPA tempo label works in poly mode too
            from aegis_tpu_torch.core.tempo import estimate_tempo

            bpm = estimate_tempo(sess["poly_analysis"]["onset_env"],
                                 self.poly_engine.sr,
                                 self.poly_engine.hop_length)
        buf = io.BytesIO()
        # duration/merge/refinement knobs pass through ONLY when the client
        # sent them: the engine's sustain default differs by mode
        # (onset-refined 120 ms; plain segmentation 40 ms) and a hard
        # server default would pin the wrong mode's numbers
        tuning = {name: coerce(query, name, None, float)
                  for name in ("min_note_duration_ms", "sustain_ms",
                               "sal_ratio", "rise_db", "silence_db",
                               "birth_tol_ms", "snap_back_ms", "decay_frac")
                  if name in query}
        midi_program = coerce(query, "midi_program", 25)
        events = self.poly_engine.extract_events(
            sess["poly_analysis"], buf,
            confidence_threshold=coerce(query, "confidence_threshold", 0.5),
            use_onsets=coerce(query, "use_onsets", True, bool),
            midi_program=midi_program,
            bpm=bpm or None,
            **tuning,
        )
        midi_data = buf.getvalue()
        # sessions.get returns the live dict; mutate in place (same pattern
        # as the analyze endpoint's raw_data store).  The poly engine runs
        # its own sr-proportional frame grid and MIDI defaults — record
        # them so edit-sync / tabs / re-encodes stay on the same grid.
        sess["events"] = events
        sess["midi_data"] = midi_data
        sess["hop_length"] = self.poly_engine.hop_length
        sess["params"] = {**sess.get("params", {}),
                          "midi_program": midi_program, "bpm": bpm or None}
        return events, midi_data, (bpm or None)

    # ---------------------------------------------------------------- routes

    def _register(self) -> None:
        r = self.router

        @r.get("/")
        def root(**kw):
            index = os.path.join(STATIC_DIR, "index.html")
            if os.path.exists(index):
                with open(index, "rb") as f:
                    return Response(f.read(), "text/html")
            return Response(b"<h1>aegis_tpu_torch server</h1>", "text/html")

        @r.get("/api/presets")
        def presets(**kw):
            return json_response({
                "adsr_presets": GUITAR_ADSR_PRESETS,
                "effect_presets": list(EFFECT_PRESETS.keys()),
            })

        @r.get("/api/health")
        def health(query, **kw):
            """Deploy/monitoring probe: backend platform, device count,
            live session count, available optional components.  Reports the
            card ONLY if CUDA is already initialized — a monitoring ping
            must not bring up the CUDA context on the request thread; pass
            probe_device=1 to force init.  A CPU server reports "cpu" and 1."""
            from aegis_tpu_torch.models.pitchnet import have_default_weights
            from aegis_tpu_torch.synth.stems import find_demucs

            platform, n_devices = "uninitialized", 0
            if self.device.type == "cpu":
                platform, n_devices = "cpu", 1
            elif (torch.cuda.is_initialized()
                    or coerce(query, "probe_device", False)):
                try:
                    torch.cuda.init()
                    platform, n_devices = "gpu", torch.cuda.device_count()
                except Exception:  # init failure still reports healthy HTTP
                    pass
            return json_response({
                "status": "ok",
                "platform": platform,
                "n_devices": n_devices,
                "sessions": len(self.sessions),
                "neural_backend": have_default_weights(),
                "demucs": find_demucs() is not None,
                "engine_sr": self.engine.sr,
            })

        @r.post("/api/upload")
        def upload(query, body, content_type, **kw):
            dropped = self.sessions.sweep()  # evict idle sessions (TTL)
            if dropped:
                log.info(f"swept {dropped} idle sessions")
            if "multipart/form-data" in content_type:
                fields = parse_multipart(body, content_type)
                if "file" not in fields:
                    raise HTTPError(400, "missing 'file' field")
                filename, data = fields["file"]
            else:
                filename = query.get("name", "upload.wav")
                data = body
            if not data:
                raise HTTPError(400, "empty upload")
            suffix = os.path.splitext(filename)[1] or ".wav"
            sid = self.sessions.create(file_name=filename, raw_data=None,
                                       events=None, midi_data=None)
            path = os.path.join(self.temp_dir, f"{sid}{suffix}")
            with phase("serve.upload"):
                with open(path, "wb") as f:
                    f.write(data)
                # probe the duration ONCE here (WAV = header math, other
                # formats = ffprobe; never a sample decode) so
                # /api/analyze's turbo=auto decision is format-agnostic and
                # upload stays cheap
                from aegis_tpu_torch.io.audio import probe_duration

                duration_s = probe_duration(data)
            self.sessions.update(sid, file_path=path, duration_s=duration_s)
            return json_response({"session_id": sid, "file_name": filename,
                                  "duration_s": duration_s,
                                  "message": "Upload successful"})

        @r.post("/api/analyze/{sid}")
        def analyze(sid, query, **kw):
            sess = self._sess(sid)
            # turbo=off|tiles|stream|auto: auto picks the bounded-memory
            # streamed path for uploads past stream_threshold_s (the
            # reference hard-caps long tracks instead, aegis_app.py:274-281)
            mode = query.get("turbo", None)
            if mode is None:  # back-compat boolean param
                mode = "tiles" if coerce(query, "turbo_mode", False,
                                         bool) else "auto"
            if mode not in ("off", "tiles", "stream", "auto"):
                raise HTTPError(400, f"unknown turbo mode: {mode}")
            turbo_mode = mode
            if mode == "auto":
                thr = coerce(query, "stream_threshold_s", 240.0)
                start = coerce(query, "start_time", 0.0)
                end = coerce(query, "end_time", None, float)
                dur = sess.get("duration_s")  # probed once at upload
                if dur is not None:
                    effective = (min(end, dur) if end else dur) - start
                    turbo_mode = "stream" if effective > thr else "off"
                # dur unknown (no ffprobe): pass "auto" through — the engine
                # resolves it from the decoded length with the same rule
            pitch_backend = query.get("pitch_backend", "pyin")
            if pitch_backend not in ("pyin", "neural"):
                raise HTTPError(400,
                                f"unknown pitch backend: {pitch_backend}")
            if pitch_backend == "neural":
                from aegis_tpu_torch.models.pitchnet import (
                    have_default_weights)

                if not have_default_weights():
                    raise HTTPError(400, "neural backend unavailable: "
                                         "no PitchNet checkpoint")
            y = self._decode_region(sess,
                                    coerce(query, "start_time", 0.0),
                                    coerce(query, "end_time", None, float))
            # analysis runs OUTSIDE the decode catch: an internal error
            # (e.g. an incompatible PitchNet checkpoint raising ValueError)
            # must surface as a 500, not be mislabeled a client decode error
            raw = self.engine.audio_to_midi(
                y, None,
                turbo_mode=turbo_mode,
                stream_threshold_s=coerce(query, "stream_threshold_s",
                                          240.0),
                rake_sensitivity=coerce(query, "rake_sensitivity", 0.6),
                pitch_backend=pitch_backend,
            )
            if raw is None:
                raise HTTPError(400, "Analysis failed - empty audio?")
            sess["raw_data"] = raw
            events, midi_data, params = self._extract(sess, query)
            with phase("serve.session"):
                self.sessions.update(sid, events=events, midi_data=midi_data,
                                     params=params,
                                     hop_length=self.engine.hop_length)
                self.sessions.checkpoint_raw(sid)
            mode = ({"off": "fused", "tiles": "fused",
                     "stream": "stream", "auto": "auto"}
                    if pitch_backend == "neural" else
                    {"off": "fused", "tiles": "tiles",
                     "stream": "stream", "auto": "auto"})[turbo_mode]
            if (mode == "stream" and pitch_backend == "neural"
                    and (self.engine.hop_length * 22050) % self.engine.sr):
                # the engine falls back to the fused program at rates with
                # no integral 22.05 kHz hop — report what actually ran
                mode = "fused"
            with phase("serve.respond"):
                return json_response({
                    "session_id": sid,
                    "num_events": len(events),
                    "events": _events_json(events),
                    "midi_base64": base64.b64encode(midi_data).decode(),
                    "analysis_mode": mode,
                    "pitch_backend": pitch_backend,
                    "sample_rate": self.engine.sr,
                    "hop_length": self.engine.hop_length,
                    "bpm": params.get("bpm"),
                    "message": (f"Analysis complete: {len(events)} notes "
                                "detected"),
                })

        @r.post("/api/refilter/{sid}")
        def refilter(sid, query, **kw):
            sess = self._sess(sid)
            if sess.get("raw_data") is None:
                raise HTTPError(400, "No analysis data. Run /api/analyze first.")
            events, midi_data, params = self._extract(sess, query)
            self.sessions.update(sid, events=events, midi_data=midi_data,
                                 params=params)
            return json_response({
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
                "bpm": params.get("bpm"),
            })

        @r.get("/api/midi/{sid}")
        def download_midi(sid, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):  # None or b"" (0-event finalize)
                raise HTTPError(400, "No MIDI data. Run analysis first.")
            # sanitize the client-supplied name: Content-Disposition is a
            # latin-1 header (non-ASCII breaks the response mid-write) and
            # CRLF in the value would allow header injection
            safe = "".join(
                c for c in str(sess.get("file_name", "track"))
                if c.isascii() and (c.isalnum() or c in "._- "))[:64] \
                or "track"
            return Response(
                sess["midi_data"], "audio/midi",
                headers={"Content-Disposition":
                         f'attachment; filename="aegis_{safe}.mid"'},
            )

        @r.post("/api/crossfade/{sid}")
        def crossfade(sid, query, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):
                raise HTTPError(400, "No MIDI. Run analysis first.")
            fade = coerce(query, "crossfade", 0.5)
            wav = synthesize_midi(sess["midi_data"], sample_rate=self.engine.sr,
                                  device=self.device)
            if wav is None:
                raise HTTPError(500, "MIDI synthesis failed")
            y_midi, msr = read_wav(wav)
            if y_midi.ndim == 2:
                y_midi = y_midi.mean(axis=1)
            y_orig = self._load_original(sess)
            n = min(len(y_orig), len(y_midi))
            mix = (1.0 - fade) * y_orig[:n] + fade * y_midi[:n]
            peak = np.max(np.abs(mix))
            if peak > 0:
                mix = mix / peak * 0.9
            return Response(_wav_bytes(mix, self.engine.sr), "audio/wav")

        @r.get("/api/midi-wav/{sid}")
        def midi_wav(sid, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):
                raise HTTPError(400, "No MIDI.")
            wav = synthesize_midi(sess["midi_data"], sample_rate=self.engine.sr,
                                  device=self.device)
            if wav is None:
                raise HTTPError(500, "Synthesis failed")
            return Response(wav, "audio/wav")

        @r.get("/api/original-wav/{sid}")
        def original_wav(sid, **kw):
            sess = self._sess(sid)
            y = self._load_original(sess, duration=60.0)
            return Response(_wav_bytes(y, self.engine.sr), "audio/wav")

        @r.post("/api/adsr-synth/{sid}")
        def adsr_synth(sid, query, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):
                raise HTTPError(400, "No MIDI.")
            overrides = {}
            if coerce(query, "envelope_match", False, bool):
                y = self._load_original(sess, duration=10.0)
                overrides = analyze_envelope(y, self.engine.sr)
            wav = synthesize_midi_adsr(
                sess["midi_data"],
                preset=query.get("preset", "electric_clean"),
                sample_rate=self.engine.sr, device=self.device, **overrides,
            )
            if wav is None:
                raise HTTPError(500, "ADSR synthesis failed")
            result = {"wav_base64": base64.b64encode(wav).decode()}
            if overrides:
                result["envelope_params"] = overrides
            return json_response(result)

        @r.post("/api/reverse-analysis/{sid}")
        def reverse(sid, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):
                raise HTTPError(400, "No MIDI.")
            from aegis_tpu_torch.verify.reverse import reverse_analysis

            result = reverse_analysis(sess["midi_data"], self.engine,
                                      sample_rate=self.engine.sr)
            if not result:
                raise HTTPError(500, "Reverse analysis failed")
            return json_response({
                "original_notes": result["original_notes"],
                "reversed_notes": result["reversed_notes"],
                "note_accuracy": round(result["note_accuracy"], 3),
                "pitch_accuracy": round(result["pitch_accuracy"], 3),
                "timing_accuracy": round(result["timing_accuracy"], 3),
            })

        @r.post("/api/auto-match/{sid}")
        def auto_match(sid, **kw):
            sess = self._sess(sid)
            if sess.get("raw_data") is None:
                raise HTTPError(400, "No analysis data.")
            from aegis_tpu_torch.verify.auto_match import (
                auto_match_parameters)

            y = self._load_original(sess)
            result = auto_match_parameters(y, self.engine, sess["raw_data"],
                                           sample_rate=self.engine.sr)
            if not result:
                raise HTTPError(500, "Auto-match failed")
            return json_response(result)

        @r.post("/api/effect-loop/{sid}")
        def effect_loop(sid, query, **kw):
            sess = self._sess(sid)
            if not sess.get("midi_data"):
                raise HTTPError(400, "No MIDI.")
            from aegis_tpu_torch.verify.effect_loop import learning_loop

            preset = query.get("preset", "clean")
            if preset not in EFFECT_PRESETS:
                preset = "clean"
            result = learning_loop(
                sess["midi_data"], self.engine, preset=preset,
                max_iterations=coerce(query, "max_iterations", 5),
                target_accuracy=0.95, sample_rate=self.engine.sr,
            )
            if not result:
                raise HTTPError(500, "Learning loop failed")
            best = result["best_accuracy"]
            return json_response({
                # SPA renders this as a percentage — expose the overall
                # float, with the per-axis breakdown alongside
                "best_accuracy": best.get("overall", 0.0)
                if isinstance(best, dict) else best,
                "accuracy_breakdown": best if isinstance(best, dict) else None,
                "best_params": result["best_params"],
                "iterations": len(result["history"]),
                "history": [
                    {"iteration": h["iteration"],
                     "overall": h["accuracy"]["overall"]}
                    for h in result["history"]
                ],
            })

        @r.post("/api/per-note-optimize/{sid}")
        def per_note(sid, query, **kw):
            sess = self._sess(sid)
            if sess.get("events") is None:
                raise HTTPError(400, "No events.")
            from aegis_tpu_torch.verify.per_note import (
                generate_optimization_report, optimize_all_notes,
                synthesize_with_per_note_params)

            y = self._load_original(sess)
            mode = "quick" if coerce(query, "quick_mode", True, bool) else "precise"
            params = optimize_all_notes(y, sess["events"], self.engine.sr,
                                        self._sess_hop(sess), mode=mode,
                                        device=self.device)
            if not params:
                raise HTTPError(500, "Optimization failed")
            report = generate_optimization_report(params)
            audio = synthesize_with_per_note_params(
                sess["events"], params, self.engine.sr, self._sess_hop(sess),
                device=self.device,
            )
            return json_response({
                "report": report,
                "wav_base64": base64.b64encode(
                    _wav_bytes(audio, self.engine.sr)).decode(),
            })

        @r.post("/api/fret-filter/{sid}")
        def fret_filter(sid, query, **kw):
            sess = self._sess(sid)
            if sess.get("events") is None:
                raise HTTPError(400, "No events. Run analysis first.")
            from aegis_tpu_torch.midi.fret_filter import apply_fret_filter

            filtered, report = apply_fret_filter(
                sess["events"], sr=self._sess_sr(sess),
                hop_length=self._sess_hop(sess),
                max_fret_speed=coerce(query, "max_fret_speed", 40.0),
                protect_long_notes_ms=coerce(query, "protect_long_notes_ms",
                                             200.0),
            )
            # regenerate MIDI from the FILTERED events (reference bug fixed)
            params = sess.get("params", {})
            midi_data = events_to_midi(
                filtered, self._sess_sr(sess), self._sess_hop(sess),
                midi_program=params.get("midi_program", 27),
                bpm=params.get("bpm"), output=None,
            )
            self.sessions.update(sid, events=filtered, midi_data=midi_data)
            return json_response({
                "report": report,
                "events": _events_json(filtered),
                "midi_base64": base64.b64encode(midi_data).decode(),
            })

        @r.post("/api/analyze-poly/{sid}")
        def analyze_poly(sid, query, **kw):
            """Polyphonic (chord) transcription via CQT salience peeling."""
            sess = self._sess(sid)
            y = self._decode_region(sess,
                                    coerce(query, "start_time", 0.0),
                                    coerce(query, "end_time", None, float),
                                    sr=self.poly_engine.sr)
            analysis = self.poly_engine.analyze(y)
            if analysis is None:
                raise HTTPError(400, "Analysis failed - empty audio?")
            analysis.pop("y", None)
            sess["poly_analysis"] = analysis
            events, midi_data, bpm = self._extract_poly(sess, query)
            with phase("serve.respond"):
                return json_response({
                    "session_id": sid,
                    "num_events": len(events),
                    "events": _events_json(events),
                    "midi_base64": base64.b64encode(midi_data).decode(),
                    "bpm": bpm,
                    "sample_rate": self.poly_engine.sr,
                    "hop_length": self.poly_engine.hop_length,
                    "message": f"Polyphonic analysis: {len(events)} notes",
                })

        @r.post("/api/analyze-auto/{sid}")
        def analyze_auto(sid, query, **kw):
            """Polyphony-aware routed transcription (engine/auto.py): one
            entry point for mixed chords + fast monophonic lines."""
            sess = self._sess(sid)
            eng = self.auto_engine
            y = self._decode_region(sess,
                                    coerce(query, "start_time", 0.0),
                                    coerce(query, "end_time", None, float),
                                    sr=eng.sr)
            analysis = eng.analyze(y)
            if analysis is None:
                raise HTTPError(400, "Analysis failed - empty audio?")
            analysis.pop("y", None)
            events, midi_data, bpm = self._extract_auto(analysis, query)
            # the session's frame grid is the AUTO engine's (CLAUDE.md
            # invariant: every frame->time consumer reads _sess_sr/_sess_hop)
            sess["sample_rate"] = eng.sr
            sess["hop_length"] = eng.hop_length
            # auto_analysis is the Phase-1 cache for /api/refilter-auto;
            # poly_analysis additionally feeds the shared chord-aware tabs
            # path (same plane the auto analysis carries)
            self.sessions.update(sid, events=events, midi_data=midi_data,
                                 auto_analysis=analysis,
                                 poly_analysis=analysis["poly"])
            return json_response({
                "session_id": sid,
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
                "bpm": bpm,
                "sample_rate": eng.sr,
                "hop_length": eng.hop_length,
                "message": f"Auto (routed) analysis: {len(events)} notes",
            })

        @r.post("/api/refilter-auto/{sid}")
        def refilter_auto(sid, query, **kw):
            """Phase-2-only instant re-extract for the routed engine: the
            cached dual analysis (v1 rows + poly raw voices) re-routes
            with new knobs without touching the device."""
            sess = self._sess(sid)
            if not isinstance(sess.get("auto_analysis"), dict):
                raise HTTPError(400, "No routed analysis. Run "
                                     "/api/analyze-auto first.")
            events, midi_data, bpm = self._extract_auto(
                sess["auto_analysis"], query)
            self.sessions.update(sid, events=events, midi_data=midi_data)
            return json_response({
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
                "bpm": bpm,
                "sample_rate": self.auto_engine.sr,
                "hop_length": self.auto_engine.hop_length,
            })

        @r.post("/api/refilter-poly/{sid}")
        def refilter_poly(sid, query, **kw):
            sess = self._sess(sid)
            if not isinstance(sess.get("poly_analysis"), dict):
                # live poly stream sessions mark poly_analysis=True (for
                # chord-aware tabs) but re-filter through /api/stream-events
                raise HTTPError(400, "No polyphonic analysis. Run "
                                     "/api/analyze-poly first.")
            events, midi_data, bpm = self._extract_poly(sess, query)
            return json_response({
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
                "bpm": bpm,
                "sample_rate": self.poly_engine.sr,
                "hop_length": self.poly_engine.hop_length,
            })

        @r.post("/api/events/{sid}")
        def put_events(sid, query, body, **kw):
            """Sync client-side piano-roll edits: body = JSON list of event
            dicts.  The server re-encodes MIDI from the edited events so
            /api/midi, crossfade, tabs etc. all reflect the edit."""
            import json as _json

            sess = self._sess(sid)
            try:
                edited = _json.loads(body.decode("utf-8"))
            except Exception:
                raise HTTPError(400, "body must be a JSON list of events")
            if not isinstance(edited, list):
                raise HTTPError(400, "body must be a JSON list of events")
            events = []
            for e in edited:
                try:
                    ev = {
                        "note": int(e["note"]),
                        "start": int(e["start"]),
                        "end": int(e["end"]),
                        "velocity": int(e.get("velocity", 100)),
                        "confidence": float(e.get("confidence", 1.0)),
                        "track": e.get("track", "main"),
                        "technique": None if e.get("technique") in
                        (None, "normal") else e["technique"],
                    }
                except (KeyError, TypeError, ValueError):
                    raise HTTPError(400, "each event needs note/start/end ints")
                # single-frame events (end == start) are legitimate: the
                # extractor emits them when min-duration is below one frame;
                # negative frames would underflow the SMF delta-time encoder
                # into a 500 (midi/smf.py raises on negative deltas)
                if (ev["end"] < ev["start"] or ev["start"] < 0
                        or not 0 <= ev["note"] <= 127):
                    raise HTTPError(400, f"invalid event {ev}")
                if ev["track"] not in ("main", "safe"):
                    raise HTTPError(400, "track must be 'main' or 'safe'")
                if not 0 <= ev["velocity"] <= 127:
                    # 0 is legal — the extractor emits it for <= -80 dB
                    # frames and the encoder clamps it to 1 on note_on
                    # (velocity 0 = note_off in SMF); 128 would wrap
                    raise HTTPError(400, "velocity must be in 0..127")
                events.append(ev)
            events.sort(key=lambda e: (e["start"], e["note"]))
            params = sess.get("params", {})
            # the session's own frame grid + program: a live-poly session's
            # events are frame-indexed at the streamer's hop (1024 at
            # 44.1 kHz) with program 25 — re-encoding with the engine's
            # defaults halved every note time and switched instruments
            midi_data = events_to_midi(
                events, self._sess_sr(sess), self._sess_hop(sess),
                midi_program=params.get("midi_program", 27),
                bpm=params.get("bpm"), output=None,
            )
            self.sessions.update(sid, events=events, midi_data=midi_data)
            return json_response({
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
            })

        @r.get("/api/spectrogram/{sid}")
        def spectrogram(sid, query, **kw):
            """Mel spectrogram as a compact uint8 grid (0..255 over the dB
            range) for the SPA's piano-roll underlay — the reference
            tuning-center's spectrogram plot (aegis_app.py)."""
            sess = self._sess(sid)
            raw = sess.get("raw_data")
            if raw is None or "mel_db" not in raw:
                raise HTTPError(400, "No spectrogram. Run /api/analyze first.")
            mel = np.asarray(raw["mel_db"], np.float32)  # (T, n_mels)
            max_cols = max(1, min(int(coerce(query, "max_cols", 2000)), 8000))
            step = max(1, mel.shape[0] // max_cols)
            mel = mel[::step]
            lo, hi = float(mel.min()), float(mel.max())
            g = np.clip((mel - lo) / max(hi - lo, 1e-6) * 255, 0, 255)
            return json_response({
                "frames": int(mel.shape[0]),
                "n_mels": int(mel.shape[1]),
                "frame_step": step,
                "db_range": [round(lo, 1), round(hi, 1)],
                "grid_base64": base64.b64encode(
                    g.astype(np.uint8).tobytes()).decode(),
            })

        # ------------------------------------------------ live streaming
        # POST /api/stream-start            -> {session_id, lookahead_s}
        # POST /api/stream-feed/{sid}       (body: int16 LE PCM)  -> progress
        # GET  /api/stream-events/{sid}     -> live events
        # POST /api/stream-finalize/{sid}   -> final events + MIDI
        # Beyond-reference: online transcription for live sources
        # (engine.realtime.StreamingTranscriber).

        @r.post("/api/stream-start")
        def stream_start(query, **kw):
            from aegis_tpu_torch.engine.realtime import (
                StreamingPolyTranscriber, StreamingTranscriber)

            self.sessions.sweep()
            engine_kind = query.get("engine", "v1")
            if engine_kind not in ("v1", "financial", "poly"):
                raise HTTPError(400,
                                "engine must be 'v1', 'financial' or 'poly'")
            # client-chosen session rate: a live source at 22.05/16/48 kHz
            # must not be forced onto the server engine's rate (feeding
            # mismatched PCM pitch-shifts everything by the rate ratio)
            sess_sr = coerce(query, "sr", self.engine.sr)
            if not 8000 <= sess_sr <= 96000:
                raise HTTPError(400, "sr must be within 8000..96000")
            if engine_kind == "poly":
                rt = StreamingPolyTranscriber(
                    sample_rate=sess_sr,
                    tile_frames=coerce(query, "tile_frames", 24),
                    halo_frames=coerce(query, "halo_frames", 8),
                    confidence_threshold=coerce(query, "confidence_threshold",
                                                0.5),
                    device=self.device,
                )
            else:
                # financial live streaming: adaptive threshold by default
                # (confidence_threshold passes through only when sent)
                kw = {}
                if engine_kind == "financial":
                    if "confidence_threshold" in query:
                        kw["confidence_threshold"] = coerce(
                            query, "confidence_threshold", None, float)
                else:
                    kw["confidence_threshold"] = coerce(
                        query, "confidence_threshold", 0.5)
                rt = StreamingTranscriber(
                    audio=(self.engine.audio if sess_sr == self.engine.sr
                           else AudioConfig(sample_rate=sess_sr)),
                    tile_frames=coerce(query, "tile_frames", 24),
                    halo_frames=coerce(query, "halo_frames", 8),
                    rake_sensitivity=coerce(query, "rake_sensitivity", 0.6),
                    financial=(engine_kind == "financial"),
                    device=self.device,
                    **kw,
                )
            sid = self.sessions.create(file_name="<live>", raw_data=None,
                                       events=None, midi_data=None,
                                       stream=rt,
                                       # the session's OWN frame grid: the
                                       # poly streamer scales its hop with
                                       # sr (1024 at 44.1 kHz), and live
                                       # sessions may run a client rate
                                       hop_length=(getattr(rt, "hop", None)
                                                   or rt.audio.hop_length),
                                       sample_rate=sess_sr,
                                       # poly sessions render chord-aware
                                       # tabs (see /api/tabs)
                                       poly_analysis=(
                                           True if engine_kind == "poly"
                                           else None))
            return json_response({"session_id": sid,
                                  "engine": engine_kind,
                                  "sample_rate": sess_sr,
                                  # the session's frame grid, so a live
                                  # client can place frame-indexed events
                                  # on its own time axis (the poly
                                  # streamer scales its hop with sr)
                                  "hop_length": (getattr(rt, "hop", None)
                                                 or rt.audio.hop_length),
                                  "lookahead_s": round(rt.lookahead_s, 3)})

        @r.post("/api/stream-feed/{sid}")
        def stream_feed(sid, body, **kw):
            sess = self._sess(sid)
            rt = sess.get("stream")
            if rt is None:
                raise HTTPError(400, "Not a streaming session.")
            if not body:
                raise HTTPError(400, "empty chunk")
            chunk = np.frombuffer(
                body[: (len(body) // 2) * 2], dtype="<i2"
            ).astype(np.float32) / 32768.0
            try:
                tiles = rt.feed(chunk)
            except RuntimeError as e:  # feed after finalize
                raise HTTPError(400, str(e))
            return json_response({
                "tiles_analyzed": tiles,
                "frames_analyzed": rt.frames_analyzed,
                "seconds_analyzed": round(
                    rt.frames_analyzed
                    * (getattr(rt, "hop", None) or rt.audio.hop_length)
                    / self._sess_sr(sess), 3),
            })

        @r.get("/api/stream-events/{sid}")
        def stream_events(sid, **kw):
            sess = self._sess(sid)
            rt = sess.get("stream")
            if rt is None:
                raise HTTPError(400, "Not a streaming session.")
            events = rt.poll_events()
            resp = {"num_events": len(events),
                    "events": _events_json(events)}
            if sess.get("poly_analysis") is not None:
                # live chord symbols for the notes heard so far
                from aegis_tpu_torch.engine.poly import label_chords

                resp["chords"] = label_chords(events,
                                              self._sess_sr(sess),
                                              self._sess_hop(sess))
            return json_response(resp)

        @r.post("/api/stream-finalize/{sid}")
        def stream_finalize(sid, query, **kw):
            sess = self._sess(sid)
            rt = sess.get("stream")
            if rt is None:
                raise HTTPError(400, "Not a streaming session.")
            events = rt.finalize()
            # engine-matched MIDI, same defaults as the offline facades:
            # poly program 25, v1 program 27, financial named-track layout.
            # Frame->time conversion uses the TRANSCRIBER's own hop: the
            # poly streamer scales its window with sr (hop 1024 at 44.1k)
            from aegis_tpu_torch.engine.realtime import (
                StreamingPolyTranscriber)

            rt_hop = getattr(rt, "hop", None) or rt.audio.hop_length
            if not events:
                midi_data = b""
            elif getattr(rt, "financial", False):
                from aegis_tpu_torch.midi.encode import events_to_midi_financial

                midi_data = events_to_midi_financial(
                    events, self._sess_sr(sess), rt_hop, output=None)
            else:
                default_prog = 25 if isinstance(
                    rt, StreamingPolyTranscriber) else 27
                prog = coerce(query, "midi_program", default_prog)
                midi_data = events_to_midi(
                    events, self._sess_sr(sess), rt_hop,
                    midi_program=prog, output=None)
                # edit-sync re-encodes must keep the stream's instrument
                sess["params"] = {**sess.get("params", {}),
                                  "midi_program": prog}
            self.sessions.update(sid, events=events, midi_data=midi_data)
            return json_response({
                "num_events": len(events),
                "events": _events_json(events),
                "midi_base64": base64.b64encode(midi_data).decode(),
            })

        @r.get("/api/tabs/{sid}")
        def tabs(sid, **kw):
            sess = self._sess(sid)
            if sess.get("events") is None:
                raise HTTPError(400, "No events. Run analysis first.")
            from aegis_tpu_torch.midi.tabs import (generate_tabs,
                                                   generate_tabs_chords,
                                                   render_ascii_tab)

            chords = None
            if sess.get("poly_analysis") is not None:
                # chord-aware fingering: simultaneous notes on distinct
                # strings, grouped on the SESSION's frame grid (live-poly
                # streams run an sr-scaled hop)
                tab_data = generate_tabs_chords(
                    sess["events"], self._sess_sr(sess),
                    self._sess_hop(sess))
                from aegis_tpu_torch.engine.poly import label_chords

                chords = label_chords(sess["events"], self._sess_sr(sess),
                                      self._sess_hop(sess))
            else:
                tab_data = generate_tabs(sess["events"])
            spf = self._sess_hop(sess) / self._sess_sr(sess)
            for t in tab_data:
                t["time_sec"] = round(t["m_start"] * spf, 4)
                t["end_sec"] = round(t["m_end"] * spf, 4)
            resp = {
                "tabs": tab_data,
                "total_notes": len(tab_data),
                "ascii": render_ascii_tab(tab_data),
            }
            if chords is not None:
                resp["chords"] = chords
            return json_response(resp)


def main(host: str = "0.0.0.0", port: int = 8508, device="cuda") -> None:
    from aegis_tpu_torch.serve.http import serve_forever

    server = AegisServer(device=device)
    log.info(f"aegis_tpu_torch server on {host}:{port} ({server.device})")
    serve_forever(server.router, host, port)


if __name__ == "__main__":
    import sys

    from aegis_tpu_torch.__main__ import main as cli

    sys.exit(cli(["serve", *sys.argv[1:]]))
