"""Traffic load: one closed-loop client against the port's REST server.

The server is ``aegis_tpu_torch.serve.server.AegisServer`` around the
engines the configuration states (``program.server``: the v1 engine at its
audio and pYIN numbers, the chord engine at its audio and peel numbers),
on the standard library's
``ThreadingHTTPServer`` through the port's own handler, in a thread of the
run's process; the client is ``bench_torch/client.py`` in a process of its
own.  Sessions stay in the server, as in a deployment.  The mix's file
names the endpoint (``analyze``), the takes and the extraction and MIDI
parameters the endpoint uses, which the check replays on the reference.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

from bench_torch import takes as takes_mod


class Load:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, root: str,
                 control: str = "none"):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.root, self.control = device, root, control
        self.spans: List = []
        self._tracing = False

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from http.server import ThreadingHTTPServer

        from aegis_tpu_torch.serve.http import make_handler

        from bench_torch import program

        sr = self.cfg["audio"]["sample_rate"]
        self.takes = takes_mod.make_takes(self.mix["takes"], self.seed, sr,
                                          takes_mod.CACHE)
        if self.control != "none":
            self._switch_transport(self.control)
        self.tmp = tempfile.mkdtemp(prefix="bench_torch_rest_")
        self.server = program.server(self.cfg, self.device, self.tmp)
        self._wrap_spans()
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         make_handler(self.server.router))
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       daemon=True)
        self.thread.start()
        wavs = [takes_mod.wav_bytes(pcm, sr) for _, pcm in self.takes]
        analyze = self.mix["analyze"]
        if "analysis" in self.cfg:          # the v1 engine's rake threshold
            analyze += ("&" if "?" in analyze else "?") + (
                "rake_sensitivity="
                f"{self.cfg['analysis']['rake_sensitivity']!r}")
        head = {"port": self.httpd.server_address[1],
                "upload": "/api/upload", "analyze": analyze,
                "names": [name for name, _ in self.takes],
                "sizes": [len(w) for w in wavs]}
        env = dict(os.environ, PYTHONPATH=self.root)
        self.client = subprocess.Popen(
            [sys.executable, "-m", "bench_torch.client"], cwd=self.root,
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.client.stdin.write((json.dumps(head) + "\n").encode())
        for w in wavs:
            self.client.stdin.write(w)
        self.client.stdin.flush()
        self._answer()                       # ready
        self._command({"cmd": "once"})       # warm every take length

    def _switch_transport(self, transport: str) -> None:
        """The control: the program's own lower-precision ingest switched
        on for the v1 engine's fused analysis."""
        import functools

        from aegis_tpu_torch.engine import engine as engine_mod

        self._unswitch = (engine_mod, engine_mod.run_analyze)
        engine_mod.run_analyze = functools.partial(engine_mod.run_analyze,
                                                   transport=transport)

    def _wrap_spans(self) -> None:
        """Spans of the benchmark's own around the calls into each layer
        the configuration names (``spans``: label -> attribute path on the
        server), recorded only while a traced slice runs."""
        for label, path in self.cfg.get("spans", {}).items():
            *owner_path, attr = path.split(".")
            owner = self.server
            for part in owner_path:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            setattr(owner, attr, self._timed(label, fn))
        dispatch = self.server.router.dispatch
        self.server.router.dispatch = self._timed("dispatch", dispatch)

    def _timed(self, label: str, fn):
        def wrapper(*args, **kwargs):
            if not self._tracing:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spans.append((label, t0, time.perf_counter()))
        return wrapper

    # ------------------------------------------------------------ traffic

    def _answer(self) -> Dict:
        line = self.client.stdout.readline()
        if not line:
            raise RuntimeError("the REST client ended without an answer")
        return json.loads(line)

    def _command(self, cmd: Dict) -> List[Dict]:
        self.client.stdin.write((json.dumps(cmd) + "\n").encode())
        self.client.stdin.flush()
        items = self._answer()["items"]
        hop = self.cfg["audio"]["hop_length"]
        sr = self.cfg["audio"]["sample_rate"]
        for it in items:
            pcm = self.takes[it["take"]][1]
            it["audio_s"] = len(pcm) / sr
            it["ms"] = 1e3 * (it["t1"] - it["t0"])
            it["ok"] = it["status"] == 200
            # the decode runs over the track's own frames (no bucket pad)
            it["decodes"] = ([(1, 1 + len(pcm) // hop)]
                             if self.cfg.get("viterbi") else [])
        return items

    def window(self, seconds: float) -> List[Dict]:
        self.items = self._command({"cmd": "run", "seconds": seconds})
        return self.items

    def traced(self, n: int, warm: bool) -> List[Dict]:
        """``warm``: one request first, untimed; then n requests with the
        spans on."""
        if warm:
            self._command({"cmd": "count", "n": 1})
            return []
        self.spans = []
        self._tracing = True
        try:
            self.items = self._command({"cmd": "count", "n": n})
        finally:
            self._tracing = False
        return self.items

    # -------------------------------------------------------------- check

    def samples(self, rng: np.random.Generator) -> List[Dict]:
        """One answered request of every take, drawn by the seed among
        those the window served (the longest take among them), with what
        the server returned and what it kept of the analysis."""
        out = []
        for k in range(len(self.takes)):
            done = [it for it in self.items if it["take"] == k and it["ok"]]
            if not done:
                continue
            it = done[int(rng.integers(0, len(done)))]
            body = json.loads(it["body"])
            sess = self.server.sessions.get(body["session_id"])
            rows = sess.get(self.cfg["rows_key"])
            out.append({
                "take": self.takes[k][0],
                "pcm": self.takes[k][1],
                "rows": {key: np.asarray(v) for key, v in rows.items()
                         if key != "y" and np.ndim(v) >= 1},
                "events": [dict(e) for e in sess["events"]],
                "midi": base64.b64decode(body["midi_base64"]),
            })
        return out

    def close(self) -> None:
        client = getattr(self, "client", None)
        if client is not None:
            try:
                client.stdin.write(b'{"cmd": "quit"}\n')
                client.stdin.close()
            except (BrokenPipeError, OSError):
                pass
            try:
                client.wait(timeout=60)
            except subprocess.TimeoutExpired:
                client.kill()
                client.wait()
        httpd = getattr(self, "httpd", None)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self.thread.join(timeout=60)
        self.server = None
        if getattr(self, "_unswitch", None):
            mod, fn = self._unswitch
            mod.run_analyze = fn
            self._unswitch = None
        if getattr(self, "tmp", None):
            shutil.rmtree(self.tmp, ignore_errors=True)
