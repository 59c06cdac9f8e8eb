"""Traffic load: repeated folder passes of ``transcribe_folder``.

The mix's takes are written once as 16-bit WAV files into a folder under
the run's temporary directory; each pass transcribes the whole folder
(``engine``, the configuration's rate, transport and rake threshold) into
a directory of its own, one pass after another for the window.  A
configuration at other audio or pYIN numbers is refused, since
``transcribe_folder`` cannot be given them.  The
rows each track's fused analysis fetched are kept by a tap on the folder
module's ``fetch_analyze`` (a call-through that only holds the result), so
the check reads what the timed passes produced.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from bench_torch import program, takes as takes_mod


class Load:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, root: str,
                 control: str = "none"):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.root, self.control = device, root, control
        self.spans: List = []
        self._tracing = False
        self._rows: List[Dict] = []

    def setup(self) -> None:
        from aegis_tpu_torch.config import AudioConfig, PyinConfig
        from aegis_tpu_torch.engine import folder as folder_mod

        self.folder_mod = folder_mod
        sr = self.cfg["audio"]["sample_rate"]
        # transcribe_folder takes the rate, the transport and the rake
        # threshold; it runs every other audio and pYIN number at the
        # port's defaults
        program.refuse_unless_runs(self.cfg, (
            *program.differing_fields(program.audio_config(self.cfg),
                                      AudioConfig(sample_rate=sr), "audio"),
            *program.differing_fields(program.pyin_config(self.cfg),
                                      PyinConfig(), "pyin")))
        self.takes = takes_mod.make_takes(self.mix["takes"], self.seed, sr,
                                          takes_mod.CACHE)
        self.tmp = tempfile.mkdtemp(prefix="bench_torch_folder_")
        self.src = os.path.join(self.tmp, "in")
        os.makedirs(self.src)
        for name, pcm in self.takes:
            with open(os.path.join(self.src, name + ".wav"), "wb") as f:
                f.write(takes_mod.wav_bytes(pcm, sr))
        self._order = sorted(range(len(self.takes)),
                             key=lambda k: self.takes[k][0])
        fetch = folder_mod.fetch_analyze

        def tap(handle):
            rows = fetch(handle)
            self._rows.append(rows)
            return rows
        # the module's functions as they were, put back by close()
        self._patched = {name: getattr(folder_mod, name)
                         for name in {"fetch_analyze",
                                      *self.mix.get("spans", [])}}
        folder_mod.fetch_analyze = tap
        for name in self.mix.get("spans", []):
            setattr(folder_mod, name, self._timed(name,
                                                  getattr(folder_mod, name)))
        self._passes = 0
        self._one_pass()                      # warm every take length
        self._rows.clear()

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

    def _one_pass(self) -> Dict:
        out = os.path.join(self.tmp, f"out{self._passes:04d}")
        self._passes += 1
        t0 = time.perf_counter()
        res = self.folder_mod.transcribe_folder(
            self.src, output_dir=out,
            sample_rate=self.cfg["audio"]["sample_rate"],
            engine=self.mix["engine"],
            transport=(self.control if self.control != "none"
                       else self.cfg["ingest"]["transport"]),
            rake_sensitivity=self.cfg["analysis"]["rake_sensitivity"],
            device=self.device, **self.mix.get("extract", {}))
        t1 = time.perf_counter()
        sr = self.cfg["audio"]["sample_rate"]
        hop = self.cfg["audio"]["hop_length"]
        return {"t0": t0, "t1": t1, "ms": 1e3 * (t1 - t0), "out": out,
                "ok": len(res) == len(self.takes),
                "n_tracks": len(res),
                "audio_s": sum(len(p) for _, p in self.takes) / sr,
                "decodes": [(1, 1 + len(p) // hop) for _, p in self.takes]}

    def window(self, seconds: float) -> List[Dict]:
        self.items = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.items.append(self._one_pass())
        return self.items

    def traced(self, n: int, warm: bool) -> List[Dict]:
        if warm:
            self._one_pass()
            self._rows.clear()
            return []
        self.spans = []
        self._tracing = True
        try:
            self.items = [self._one_pass() for _ in range(n)]
        finally:
            self._tracing = False
        return self.items

    def samples(self, rng: np.random.Generator) -> List[Dict]:
        """Every track of one pass, drawn by the seed among the passes the
        window ran: its MIDI file and the rows its analysis fetched."""
        k = int(rng.integers(0, len(self.items)))
        n = len(self.takes)
        rows = self._rows[k * n:(k + 1) * n]
        out = []
        for j, idx in enumerate(self._order):
            name, pcm = self.takes[idx]
            path = os.path.join(self.items[k]["out"], name + ".mid")
            midi = open(path, "rb").read() if os.path.exists(path) else b""
            r = rows[j] if j < len(rows) else None
            out.append({"take": name, "pcm": pcm, "events": None,
                        "midi": midi,
                        "rows": None if r is None else
                        {key: np.asarray(v) for key, v in r.items()
                         if np.ndim(v) >= 1}})
        return out

    def close(self) -> None:
        for name, fn in getattr(self, "_patched", {}).items():
            setattr(self.folder_mod, name, fn)
        self._patched = {}
        if getattr(self, "tmp", None):
            shutil.rmtree(self.tmp, ignore_errors=True)
