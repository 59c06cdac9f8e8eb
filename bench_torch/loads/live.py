"""Traffic load: one live session replayed closed-loop.

A ``StreamingTranscriber`` (the configuration's rate, the mix's tile and
halo, v1) is fed the mix's take in chunks of ``chunk_s``; after every chunk
it is polled (``poll_events``), and the next chunk goes as soon as the
poll has answered.  An item is one chunk: its wait is feed + poll.  The
set-up runs a throwaway session over the take's first seconds, so the
tile program and the poll path are warm before the measured session
starts from the take's beginning.  Where the take runs out before the
window closes, a new session starts over the same take, between two
chunks, so that no speed of the program can end a run.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from bench_torch import program, takes as takes_mod


class Load:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, root: str,
                 control: str = "none"):
        if control != "none":
            raise ValueError("a live session has no lower-precision path of "
                             "its own: its control is the reference's")
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.spans: List = []
        self._tracing = False
        self.polls: List = []

    def _session(self):
        from aegis_tpu_torch.engine.realtime import StreamingTranscriber

        live = self.mix["live"]
        return StreamingTranscriber(
            audio=program.audio_config(self.cfg),
            pyin_cfg=program.pyin_config(self.cfg),
            tile_frames=live["tile_frames"], halo_frames=live["halo_frames"],
            rake_sensitivity=self.cfg["analysis"]["rake_sensitivity"],
            device=self.device)

    def setup(self) -> None:
        program.refuse_unless_runs(self.cfg)
        sr = self.cfg["audio"]["sample_rate"]
        (_, self.pcm), = takes_mod.make_takes(self.mix["takes"], self.seed,
                                              sr, takes_mod.CACHE)
        self.y = takes_mod.pcm_float(self.pcm)
        self.chunk = int(round(self.mix["live"]["chunk_s"] * sr))
        warm = self._session()
        for k in range(int(self.mix["live"]["warm_chunks"])):
            warm.feed(self.y[k * self.chunk:(k + 1) * self.chunk])
            warm.poll_events()
        self._new_session()

    def _new_session(self) -> None:
        self.rt = self._session()
        self.pos = 0

    def _one_chunk(self) -> Dict:
        if self.pos + self.chunk > len(self.y):
            # the take has run out: the same take again in a new session,
            # set up outside any chunk's time
            self._new_session()
        piece = self.y[self.pos:self.pos + self.chunk]
        t0 = time.perf_counter()
        tiles = self.rt.feed(piece)
        t1 = time.perf_counter()
        events = self.rt.poll_events()
        t2 = time.perf_counter()
        self.pos += self.chunk
        if self._tracing:
            self.spans += [("feed", t0, t1), ("poll", t1, t2)]
        self.polls.append((self.rt, self.rt.frames_analyzed, events))
        live = self.mix["live"]
        return {"t0": t0, "t1": t2, "ms": 1e3 * (t2 - t0), "ok": True,
                "audio_s": len(piece) / self.cfg["audio"]["sample_rate"],
                "decodes": [(1, live["tile_frames"] + 2 * live["halo_frames"])]
                * tiles}

    def window(self, seconds: float) -> List[Dict]:
        self.items = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            self.items.append(self._one_chunk())
        return self.items

    def traced(self, n: int, warm: bool) -> List[Dict]:
        if warm:
            self._one_chunk()
            return []
        self.spans = []
        self._tracing = True
        try:
            self.items = [self._one_chunk() for _ in range(n)]
        finally:
            self._tracing = False
        return self.items

    def samples(self, rng: np.random.Generator) -> List[Dict]:
        """Polls drawn by the seed among those the window answered, and its
        last, with their session's rows up to each."""
        n = len(self.items)
        polls = self.polls[-n:]
        picks = sorted(set(rng.choice(n, min(int(self.mix["check_polls"]), n),
                                      replace=False).tolist()) | {n - 1})
        tile = self.mix["live"]["tile_frames"]
        stacked = {}
        out = []
        for i in picks:
            rt, frames, events = polls[i]
            if id(rt) not in stacked:
                stacked[id(rt)] = rt._stacked()
            rows = stacked[id(rt)]
            out.append({"pcm": self.pcm, "n_tiles": frames // tile,
                        "events": [dict(e) for e in events],
                        "rows": {k: np.asarray(v)[:frames]
                                 for k, v in rows.items()}})
        return out

    def close(self) -> None:
        self.rt, self.polls = None, []
