"""The check of a live session: the polls the window answered against the
plain reference (``reference/live_device.py`` for the session rows,
``reference/host_v1.py`` for the events).

A poll answers with the events of every tile analysed so far.  For each
sampled poll the reference builds the rows of as many tiles of the same
take and extracts their events with the session's parameters; the
numbers, each the worst over the sample (as in ``checks/v1.py``): rms_gap
and onset_gap over the session's rows, and event_miss_pct over the polls'
events, pooled.  (The voiced probabilities are compared through the
events' confidence: their 99th-percentile gap did not tell the program
from its control, the 8-bit slabs, on every seed.)  With ``control`` set the
reference computes on that lower-precision slab transport in the
program's place (the program has no such path of its own).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from bench_torch.checks.v1 import MISSING, EventScore, _events_of, _notes
from bench_torch.reference import live_device

KEYS = ("rms_gap", "onset_gap", "event_miss_pct")


def _cut(rows: Dict, T: int) -> Dict:
    return {k: np.asarray(v)[:T] for k, v in rows.items()}


def check(samples: List[Dict], cfg: Dict, mix: Dict, device,
          control: Optional[str] = None) -> Dict[str, float]:
    if not samples:
        return dict.fromkeys(KEYS, MISSING)
    live = mix["live"]
    tol = cfg["check"]["tol"]
    pcm = samples[0]["pcm"]
    most = max(s["n_tiles"] for s in samples)
    ref_all = live_device.rows(pcm, most, cfg, live, device)
    ctl_all = (live_device.rows(pcm, most, cfg, live, device, control)
               if control else None)
    out = dict.fromkeys(KEYS, 0.0)
    score = EventScore()
    for s in samples:
        T = s["n_tiles"] * live["tile_frames"]
        ref = _cut(ref_all, T)
        # a poll before the session's first tile answers no events
        ref_events = _events_of(ref, cfg, mix["extract"]) if T else []
        if ctl_all is not None:
            rows = _cut(ctl_all, T)
            events = _events_of(rows, cfg, mix["extract"]) if T else []
        else:
            rows, events = s["rows"], s["events"]
        if rows is None or len(rows["rms"]) != T:
            for k in KEYS[:2]:
                out[k] = MISSING
        elif T:
            for k, name in (("rms", "rms_gap"), ("onset_env", "onset_gap")):
                gap = np.max(np.abs(np.asarray(rows[k], np.float64) - ref[k]))
                scale = max(float(np.max(np.abs(ref[k]))), 1e-12)
                out[name] = max(out[name], float(gap) / scale)
        score.add(_notes(events), _notes(ref_events), tol)
    out["event_miss_pct"] = score.miss_pct()
    return out
