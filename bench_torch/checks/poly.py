"""The check of the poly configuration: the program's answers against the
plain reference (``reference/poly_device.py`` for the analysis,
``reference/host_poly.py`` for the events, ``reference/host_v1.py`` for
the MIDI).

For every sampled answer the reference analyses the same take from its
int16 samples, extracts its events with the endpoint's parameters and
encodes its MIDI; the numbers, each the worst over the sample:

  roll_diff_pct   frames (%) whose accepted notes (a row of the piano
                  roll) differ
  sal_gap_p99     the 99th percentile (nearest rank) over a take's frames
                  of the frame's largest |salience - reference|, over the
                  reference's peak: where a near-tie flips or reorders the
                  peel's picks the salience moves whole (0.055 of the peak
                  on one frame), and roll_diff_pct counts what that does
                  to the accepted notes
  rms_gap         largest |RMS - reference| over the reference's peak RMS
  onset_gap       largest |onset strength - reference| over its peak
  cqt_gap_db      largest dB gap of the CQT magnitudes, each floored 60 dB
                  under the reference's peak
  event_miss_pct  100 (1 - F1) of the answer's events against the
                  reference's, pooled over the sample (``checks.v1.EventScore``)
  midi_diff       answers whose MIDI bytes differ from the reference
                  encoder's bytes for the answer's own events (exact)

With ``control`` set the reference computes with that lower-precision
ingest in the program's place (the program has no such path of its own).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from bench_torch import stats
from bench_torch.checks.v1 import MISSING, EventScore, _notes
from bench_torch.reference import host_poly, host_v1, poly_device


def _rel_gap(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b))
                 / max(float(np.max(np.abs(b))), 1e-12))


def _db(m: np.ndarray, floor: float) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(np.asarray(m, np.float64), floor))


def answer_of(pcm, cfg: Dict, mix: Dict, device, transport: str) -> Dict:
    """What a program following the configuration would answer for a take:
    the reference's analysis, events and MIDI bytes."""
    a = cfg["audio"]
    rows = poly_device.analyze(pcm, cfg, device, transport)
    events = host_poly.extract_events_poly(
        rows, a["sample_rate"], a["hop_length"], a["n_fft"], **mix["extract"])
    midi = host_v1.events_to_midi([dict(e) for e in events], a["sample_rate"],
                                  a["hop_length"], **mix["midi"])
    return {"rows": rows, "events": events, "midi": midi}


def check(samples: List[Dict], cfg: Dict, mix: Dict, device,
          control: Optional[str] = None) -> Dict[str, float]:
    a = cfg["audio"]
    sr, hop = a["sample_rate"], a["hop_length"]
    tol = cfg["check"]["tol"]
    keys = ("roll_diff_pct", "sal_gap_p99", "rms_gap", "onset_gap", "cqt_gap_db",
            "event_miss_pct", "midi_diff")
    if not samples:
        return {k: MISSING for k in keys}
    out = dict.fromkeys(keys, 0.0)
    score = EventScore()
    for s in samples:
        if control:
            s = dict(s, **answer_of(s["pcm"], cfg, mix, device, control))
        ref = answer_of(s["pcm"], cfg, mix, device, "int8")
        r, rows = ref["rows"], s["rows"]
        T = len(r["rms"])
        if rows is None or len(rows["rms"]) != T:
            for k in keys[:5]:
                out[k] = MISSING
        else:
            diff = np.any(np.asarray(rows["roll"], bool) != r["roll"], axis=1)
            out["roll_diff_pct"] = max(out["roll_diff_pct"],
                                       100.0 * float(np.mean(diff)))
            gap = np.max(np.abs(np.asarray(rows["salience"], np.float64)
                                - r["salience"]), axis=1)
            out["sal_gap_p99"] = max(out["sal_gap_p99"], stats.percentile(
                gap.tolist(), 99) / max(float(np.max(r["salience"])), 1e-12))
            out["rms_gap"] = max(out["rms_gap"], _rel_gap(rows["rms"], r["rms"]))
            out["onset_gap"] = max(out["onset_gap"],
                                   _rel_gap(rows["onset_env"], r["onset_env"]))
            floor = 1e-3 * float(np.max(r["cqt_mag"]))
            out["cqt_gap_db"] = max(out["cqt_gap_db"], float(np.max(np.abs(
                _db(rows["cqt_mag"], floor) - _db(r["cqt_mag"], floor)))))
        score.add(_notes(s["events"]), _notes(ref["events"]), tol)
        encoded = host_v1.events_to_midi([dict(e) for e in s["events"]], sr,
                                         hop, **mix["midi"])
        out["midi_diff"] += float(encoded != s["midi"])
    out["event_miss_pct"] = score.miss_pct()
    return out
