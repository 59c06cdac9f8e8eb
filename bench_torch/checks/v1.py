"""The check of the v1 configuration: the program's answers against the
plain reference (``reference/v1_device.py`` for the rows,
``reference/host_v1.py`` for the events and the MIDI).

For every sampled answer the reference analyses the same take from its
int16 samples, extracts its events with the parameters the cell's
endpoint uses and encodes its MIDI; the numbers, each the worst over the
sample but for the pooled event score:

  prob_gap_p99    the 99th percentile (nearest rank) over a take's frames
                  of |voiced probability - reference|: a frame whose CMNDF
                  trough lies within float32 rounding of one of the 100
                  thresholds moves that threshold's Beta mass whole (up to
                  ~0.06), one or two frames a take, so the largest gap
                  swings with the seed
  rms_gap         largest |RMS - reference| over the reference's peak RMS
  onset_gap       largest |onset strength - reference| over its peak
  mel_gap_db      largest |mel dB - reference| (where the answer has it)
  event_miss_pct  100 (1 - F1) of the answers' notes against the
                  reference's, pooled over the sample, matched one to one
                  (``event_matches``: the same pitch and track, start, end,
                  velocity and confidence within the configuration's
                  ``tol``); from the events where the answer has them,
                  else from its MIDI file against the reference's MIDI
  midi_diff       answers whose MIDI bytes differ from the reference
                  encoder's bytes for the answer's own events (exact)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bench_torch import stats
from bench_torch.reference import host_v1, v1_device

# the reading of a number that has no answer to read (a take the window
# never answered, rows of the wrong length)
MISSING = 1e9


def prob_gap_p99(got, want) -> float:
    return stats.percentile(np.abs(np.asarray(got, np.float64)
                                   - np.asarray(want, np.float64)).tolist(),
                            99)


def midi_notes(data: bytes, ticks_a_frame: float) -> List[Tuple]:
    """(note, track, start, end, velocity, None) of every note of an SMF,
    in frames, each note_off closing the earliest open note_on of its track
    and pitch (a MIDI note carries no confidence)."""
    if not data:
        return []
    mid = host_v1.MidiFile.load(data)
    notes = []
    for k, track in enumerate(mid.tracks):
        tick, open_ = 0, {}
        for msg in track:
            tick += msg.time
            on = msg.type == "note_on" and msg.velocity > 0
            off = msg.type == "note_off" or (msg.type == "note_on"
                                             and msg.velocity == 0)
            if on:
                open_.setdefault(msg.note, []).append((tick, msg.velocity))
            elif off and open_.get(msg.note):
                t0, vel = open_[msg.note].pop(0)
                notes.append((msg.note, k, t0 / ticks_a_frame,
                              tick / ticks_a_frame, vel, None))
    return notes


def event_matches(a: List[Tuple], b: List[Tuple], tol: Dict) -> int:
    """Matches of two note lists (note, track, start, end, velocity,
    confidence), one to one, nearest starts first: the same note and
    track, start and end each within ``tol["frames"]``, velocities within
    ``tol["velocity"]``, confidences (where both have one) within
    ``tol["confidence"]``."""
    by_key: Dict = {}
    for j, nb in enumerate(b):
        by_key.setdefault(nb[:2], []).append(j)
    def close(x, y) -> bool:
        return (abs(x[2] - y[2]) <= tol["frames"]
                and abs(x[3] - y[3]) <= tol["frames"]
                and abs(x[4] - y[4]) <= tol["velocity"]
                and (x[5] is None or y[5] is None
                     or abs(x[5] - y[5]) <= tol["confidence"]))
    pairs = sorted((abs(na[2] - b[j][2]), i, j)
                   for i, na in enumerate(a) for j in by_key.get(na[:2], ())
                   if close(na, b[j]))
    used_a, used_b, hit = set(), set(), 0
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            hit += 1
    return hit


class EventScore:
    """F1 pooled over the sampled answers: matched notes over all notes of
    both sides, so one near-threshold event weighs one event whatever the
    length of its take."""

    def __init__(self):
        self.hit = self.total = 0

    def add(self, got: List[Tuple], want: List[Tuple], tol: Dict) -> None:
        self.hit += 2 * event_matches(got, want, tol)
        self.total += len(got) + len(want)

    def miss_pct(self) -> float:
        return 100.0 * (1.0 - self.hit / self.total) if self.total else 0.0


def _notes(events: List[dict]) -> List[Tuple]:
    return [(e["note"], e["track"], e["start"], e["end"], e["velocity"],
             float(e["confidence"])) for e in events]


def _events_of(rows: Dict, cfg: Dict, params: Dict) -> List[dict]:
    a = cfg["audio"]
    return host_v1.extract_events_v1(
        rake_mask=rows["rake_mask"],
        f0=np.nan_to_num(np.asarray(rows["f0"], np.float64)),
        voiced_flag=rows["voiced_flag"],
        active_probs=np.asarray(rows["voiced_probs"], np.float64),
        rms=np.asarray(rows["rms"], np.float64),
        sr=a["sample_rate"], hop_length=a["hop_length"],
        onset_env=np.asarray(rows["onset_env"], np.float64), **params)


def check(samples: List[Dict], cfg: Dict, mix: Dict,
          device) -> Dict[str, float]:
    """The numbers of ``samples`` against the reference."""
    a = cfg["audio"]
    sr, hop = a["sample_rate"], a["hop_length"]
    extract, midi_kw = mix["extract"], mix["midi"]
    tol = cfg["check"]["tol"]
    ticks_a_frame = hop / sr * host_v1.second2tick(1.0)
    out = {"prob_gap_p99": 0.0, "rms_gap": 0.0, "onset_gap": 0.0,
           "event_miss_pct": 0.0}
    if any(s["rows"] is not None and "mel_db" in s["rows"] for s in samples):
        out["mel_gap_db"] = 0.0
    if any(s["events"] is not None for s in samples):
        out["midi_diff"] = 0.0
    if not samples:
        return {k: MISSING for k in out}
    score = EventScore()
    for s in samples:
        ref = v1_device.analyze(s["pcm"], cfg, device)
        T = len(ref["f0"])
        rows = s["rows"]
        if rows is None or len(rows["f0"]) != T:
            for k in ("prob_gap_p99", "rms_gap", "onset_gap"):
                out[k] = MISSING
        else:
            out["prob_gap_p99"] = max(out["prob_gap_p99"], prob_gap_p99(
                rows["voiced_probs"], ref["voiced_probs"]))
            out["rms_gap"] = max(out["rms_gap"], float(np.max(np.abs(
                np.asarray(rows["rms"], np.float64) - ref["rms"]))
                / max(float(ref["rms"].max()), 1e-12)))
            out["onset_gap"] = max(out["onset_gap"], float(np.max(np.abs(
                np.asarray(rows["onset_env"], np.float64) - ref["onset_env"]))
                / max(float(ref["onset_env"].max()), 1e-12)))
            if "mel_gap_db" in out and "mel_db" in rows:
                out["mel_gap_db"] = max(out["mel_gap_db"], float(np.max(
                    np.abs(np.asarray(rows["mel_db"], np.float64)
                           - ref["mel_db"]))))
        ref_events = _events_of(ref, cfg, extract)
        if s["events"] is not None:
            score.add(_notes(s["events"]), _notes(ref_events), tol)
            encoded = host_v1.events_to_midi(
                [dict(e) for e in s["events"]], sr, hop, **midi_kw)
            out["midi_diff"] += float(encoded != s["midi"])
        else:
            ref_midi = host_v1.events_to_midi(ref_events, sr, hop, **midi_kw)
            score.add(midi_notes(s["midi"], ticks_a_frame),
                      midi_notes(ref_midi, ticks_a_frame), tol)
    out["event_miss_pct"] = score.miss_pct()
    return out
