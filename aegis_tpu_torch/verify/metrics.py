"""Transcription quality metrics.

* greedy nearest-note matching with the reference's tolerance (<= 1 semitone,
  <= 0.1 s; reverse_analyzer.py:95-124) producing note/pitch/timing accuracy
  (the metric set of effect_learning_loop.py:644-656),
* note-event F1 — the framework's correctness gate (BASELINE.md: device
  pipeline vs CPU oracle F1 >= 0.99).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def _as_note_times(notes: Sequence[dict]) -> List[Tuple[int, float, float]]:
    return [(int(n["note"]), float(n["start"]), float(n["end"])) for n in notes]


def match_notes(
    reference: Sequence[dict],
    estimated: Sequence[dict],
    max_pitch_diff: float = 1.0,
    max_onset_diff: float = 0.1,
) -> List[Tuple[int, int]]:
    """Greedy nearest matching: each reference note pairs with its closest
    unused estimate by distance |Δpitch|/12 + |Δonset|; a pair counts iff
    within (max_pitch_diff semitones, max_onset_diff seconds)."""
    ref = _as_note_times(reference)
    est = _as_note_times(estimated)
    used = set()
    pairs = []
    for i, (rn, rs, _) in enumerate(ref):
        best_j, best_d = -1, float("inf")
        for j, (en, es, _) in enumerate(est):
            if j in used:
                continue
            pd, td = abs(en - rn), abs(es - rs)
            d = pd / 12.0 + td
            if d < best_d:
                best_d, best_j = d, j
        if best_j >= 0:
            en, es, _ = est[best_j]
            if abs(en - ref[i][0]) <= max_pitch_diff and abs(es - ref[i][1]) <= max_onset_diff:
                used.add(best_j)
                pairs.append((i, best_j))
    return pairs


def note_accuracy_metrics(
    reference: Sequence[dict], estimated: Sequence[dict],
    max_pitch_diff: float = 1.0, max_onset_diff: float = 0.1,
) -> Dict[str, float]:
    """{note_accuracy, pitch_accuracy, timing_accuracy, overall} — the
    reference's learning-loop score: 0.5*note + 0.3*pitch + 0.2*timing."""
    pairs = match_notes(reference, estimated, max_pitch_diff, max_onset_diff)
    if not reference:
        note_acc = 1.0 if not estimated else 0.0
        return {"note_accuracy": note_acc, "pitch_accuracy": note_acc,
                "timing_accuracy": note_acc, "overall": note_acc,
                "matched": 0}
    note_acc = len(pairs) / max(len(reference), len(estimated))
    if pairs:
        pitch_errs = [
            abs(estimated[j]["note"] - reference[i]["note"]) for i, j in pairs
        ]
        time_errs = [
            abs(float(estimated[j]["start"]) - float(reference[i]["start"]))
            for i, j in pairs
        ]
        pitch_acc = sum(1.0 - min(e, 1.0) for e in pitch_errs) / len(pairs)
        timing_acc = sum(1.0 - min(e / max_onset_diff, 1.0) * 0.5 for e in time_errs) / len(pairs)
    else:
        pitch_acc = timing_acc = 0.0
    overall = 0.5 * note_acc + 0.3 * pitch_acc + 0.2 * timing_acc
    return {
        "note_accuracy": note_acc,
        "pitch_accuracy": pitch_acc,
        "timing_accuracy": timing_acc,
        "overall": overall,
        "matched": len(pairs),
    }


def note_event_f1(
    reference: Sequence[dict], estimated: Sequence[dict],
    onset_tolerance: float = 0.05, pitch_tolerance: float = 0.5,
) -> Dict[str, float]:
    """Strict transcription F1: an estimated note is a true positive iff its
    pitch matches within pitch_tolerance semitones and onset within
    onset_tolerance seconds of an unused reference note."""
    pairs = match_notes(reference, estimated, pitch_tolerance, onset_tolerance)
    tp = len(pairs)
    precision = tp / len(estimated) if estimated else (1.0 if not reference else 0.0)
    recall = tp / len(reference) if reference else (1.0 if not estimated else 0.0)
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    return {"precision": precision, "recall": recall, "f1": f1, "tp": tp}


def events_to_seconds(events: Sequence[dict], sr: int, hop_length: int) -> List[dict]:
    """Frame-indexed event dicts -> seconds-based note dicts for metrics."""
    spf = hop_length / sr
    return [
        {
            "note": e["note"],
            "start": e["start"] * spf,
            "end": e["end"] * spf,
            "velocity": e.get("velocity", 64),
        }
        for e in events
    ]
