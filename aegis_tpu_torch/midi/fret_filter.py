"""Fret-physics noise filter.

Maps note events to guitar fretboard positions and removes the weaker note
of any consecutive pair whose required fret travel speed exceeds what a human
hand can do.  Behavioral mirror of the reference
(aegis_engine_core/guitar_fret_filter.py):

  * positions on a 24-fret standard-tuning board (:19-38)
  * minimum fret distance across all position pairs, open strings free (:41-75)
  * removal score = 10*duration_s + 5*confidence + 2*velocity/127 + 3 if
    technique (:78-97)
  * protection for long (>= 200 ms) or high-confidence (>= 0.85) notes
  * hard removal of notes outside the guitar's MIDI range 40..88 (:143-161)
  * default max speed 40 frets/sec

Host-side: operates on event lists (tiny).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# string index 0 = high E ... 5 = low E
STANDARD_TUNING = [64, 59, 55, 50, 45, 40]
MAX_FRETS = 24
GUITAR_MIDI_MIN = 40
GUITAR_MIDI_MAX = 88


def midi_to_fret_positions(midi_note: int,
                           tuning: Optional[List[int]] = None) -> List[Tuple[int, int]]:
    tuning = tuning or STANDARD_TUNING
    return [
        (s_idx, midi_note - open_pitch)
        for s_idx, open_pitch in enumerate(tuning)
        if 0 <= midi_note - open_pitch <= MAX_FRETS
    ]


def min_fret_distance(positions_a, positions_b):
    """Minimum fret travel between any position pair; open strings cost 0.
    Returns (distance, best_a, best_b)."""
    if not positions_a or not positions_b:
        return 999, None, None
    best = (999, positions_a[0], positions_b[0])
    for pa in positions_a:
        for pb in positions_b:
            dist = 0 if (pa[1] == 0 or pb[1] == 0) else abs(pa[1] - pb[1])
            if dist < best[0]:
                best = (dist, pa, pb)
    return best


def _removal_score(event: Dict, sr: int, hop_length: int) -> float:
    duration_sec = (event["end"] - event["start"]) * hop_length / sr
    score = duration_sec * 10.0
    score += event.get("confidence", 0.5) * 5.0
    score += event.get("velocity", 64) / 127.0 * 2.0
    if event.get("technique") in ("bend", "vibrato", "slide", "hammer_on",
                                  "pull_off"):
        score += 3.0
    return score


def _empty_report(count: int) -> Dict:
    return {"original_count": count, "filtered_count": count,
            "removed_count": 0, "removed_notes": [], "max_fret_speed": 0}


def apply_fret_filter(
    events: List[Dict],
    sr: int = 44100,
    hop_length: int = 512,
    max_fret_speed: float = 40.0,
    protect_long_notes_ms: float = 200.0,
    min_confidence_protect: float = 0.85,
) -> Tuple[List[Dict], Dict]:
    """Returns (filtered_events, report)."""
    if not events or len(events) < 2:
        return list(events), _empty_report(len(events))

    protect_long_frames = int((protect_long_notes_ms / 1000.0) * sr / hop_length)
    positions = [midi_to_fret_positions(e["note"]) for e in events]

    remove: set = set()
    removed_details: List[Dict] = []

    def mark(idx: int, reason: str, **extra) -> None:
        if idx not in remove:
            remove.add(idx)
            e = events[idx]
            removed_details.append(
                {"index": idx, "note": e["note"], "start": e["start"],
                 "end": e["end"], "reason": reason, **extra}
            )

    # range removal is UNCONDITIONAL (the documented hard filter): doing it
    # inside the pair loop let chord-simultaneous and trailing out-of-range
    # notes slip past the chord-skip / last-pair boundary
    for i, e in enumerate(events):
        if not (GUITAR_MIDI_MIN <= e["note"] <= GUITAR_MIDI_MAX):
            mark(i, "out_of_guitar_range")

    for i in range(len(events) - 1):
        curr, nxt = events[i], events[i + 1]
        if i in remove or (i + 1) in remove:
            continue  # a removed note must not drive fret-speed analysis
        if abs(nxt["start"] - curr["start"]) < 2:  # chord: skip
            continue

        pos_a, pos_b = positions[i], positions[i + 1]
        if not pos_a or not pos_b:
            continue
        fret_dist, _, _ = min_fret_distance(pos_a, pos_b)
        if fret_dist == 0:
            continue

        time_gap = (nxt["start"] - curr["end"]) * hop_length / sr
        if time_gap <= 0:
            time_gap = (nxt["start"] - curr["start"]) * hop_length / sr
        time_gap = max(time_gap, 0.001)

        required_speed = fret_dist / time_gap
        if required_speed <= max_fret_speed:
            continue

        curr_protected = (
            (curr["end"] - curr["start"]) >= protect_long_frames
            or curr.get("confidence", 0) >= min_confidence_protect
        )
        nxt_protected = (
            (nxt["end"] - nxt["start"]) >= protect_long_frames
            or nxt.get("confidence", 0) >= min_confidence_protect
        )
        if curr_protected and nxt_protected:
            continue

        score_curr = _removal_score(curr, sr, hop_length)
        score_nxt = _removal_score(nxt, sr, hop_length)
        if nxt_protected or (not curr_protected and score_curr < score_nxt):
            target = i
        else:
            target = i + 1
        mark(
            target, "fret_speed_exceeded",
            required_speed=round(required_speed, 1),
            max_allowed=max_fret_speed,
            fret_distance=fret_dist,
            time_gap_ms=round(time_gap * 1000, 1),
        )

    filtered = [e for i, e in enumerate(events) if i not in remove]
    return filtered, {
        "original_count": len(events),
        "filtered_count": len(filtered),
        "removed_count": len(remove),
        "removed_notes": removed_details,
        "max_fret_speed": max_fret_speed,
    }
