"""Guitar tablature generation: fingering optimization + ASCII rendering.

Fingering optimizer mirrors the reference (aegis_engine_core/tabs.py:12-37):
per note, enumerate (string, fret) candidates on a 24-fret EADGBE board,
score = 1.5*|fret - center| + 0.2*string, with a 0.7/0.3 leaky-integrator
fret "center of gravity".  The ASCII renderer reproduces the app-side tab
text with b/~// technique symbols (aegis_app.py:421-442).
"""

from __future__ import annotations

from typing import List, Optional

# string 1 = high E ... string 6 = low E (MIDI open pitches)
STANDARD_TUNING = [64, 59, 55, 50, 45, 40]
STRING_NAMES = ["e", "B", "G", "D", "A", "E"]
MAX_FRETS = 24

TECHNIQUE_SYMBOLS = {
    "bend": "b",
    "vibrato": "~",
    "slide": "/",
    "hammer_on": "h",
    "pull_off": "p",
}


def fret_candidates(pitch: int, tuning: Optional[List[int]] = None):
    tuning = tuning or STANDARD_TUNING
    out = []
    for s_idx, open_pitch in enumerate(tuning):
        fret = pitch - open_pitch
        if 0 <= fret <= MAX_FRETS:
            out.append((s_idx + 1, fret))
    return out


def generate_tabs(events: List[dict], tuning: Optional[List[int]] = None) -> List[dict]:
    """Events -> [{time, string, fret, note, technique, m_start, m_end}]."""
    tab_data = []
    fret_center = 5.0
    for evt in events:
        candidates = fret_candidates(evt["note"], tuning)
        if not candidates:
            continue
        string, fret = min(
            candidates, key=lambda c: abs(c[1] - fret_center) * 1.5 + c[0] * 0.2
        )
        fret_center = fret_center * 0.7 + fret * 0.3
        tab_data.append(
            {
                "time": evt["start"],
                "string": string,
                "fret": fret,
                "note": evt["note"],
                "technique": evt.get("technique"),
                "octave_uncertain": bool(evt.get("octave_uncertain")),
                "m_start": evt["start"],
                "m_end": evt["end"],
            }
        )
    return tab_data


def generate_tabs_chords(events: List[dict], sr: int = 22050,
                         hop_length: int = 512,
                         window_ms: float = 50.0,
                         tuning: Optional[List[int]] = None) -> List[dict]:
    """Chord-aware fingering: simultaneous notes get DISTINCT strings.

    Events whose onsets fall within window_ms are fingered together:
    candidates are enumerated per note (high pitch first), strings are
    assigned greedily to minimize fret span around the running fret center
    subject to one-note-per-string.  Single notes degrade to the
    monophonic scorer, so ASCII/MusicXML rendering is unchanged.
    """
    from aegis_tpu_torch.core.poly import group_chords

    tab_data: List[dict] = []
    fret_center = 5.0
    for chord in group_chords(events, sr, hop_length, window_ms):
        used: set = set()
        # one shared column time per chord (render_ascii_tab stacks
        # equal-time entries); per-note frame bounds stay in m_start/m_end
        anchor = min(e["start"] for e in chord["events"])
        # fingering from the highest pitch down: high notes have the fewest
        # playable strings, so they get first pick
        for evt in sorted(chord["events"], key=lambda e: -e["note"]):
            candidates = [
                (s, f) for s, f in fret_candidates(evt["note"], tuning)
                if s not in used
            ]
            if not candidates:
                continue
            string, fret = min(
                candidates,
                key=lambda c: abs(c[1] - fret_center) * 1.5 + c[0] * 0.2,
            )
            used.add(string)
            fret_center = fret_center * 0.7 + fret * 0.3
            tab_data.append({
                "time": anchor,
                "string": string,
                "fret": fret,
                "note": evt["note"],
                "technique": evt.get("technique"),
                "octave_uncertain": bool(evt.get("octave_uncertain")),
                "m_start": evt["start"],
                "m_end": evt["end"],
            })
    tab_data.sort(key=lambda t: (t["time"], t["string"]))
    return tab_data


def render_ascii_tab(tab_data: List[dict], width: int = 72) -> str:
    """Six-line ASCII tablature with technique symbols.

    Entries sharing an onset time (chord fingering from
    generate_tabs_chords) stack in ONE column — real tab convention —
    instead of spilling into consecutive columns; monophonic output is
    unchanged."""
    lines = []
    groups: List[List[dict]] = []
    for t in tab_data:
        if groups and groups[-1][0]["time"] == t["time"]:
            groups[-1].append(t)
        else:
            groups.append([t])

    columns: List[List[str]] = []
    for g in groups:
        entries: dict = {}
        for t in g:
            cell = str(t["fret"])
            sym = TECHNIQUE_SYMBOLS.get(t.get("technique") or "", "")
            if t.get("octave_uncertain"):
                # the poly chain measured an unprovable octave doubling
                # over this note (VALIDATION.md round 4) — mark it so a
                # player knows to listen for the octave
                sym += "?"
            entries.setdefault(t["string"], cell + sym)
        w = max(len(e) for e in entries.values())
        columns.append([entries.get(s, "").ljust(w, "-")
                        for s in range(1, 7)])

    blocks = []
    current = [[] for _ in range(6)]
    cur_w = 0
    for colcells in columns:
        w = len(colcells[0]) + 1
        if cur_w + w > width and cur_w > 0:
            blocks.append(current)
            current = [[] for _ in range(6)]
            cur_w = 0
        for s in range(6):
            current[s].append(colcells[s])
        cur_w += w
    if cur_w:
        blocks.append(current)

    for block in blocks:
        for s in range(6):
            lines.append(f"{STRING_NAMES[s]}|-" + "-".join(block[s]) + "-|")
        lines.append("")
    return "\n".join(lines)
