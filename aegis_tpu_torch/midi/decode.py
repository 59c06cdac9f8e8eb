"""MIDI → note list (absolute seconds).

The reverse analyzer, per-note optimizer and synthesizers all need note lists
from SMF bytes (reference: reverse_analyzer.py:36-93, synthesizer.py:379-485).
Tempo map is respected (set_tempo meta events change the tick rate).
"""

from __future__ import annotations

from typing import List, Union

from aegis_tpu_torch.midi.smf import DEFAULT_TEMPO_US, MidiFile


def midi_to_notes(path_or_bytes: Union[str, bytes], include_track: bool = True) -> List[dict]:
    """Parse an SMF file into [{note, start, end, velocity, track_index}] with
    times in seconds (``include_track=False`` omits track_index).  Handles
    overlapping notes per (track, channel, note) by matching each note_off
    with the earliest open note_on — channel-keyed, so a bass and a melody
    holding the same pitch on different channels of one track never
    mis-pair.
    """
    mid = MidiFile.load(path_or_bytes)
    tpb = mid.ticks_per_beat

    # Build a global tempo map (tick -> tempo) from all tracks.
    tempo_changes = [(0, DEFAULT_TEMPO_US)]
    for track in mid.tracks:
        abs_tick = 0
        for msg in track:
            abs_tick += msg.time
            if msg.type == "set_tempo":
                tempo_changes.append((abs_tick, msg.tempo))
    # stable sort on tick ONLY: a real set_tempo AT tick 0 must stay after
    # the seeded default so it takes effect from tick 0 (a full tuple sort
    # ordered (0, tempo<500000) BEFORE the default, silently reverting the
    # track to 120 BPM)
    tempo_changes.sort(key=lambda c: c[0])

    def tick_to_seconds(tick: int) -> float:
        secs = 0.0
        prev_tick, tempo = tempo_changes[0]
        for change_tick, new_tempo in tempo_changes[1:]:
            if change_tick >= tick:
                break
            secs += (change_tick - prev_tick) * tempo / 1e6 / tpb
            prev_tick, tempo = change_tick, new_tempo
        secs += (tick - prev_tick) * tempo / 1e6 / tpb
        return secs

    notes: List[dict] = []
    for t_idx, track in enumerate(mid.tracks):
        abs_tick = 0
        # (channel, note) -> list of (start_tick, velocity)
        open_notes: dict = {}
        for msg in track:
            abs_tick += msg.time
            if msg.type == "note_on" and msg.velocity > 0:
                key = (getattr(msg, "channel", 0), msg.note)
                open_notes.setdefault(key, []).append((abs_tick, msg.velocity))
            elif msg.type == "note_off" or (msg.type == "note_on" and msg.velocity == 0):
                stack = open_notes.get((getattr(msg, "channel", 0), msg.note))
                if stack:
                    start_tick, velocity = stack.pop(0)
                    notes.append(
                        {
                            "note": msg.note,
                            "start": tick_to_seconds(start_tick),
                            "end": tick_to_seconds(abs_tick),
                            "velocity": velocity,
                            "track_index": t_idx,
                        }
                    )
        # close dangling notes at track end
        for (_, note), stack in open_notes.items():
            for start_tick, velocity in stack:
                notes.append(
                    {
                        "note": note,
                        "start": tick_to_seconds(start_tick),
                        "end": tick_to_seconds(abs_tick),
                        "velocity": velocity,
                        "track_index": t_idx,
                    }
                )

    if not include_track:
        for n in notes:
            n.pop("track_index", None)
    notes.sort(key=lambda n: (n["start"], n["note"]))
    return notes
