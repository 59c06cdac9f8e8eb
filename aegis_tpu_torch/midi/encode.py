"""Note events → Standard MIDI File.

Reproduces the reference's two encoders:

* v1 dual-track encoder with articulation rendering — hammer-on/pull-off
  velocity scaling (×0.6 / ×0.5), 15-point accelerating pitch-bend curve for
  bends, sine-LFO pitch-bend for vibrato, per-track delta-time encoding
  (reference: aegis_engine.py:98-179).
* v2 "financial" encoder — named Main/Safe tracks, fixed 120 BPM tick math
  (reference: aegis_engine_financial.py:188-245).

Event dict schema (the inter-layer currency, reference midi_logic.py:74-79):
  {note:int, start:frame, end:frame, confidence:float, velocity:int,
   track:'main'|'safe', technique:None|'bend'|'vibrato'|'slide'|'hammer_on'|
   'pull_off', slope:float, rms_energy:float}
"""

from __future__ import annotations

import io
import math
from typing import List, Optional, Union

from aegis_tpu_torch.midi.smf import (
    DEFAULT_TEMPO_US,
    DEFAULT_TICKS_PER_BEAT,
    MidiFile,
    MidiMessage,
    MidiTrack,
    second2tick,
)


def _tempo_us(bpm) -> int:
    """set_tempo microseconds per beat; rejects bpm values the tick math
    cannot survive (0 -> ZeroDivisionError, nan -> int(nan))."""
    import math

    bpm = float(bpm)
    if not math.isfinite(bpm) or bpm <= 0:
        raise ValueError(f"bpm must be a positive finite number, got {bpm}")
    return max(1, int(round(60e6 / bpm)))


def events_to_midi(
    events: List[dict],
    sr: int,
    hop_length: int,
    *,
    midi_program: int = 27,
    vibrato_rate: float = 5.0,
    vibrato_depth: float = 0.3,
    bpm: Optional[float] = None,
    output: Union[str, io.BytesIO, None] = None,
) -> Optional[bytes]:
    """v1 encoder: dual main/safe tracks with bend & vibrato pitchwheel curves.

    ``bpm`` (beyond-reference, core.tempo): write a set_tempo meta event and
    use that tempo in the tick math, so note WALL-CLOCK times are unchanged
    but the musical grid aligns with the track (the reference always encodes
    at an implicit 120 BPM).  None keeps the reference behavior.

    Returns the SMF bytes when ``output`` is None, otherwise writes to the
    path / stream.
    """
    tempo_us = DEFAULT_TEMPO_US if bpm is None else _tempo_us(bpm)
    mid = MidiFile(ticks_per_beat=DEFAULT_TICKS_PER_BEAT)
    track_main, track_safe = MidiTrack(), MidiTrack()
    mid.tracks.extend([track_main, track_safe])
    if bpm is not None:
        track_main.append(MidiMessage("set_tempo", tempo=tempo_us, time=0))
    for t in (track_main, track_safe):
        t.append(MidiMessage("program_change", program=midi_program, time=0))

    secs_per_frame = hop_length / sr
    ticks_per_sec = second2tick(1.0, DEFAULT_TICKS_PER_BEAT, tempo_us)

    timeline = []  # absolute-tick event list, sorted later
    for evt in events:
        st = int(evt["start"] * secs_per_frame * ticks_per_sec)
        et = int(evt["end"] * secs_per_frame * ticks_per_sec)
        technique = evt.get("technique")
        velocity = int(evt["velocity"])
        if technique == "hammer_on":
            velocity = int(velocity * 0.6)  # softened attack
        elif technique == "pull_off":
            velocity = int(velocity * 0.5)
        # velocity 0 is a legal EVENT (velocity_from_db clips -80 dB frames
        # to 0, and the technique scaling above can floor 1 to 0) but a
        # note_on with velocity 0 means note_off in SMF — clamp on encode.
        # The high side matters too: smf.py masks with & 0x7F, so an
        # unclamped 128 would WRAP to 0 (= note_off) instead of fortissimo
        velocity = min(127, max(1, velocity))

        tr = evt["track"]
        timeline.append({"t": st, "o": "on", "n": evt["note"], "tr": tr, "v": velocity})
        timeline.append({"t": et, "o": "off", "n": evt["note"], "tr": tr, "v": 0})

        if technique == "bend":
            duration_ticks = et - st
            slope = float(evt.get("slope", 0.0))
            bend_semitones = min(2.0, abs(slope) * 10)
            direction = 1 if slope > 0 else -1
            max_bend = int(direction * (bend_semitones / 2.0) * 8191)
            n_pts = 15
            for i in range(n_pts):
                progress = i / n_pts
                curve = 1 - (1 - progress) ** 2  # fast start, slow finish
                timeline.append(
                    {
                        "t": st + int(progress * duration_ticks),
                        "o": "pw",
                        "tr": tr,
                        "pitch": int(max_bend * curve),
                    }
                )
            timeline.append({"t": et, "o": "pw", "tr": tr, "pitch": 0})
        elif technique == "vibrato":
            duration_ticks = et - st
            duration_secs = duration_ticks / ticks_per_sec
            n_pts = max(10, min(20, int(duration_secs * vibrato_rate * 4)))
            for i in range(n_pts):
                phase = (i / n_pts) * duration_secs * vibrato_rate * 2 * math.pi
                timeline.append(
                    {
                        "t": st + int((i / n_pts) * duration_ticks),
                        "o": "pw",
                        "tr": tr,
                        "pitch": int(math.sin(phase) * 8191 * vibrato_depth),
                    }
                )
            timeline.append({"t": et, "o": "pw", "tr": tr, "pitch": 0})

    timeline.sort(key=lambda x: x["t"])

    last = {"main": 0, "safe": 0}
    for e in timeline:
        track = track_main if e["tr"] == "main" else track_safe
        delta = e["t"] - last[e["tr"]]
        if e["o"] == "pw":
            track.append(MidiMessage("pitchwheel", pitch=e["pitch"], time=delta))
        else:
            track.append(
                MidiMessage(
                    "note_on" if e["o"] == "on" else "note_off",
                    note=int(e["n"]),
                    velocity=int(e["v"]),
                    time=delta,
                )
            )
        last[e["tr"]] = e["t"]

    return mid.save(output)


def events_to_midi_financial(
    events: List[dict],
    sr: int,
    hop_length: int,
    *,
    bpm: Optional[float] = None,
    output: Union[str, io.BytesIO, None] = None,
) -> Optional[bytes]:
    """v2 encoder: named tracks, fixed-tempo tick math (120 BPM by default,
    matching the reference; ``bpm`` writes a set_tempo meta and keys the tick
    math to it — wall-clock times unchanged, musical grid aligned), plain
    note_on/note_off pairs (no pitchwheel)."""
    tempo_us = DEFAULT_TEMPO_US if bpm is None else _tempo_us(bpm)
    mid = MidiFile(ticks_per_beat=DEFAULT_TICKS_PER_BEAT)
    track_main, track_safe = MidiTrack(), MidiTrack()
    mid.tracks.extend([track_main, track_safe])
    track_main.append(MidiMessage("track_name", name="Aegis Financial - Main", time=0))
    track_safe.append(MidiMessage("track_name", name="Aegis Financial - Safe", time=0))
    if bpm is not None:
        track_main.append(MidiMessage("set_tempo", tempo=tempo_us, time=0))

    ms_per_tick = (tempo_us / 1000.0) / mid.ticks_per_beat
    ms_per_frame = (hop_length / sr) * 1000.0

    last = {"main": 0, "safe": 0}
    for evt in events:
        tr = evt["track"]
        track = track_main if tr == "main" else track_safe
        start_ticks = int(evt["start"] * ms_per_frame / ms_per_tick)
        duration_ticks = int((evt["end"] - evt["start"]) * ms_per_frame / ms_per_tick)
        track.append(
            MidiMessage(
                "note_on",
                note=int(evt["note"]),
                # velocity-0 events are legal (0 means note_off in SMF);
                # >127 would wrap through smf.py's & 0x7F mask
                velocity=min(127, max(1, int(evt["velocity"]))),
                time=max(0, start_ticks - last[tr]),
            )
        )
        track.append(
            MidiMessage("note_off", note=int(evt["note"]), velocity=0,
                        time=duration_ticks)
        )
        last[tr] = start_ticks + duration_ticks

    return mid.save(output)
