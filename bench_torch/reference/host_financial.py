"""The host half of the financial reference: note events and the
dual-track MIDI encoder.

A frozen copy, code unchanged but for the C++ fast path of the RSI (its
NumPy loop is kept), the harmonic analyzer's vectorized lookups (their
sequential specs are kept) and the options the folder never sets, of the
port's financial extractor
(``core/events.py::extract_events_financial``, ``filter_ghost_notes_rsi``,
``apply_harmonic_context``), ``harmony/key.py::HarmonicAnalyzer``, the
adaptive threshold of ``ref/trend_ref.py`` and the two-track writer
``midi/encode.py::events_to_midi_financial``, at the commit the financial
cell was defined on.  The parts the v1 chain shares (segmentation, event
build, sustain merge, onset refinement, the dB helpers, the Standard MIDI
File) are ``host_v1``'s.  Deliberate departures of the port from upstream
``midi_logic_financial.py:117-386`` are kept, as the port documents them:
the RSI ghost filter bins note times in seconds, notes quantize from the
median-smoothed pYIN f0 (``pitch_source="pyin"``), onsets refine the
event edges.
"""

from __future__ import annotations

import io
from collections import Counter
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy.signal import medfilt

from bench_torch.reference import host_v1

ARTIC_NAMES = {0: None, 1: "normal", 2: "bend", 3: "vibrato", 4: "noise"}
SLIDE_NAMES = {0: None, 1: "slide_up", 2: "slide_down", 3: "normal"}
_TECHNIQUE_CODES = {2: "bend", 3: "vibrato"}


def adaptive_confidence_threshold(conf: np.ndarray) -> float:
    """Data-driven confidence threshold, Bollinger-style
    (midi_logic_financial.py:78-114)."""
    valid = conf[conf > 0]
    if len(valid) == 0:
        return 0.5
    thr = float(np.mean(valid) - np.std(valid))
    return float(np.clip(thr, 0.3, 0.8))


def rsi(data: np.ndarray, period: int = 14) -> np.ndarray:
    """Wilder-smoothed RSI, default 50 (financial_analysis.py:274-320)."""
    deltas = np.diff(data)
    gains = np.where(deltas > 0, deltas, 0.0)
    losses = np.where(deltas < 0, -deltas, 0.0)
    n = len(data)
    avg_g = np.full(n, np.nan)
    avg_l = np.full(n, np.nan)
    if len(gains) >= period:
        avg_g[period] = np.mean(gains[:period])
        avg_l[period] = np.mean(losses[:period])
        for i in range(period + 1, n):
            avg_g[i] = (avg_g[i - 1] * (period - 1) + gains[i - 1]) / period
            avg_l[i] = (avg_l[i - 1] * (period - 1) + losses[i - 1]) / period
    out = np.full(n, 50.0)
    for i in range(period, n):
        if avg_l[i] == 0:
            out[i] = 100.0
        else:
            out[i] = 100.0 - 100.0 / (1.0 + avg_g[i] / avg_l[i])
    return out


def filter_ghost_notes_rsi(
    events: List[dict], sr: int, hop_length: int, rsi_threshold: float = 70.0
) -> List[dict]:
    """RSI over 100 ms note-density bins removes notes in overdense regions
    (reference financial_analysis.py:322-362, with time in real seconds)."""
    if not events:
        return events
    spf = hop_length / sr
    max_time = max(e["end"] * spf for e in events)
    n_bins = max(int(max_time * 10), 1)
    density = np.zeros(n_bins)
    for e in events:
        s = int(e["start"] * spf * 10)
        t = int(e["end"] * spf * 10)
        if s < n_bins:
            density[s : min(max(t, s + 1), n_bins)] += 1
    rsi_values = rsi(density, period=14)
    out = []
    for e in events:
        idx = int(e["start"] * spf * 10)
        if idx >= len(rsi_values) or rsi_values[idx] < rsi_threshold:
            out.append(e)
    return out


# ------------------------------------------------------ harmonic analysis

CHROMATIC = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
_MODE_TABLE = {
    "major": (0, 2, 4, 5, 7, 9, 11),
    "minor": (0, 2, 3, 5, 7, 8, 10),
    "blues": (0, 3, 5, 6, 7, 10),
    "penta_minor": (0, 3, 5, 7, 10),
}


class HarmonicAnalyzer:
    """Key detection and music-theory filtering
    (aegis_engine_core_v2/harmonic_analysis.py), the sequential specs."""

    def detect_key(self, midi_notes: np.ndarray) -> Dict:
        midi_notes = np.asarray(midi_notes)
        if len(midi_notes) == 0:
            return {"key": "C", "mode": "major", "confidence": 0.0}
        histogram = np.zeros(12)
        np.add.at(histogram, midi_notes.astype(int) % 12,
                  np.ones(len(midi_notes)))
        histogram = histogram / (histogram.sum() + 1e-6)
        best = ("C", "major", 0.0)
        for root in range(12):
            for mode in ("major", "minor", "blues"):
                score = sum(
                    histogram[(root + iv) % 12] for iv in _MODE_TABLE[mode]
                )
                if score > best[2]:
                    best = (CHROMATIC[root], mode, score)
        return {"key": best[0], "mode": best[1], "confidence": float(best[2])}

    def get_scale_notes(self, key: str, mode: str) -> List[int]:
        root = CHROMATIC.index(key)
        intervals = _MODE_TABLE.get(mode, _MODE_TABLE["major"])
        return [(root + iv) % 12 for iv in intervals]

    def filter_out_of_scale_notes(self, midi_notes: np.ndarray,
                                  confidences: np.ndarray, key_info: Dict,
                                  tolerance: int = 1):
        midi_notes = np.asarray(midi_notes)
        confidences = np.asarray(confidences)
        scale = np.array(self.get_scale_notes(key_info["key"],
                                              key_info["mode"]))
        pcs = midi_notes.astype(int) % 12
        d = np.abs(pcs[:, None] - scale[None, :])
        dist = np.minimum(d, 12 - d).min(axis=1)
        out_of_scale = dist > tolerance
        return (midi_notes[~out_of_scale], confidences[~out_of_scale],
                out_of_scale)

    def analyze_chord_progression(self, midi_notes: np.ndarray,
                                  times: np.ndarray,
                                  window_size: float = 2000.0) -> List[Dict]:
        midi_notes = np.asarray(midi_notes)
        times = np.asarray(times)
        if len(midi_notes) == 0:
            return []
        chords = []
        for t in range(0, int(np.max(times)) + 1, int(window_size)):
            mask = (times >= t) & (times < t + window_size)
            window_notes = midi_notes[mask]
            if len(window_notes) == 0:
                continue
            pcs = [int(n) % 12 for n in window_notes]
            root = Counter(pcs).most_common(1)[0][0]
            if (root + 4) % 12 in pcs:
                quality = "major"
            elif (root + 3) % 12 in pcs:
                quality = "minor"
            else:
                quality = "unknown"
            chords.append({"time": t, "chord": CHROMATIC[root],
                           "quality": quality})
        return chords

    def adaptive_filter_by_context(self, midi_notes: np.ndarray,
                                   times: np.ndarray,
                                   confidences: np.ndarray, key_info: Dict,
                                   window_size: float = 2000.0) -> np.ndarray:
        """Confidence penalties for non-chord tones: x0.8 if still in scale,
        x0.5 if fully out of scale."""
        chords = self.analyze_chord_progression(midi_notes, times,
                                                window_size)
        adjusted = np.asarray(confidences, dtype=np.float64).copy()
        if not chords:
            return adjusted
        scale_notes = set(self.get_scale_notes(key_info["key"],
                                               key_info["mode"]))
        by_start = {c["time"]: c for c in chords}
        for i, (note, time) in enumerate(zip(midi_notes, times)):
            current = (by_start.get(int(time // window_size)
                                    * int(window_size))
                       if time >= 0 else None)
            if current is None or current["quality"] == "unknown":
                continue
            root = CHROMATIC.index(current["chord"])
            third = 4 if current["quality"] == "major" else 3
            chord_tones = {root, (root + third) % 12, (root + 7) % 12}
            pc = int(note) % 12
            if pc not in chord_tones:
                adjusted[i] *= 0.8 if pc in scale_notes else 0.5
        return adjusted


def apply_harmonic_context(
    events: List[dict], sr: int, hop_length: int,
    confidence_threshold: float, harmonic_tolerance: int = 1,
) -> Tuple[List[dict], Optional[dict]]:
    """Key detection over the event list, the out-of-scale mask, the
    chord-context confidence adjustment and the threshold track split."""
    analyzer = HarmonicAnalyzer()
    midi_notes = np.array([e["note"] for e in events])
    confidences = np.array([e["confidence"] for e in events])
    key_info = analyzer.detect_key(midi_notes)
    _, _, out_of_scale = analyzer.filter_out_of_scale_notes(
        midi_notes, confidences, key_info, tolerance=harmonic_tolerance
    )
    kept = [e for e, bad in zip(events, out_of_scale) if not bad]
    for e in kept:
        e["harmonic_valid"] = True
    if kept:
        adjusted = analyzer.adaptive_filter_by_context(
            np.array([e["note"] for e in kept]),
            np.array([e["start"] * (hop_length / sr) * 1000.0 for e in kept]),
            np.array([e["confidence"] for e in kept]),
            key_info,
        )
        for e, c in zip(kept, adjusted):
            e["confidence"] = float(c)
            e["track"] = "main" if c >= confidence_threshold else "safe"
    return kept, key_info


# ------------------------------------------------------------ the events

def extract_events_financial(
    rake_mask: np.ndarray,
    f0: np.ndarray,  # NaN on unvoiced
    voiced_flag: np.ndarray,
    active_probs: np.ndarray,
    rms: np.ndarray,
    sr: int,
    hop_length: int,
    *,
    trend: np.ndarray,
    artic_codes: np.ndarray,
    slide_codes: np.ndarray,
    financial_confidence: np.ndarray,
    confidence_threshold: Optional[float] = None,
    noise_gate_db: float = -40.0,
    sustain_ms: float = 50.0,
    min_note_duration_ms: float = 50.0,
    use_harmonic_filter: bool = True,
    harmonic_tolerance: int = 1,
    rsi_threshold: float = 70.0,
    onset_env: Optional[np.ndarray] = None,
    onset_snap_ms: float = 140.0,
    onset_fwd_snap_ms: float = 0.0,
    pitch_source: str = "pyin",
) -> Tuple[List[dict], dict]:
    """v2 event extraction from the financial rows: (events, {threshold,
    key_info})."""
    T = min(len(rake_mask), len(f0), len(rms), len(voiced_flag),
            len(active_probs))
    arrays = [rake_mask, f0, voiced_flag, active_probs, rms, trend,
              artic_codes, slide_codes, financial_confidence]
    (rake_mask, f0, voiced_flag, active_probs, rms, trend, artic_codes,
     slide_codes, financial_confidence) = (a[:T] for a in arrays)

    rms_db = host_v1.amplitude_to_db(rms)
    combined_conf = active_probs * 0.5 + financial_confidence * 0.5
    if confidence_threshold is None:
        confidence_threshold = adaptive_confidence_threshold(combined_conf)

    min_frames = int((min_note_duration_ms / 1000.0) * sr / hop_length)
    sustain_frames = int((sustain_ms / 1000.0) * sr / hop_length)

    if pitch_source == "pyin":
        freq = np.asarray(
            medfilt(np.nan_to_num(f0), kernel_size=3) if T >= 3
            else np.nan_to_num(f0), dtype=np.float64)
    else:
        freq = np.asarray(trend, dtype=np.float64)
    finite = np.isfinite(freq)
    active = (
        voiced_flag.astype(bool)
        & finite
        & (np.nan_to_num(freq) > 0)
        & (rms_db >= noise_gate_db)
        & ~rake_mask.astype(bool)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        notes = np.where(active, np.round(host_v1.hz_to_midi(
            np.where(finite, freq, 1.0))), -1)
    velocity = host_v1.velocity_from_db(rms_db)

    starts, ends = host_v1._segment(active, notes)
    events = host_v1._build_events(starts, ends, notes, combined_conf,
                                   velocity, rms_db, confidence_threshold)

    # per-segment articulation: last non-normal code; else first-frame code
    codes = np.asarray(artic_codes)
    for evt, s, e in zip(events, starts, ends):
        seg = codes[s : e + 1]
        special = np.where((seg >= 2) & (seg <= 4))[0]
        code = int(seg[special[-1]]) if len(special) else int(seg[0])
        evt["financial_artic"] = ARTIC_NAMES.get(code)
        evt["financial_slide"] = SLIDE_NAMES.get(int(slide_codes[s]))
        evt["technique"] = _TECHNIQUE_CODES.get(code)

    events = [e for e in events if (e["end"] - e["start"]) >= min_frames]
    events = host_v1._sustain_merge(events, sustain_frames)

    if onset_env is not None:
        events = host_v1.apply_onset_refinement(
            events, onset_env[:T], velocity, rms_db, sr, hop_length,
            min_frames, onset_snap_ms, snap_fwd_ms=onset_fwd_snap_ms)

    if len(events) > 10:
        events = filter_ghost_notes_rsi(events, sr, hop_length, rsi_threshold)

    key_info = None
    if use_harmonic_filter and len(events) > 5:
        events, key_info = apply_harmonic_context(
            events, sr, hop_length, confidence_threshold, harmonic_tolerance)

    return events, {"threshold": float(confidence_threshold),
                    "key_info": key_info}


# ------------------------------------------------------------- the MIDI

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
    math to it), plain note_on/note_off pairs (no pitchwheel)."""
    tempo_us = (host_v1.DEFAULT_TEMPO_US if bpm is None
                else host_v1._tempo_us(bpm))
    mid = host_v1.MidiFile(ticks_per_beat=host_v1.DEFAULT_TICKS_PER_BEAT)
    track_main, track_safe = host_v1.MidiTrack(), host_v1.MidiTrack()
    mid.tracks.extend([track_main, track_safe])
    track_main.append(host_v1.MidiMessage(
        "track_name", name="Aegis Financial - Main", time=0))
    track_safe.append(host_v1.MidiMessage(
        "track_name", name="Aegis Financial - Safe", time=0))
    if bpm is not None:
        track_main.append(host_v1.MidiMessage("set_tempo", tempo=tempo_us,
                                              time=0))

    ms_per_tick = (tempo_us / 1000.0) / mid.ticks_per_beat
    ms_per_frame = (hop_length / sr) * 1000.0

    last = {"main": 0, "safe": 0}
    for evt in events:
        tr = evt["track"]
        track = track_main if tr == "main" else track_safe
        start_ticks = int(evt["start"] * ms_per_frame / ms_per_tick)
        duration_ticks = int((evt["end"] - evt["start"]) * ms_per_frame
                             / ms_per_tick)
        track.append(
            host_v1.MidiMessage(
                "note_on",
                note=int(evt["note"]),
                velocity=min(127, max(1, int(evt["velocity"]))),
                time=max(0, start_ticks - last[tr]),
            )
        )
        track.append(
            host_v1.MidiMessage("note_off", note=int(evt["note"]),
                                velocity=0, time=duration_ticks)
        )
        last[tr] = start_ticks + duration_ticks

    return mid.save(output)
