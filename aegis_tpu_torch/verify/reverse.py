"""Reverse analysis: MIDI -> synth audio -> re-transcribe -> compare; a
copy of ``aegis_tpu/verify/reverse.py`` on the port's synth and engine.

The framework's closed-loop accuracy oracle (reference
reverse_analyzer.py:143-247): greedy nearest-note matching with distance
|Δpitch|/12 + |Δt|, a match iff <= 1 semitone and <= 0.1 s, reported as
note/pitch/timing accuracy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from aegis_tpu_torch.io.audio import to_mono
from aegis_tpu_torch.io.wav import read_wav
from aegis_tpu_torch.midi.decode import midi_to_notes
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("ReverseAnalyzer")


def compare_note_lists(original: List[dict], reversed_notes: List[dict],
                       time_tolerance: float = 0.1,
                       pitch_tolerance: float = 1.0) -> Dict[str, float]:
    """Greedy nearest matching (estimates may be reused, matching the
    reference's accounting); pitch accuracy = 1 - avg_err/12 (octave scale),
    timing accuracy = 1 - avg_err/0.5.

    Error averages run over ALL greedy pairs (every original's nearest
    estimate, matched or not — reference reverse_analyzer.py:114-134), so a
    dropped note degrades pitch/timing accuracy instead of the scores
    saturating inside the match-tolerance band.  Each pair's contribution is
    CAPPED at the score scale (12 semitones / 0.5 s): in the raw reference
    accounting one dropped note's arbitrarily distant nearest neighbor could
    drag timing_accuracy to ~0 on an otherwise perfect clip (observed in
    round 1: 3-note clip, 2 re-transcribed -> 'timing 10%'); with the cap it
    costs exactly its 1/N share.  ``pitch_error_semitones`` and
    ``timing_error_ms`` report raw means over matched pairs only, for
    fine-grained alignment quality on the notes that did match."""
    if not original or not reversed_notes:
        return {"note_accuracy": 0.0, "pitch_accuracy": 0.0,
                "timing_accuracy": 0.0,
                "pitch_error_semitones": float("nan"),
                "timing_error_ms": float("nan")}
    matched = 0
    pitch_errors, timing_errors = [], []
    m_pitch, m_timing = [], []
    for orig in original:
        best, best_d = None, float("inf")
        for rev in reversed_notes:
            d = abs(orig["note"] - rev["note"]) / 12.0 + abs(
                orig["start"] - rev["start"]
            )
            if d < best_d:
                best_d, best = d, rev
        pitch_diff = abs(orig["note"] - best["note"])
        time_diff = abs(orig["start"] - best["start"])
        pitch_errors.append(min(pitch_diff, 12.0))
        timing_errors.append(min(time_diff, 0.5))
        if pitch_diff <= pitch_tolerance and time_diff <= time_tolerance:
            matched += 1
            m_pitch.append(pitch_diff)
            m_timing.append(time_diff)

    return {
        "note_accuracy": matched / len(original),
        "pitch_accuracy": max(0.0, 1.0 - float(np.mean(pitch_errors)) / 12.0),
        "timing_accuracy": max(0.0, 1.0 - float(np.mean(timing_errors)) / 0.5),
        "pitch_error_semitones": float(np.mean(m_pitch)) if m_pitch else float("nan"),
        "timing_error_ms": float(np.mean(m_timing)) * 1000.0 if m_timing else float("nan"),
    }


def reverse_analysis(midi_data: bytes, engine, sample_rate: int = 44100,
                     confidence_threshold: float = 0.3) -> Optional[Dict]:
    """Full round trip on ``engine.device``.  Returns metrics + the
    re-transcribed MIDI/events."""
    import io

    original_notes = midi_to_notes(midi_data)
    log.info(f"1/4 original notes: {len(original_notes)}")
    if not original_notes:
        return None

    wav_data = synthesize_midi(midi_data, sample_rate=sample_rate,
                               device=engine.device)
    if wav_data is None:
        log.warning("synthesis failed")
        return None
    log.info("2/4 synthesized")

    audio, sr = read_wav(wav_data)
    audio = to_mono(audio)
    if sr != engine.sr:
        from aegis_tpu_torch.io.audio import resample

        audio = resample(audio, sr, engine.sr)

    raw = engine.audio_to_midi(audio, None)
    if raw is None:
        return None
    buf = io.BytesIO()
    events = engine.extract_events(raw, buf,
                                   confidence_threshold=confidence_threshold)
    log.info(f"3/4 re-transcribed: {len(events)} events")

    spf = engine.hop_length / engine.sr
    reversed_notes = [
        {"note": e["note"], "start": e["start"] * spf, "end": e["end"] * spf}
        for e in events
    ]
    metrics = compare_note_lists(original_notes, reversed_notes)
    log.info(
        f"4/4 note {metrics['note_accuracy']:.1%} / pitch "
        f"{metrics['pitch_accuracy']:.1%} / timing {metrics['timing_accuracy']:.1%}"
    )
    return {
        "original_notes": len(original_notes),
        "reversed_notes": len(reversed_notes),
        **metrics,
        "reversed_midi": buf.getvalue(),
        "reversed_events": events,
    }
