"""Transcription benchmark harness (the counterpart of
``aegis_tpu/tools/benchmark.py``).

Recreates the reference's benchmark scenario (benchmark_aegis.py:16-106):
C-major-scale ground truth with an injected rake burst and hiss, engine vs a
naive no-filter baseline.  Unlike the reference, which hardcodes the
competitor's numbers (:93-98, see SURVEY.md Appendix A), BOTH sides are
measured here, including note-event F1 against the known truth.

Run: python -m aegis_tpu_torch.tools.benchmark [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np

from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.tools.signal_gen import generate_scale_benchmark
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

SR = 22050


def naive_baseline_events(raw: Dict, sr: int, hop: int):
    """A 'standard DSP' competitor: every voiced frame becomes a note — no
    rake mask, no gate, no smoothing, no merging (what raw pyin output looks
    like as MIDI)."""
    from aegis_tpu_torch.ref.dsp_ref import hz_to_midi

    f0 = np.nan_to_num(raw["f0"])
    voiced = np.asarray(raw["voiced_flag"], bool) & (f0 > 0)
    notes = np.where(voiced, np.round(hz_to_midi(np.maximum(f0, 1e-6))), -1)
    events = []
    start = None
    for t in range(len(notes)):
        if voiced[t] and (start is None or notes[t] != notes[start]):
            if start is not None:
                events.append({"note": int(notes[start]), "start": start,
                               "end": t - 1, "velocity": 80})
            start = t
        elif not voiced[t] and start is not None:
            events.append({"note": int(notes[start]), "start": start,
                           "end": t - 1, "velocity": 80})
            start = None
    if start is not None:
        events.append({"note": int(notes[start]), "start": start,
                       "end": len(notes) - 1, "velocity": 80})
    return events


def run_benchmark(duration_per_note: float = 0.5, device="cuda") -> Dict:
    y, truth_midi, truth = generate_scale_benchmark(
        sr=SR, note_duration=duration_per_note)
    engine = AegisEngine(sample_rate=SR, device=device)

    t0 = time.time()
    raw = engine.audio_to_midi(y)
    analyze_time = time.time() - t0

    t0 = time.time()
    events = engine.extract_events(raw, None, confidence_threshold=0.5,
                                   sustain_ms=150, min_note_duration_ms=50)
    extract_time = time.time() - t0

    aegis = note_event_f1(truth, events_to_seconds(events, SR, 512),
                          onset_tolerance=0.1)
    naive = note_event_f1(
        truth, events_to_seconds(naive_baseline_events(raw, SR, 512), SR, 512),
        onset_tolerance=0.1,
    )
    audio_secs = len(y) / SR
    return {
        "audio_seconds": round(audio_secs, 2),
        "analyze_seconds": round(analyze_time, 3),
        "extract_seconds": round(extract_time, 4),
        "realtime_factor": round(audio_secs / max(analyze_time + extract_time,
                                                  1e-9), 1),
        "aegis": {"events": len(events), **{k: round(v, 3) for k, v in aegis.items()}},
        "naive_baseline": {**{k: round(v, 3) if isinstance(v, float) else v
                              for k, v in naive.items()}},
        "truth_notes": len(truth),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run_benchmark(device=args.device), indent=2))


if __name__ == "__main__":
    main()
