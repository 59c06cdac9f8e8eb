"""Realism sweep: truth F1 per engine vs string inharmonicity B (the
counterpart of ``aegis_tpu/tools/inharmonic_sweep.py``).

Real strings have stiffness-stretched partials (f_n = n·f0·√(1+B·n²),
B ≈ 1e-5 wound .. 1e-3 plain), body resonance and pick noise, which the
poly recovery chain and the comb templates do not model.  This sweep
measures how each engine's truth F1 degrades as B walks through the
physical range with the full realism model on (pick transient + body
modes; tools/signal_gen.py::pluck_inharmonic).

Clips per B:
  * mono 20 s pentatonic bench melody (seed 42) -> v1(pyin), financial,
    neural truth F1;
  * chord progressions seeds 1/3/7 -> poly truth F1 (mean + min).

Usage:  python -m aegis_tpu_torch.tools.inharmonic_sweep [--quick]
        [--device cpu]
Prints one JSON document on stdout; progress rows on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

B_VALUES = (0.0, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3)


def sweep(b_values=B_VALUES, mono_duration: float = 20.0,
          poly_seeds=(1, 3, 7), quiet: bool = False, device="cuda") -> dict:
    from aegis_tpu_torch import resolve_device
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.engine.financial import AegisFinancialEngine
    from aegis_tpu_torch.engine.poly import AegisPolyEngine
    from aegis_tpu_torch.models.pitchnet import have_default_weights
    from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                                  generate_chord_progression)
    from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

    device = resolve_device(device)
    sr, hop = 22050, 512
    v1 = AegisEngine(sample_rate=sr, device=device)
    fin = AegisFinancialEngine(sample_rate=sr, device=device)
    poly = AegisPolyEngine(sample_rate=sr, device=device)
    neural = have_default_weights()

    def tf1(truth, events, hop_used=hop):
        return round(note_event_f1(
            truth, events_to_seconds(events, sr, hop_used))["f1"], 4)

    rows = {}
    for B in b_values:
        y, truth = generate_bench_track(mono_duration, sr=sr, B=B,
                                        return_truth=True)
        row = {}
        row["v1"] = tf1(truth, v1.extract_events(
            v1.audio_to_midi(y, None), None, confidence_threshold=0.3))
        fa = fin.analyze(y, fetch_mel=False)
        row["financial"] = tf1(truth, fin.extract_events(fa)[0])
        if neural:
            row["neural"] = tf1(truth, v1.extract_events(
                v1.audio_to_midi(y, None, pitch_backend="neural"), None,
                confidence_threshold=0.3))
        pf1 = []
        for seed in poly_seeds:
            yc, tc = generate_chord_progression(seed, sr=sr, B=B)
            pf1.append(tf1(tc, poly.extract_events(poly.analyze(yc)),
                           poly.hop_length))
        row["poly_mean"] = round(sum(pf1) / len(pf1), 4)
        row["poly_min"] = min(pf1)
        rows[f"{B:g}"] = row
        if not quiet:
            print(f"# B={B:g}: {row}", file=sys.stderr)
    return {"sr": sr, "mono_duration_s": mono_duration,
            "poly_seeds": list(poly_seeds), "f1_by_B": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="B in (0, 1e-4) and a 10 s melody")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = sweep(b_values=(0.0, 1e-4) if args.quick else B_VALUES,
                mono_duration=10.0 if args.quick else 20.0,
                device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
