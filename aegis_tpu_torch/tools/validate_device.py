"""On-device correctness validation: the port on the card vs the CPU oracle
(the counterpart of ``aegis_tpu/tools/validate_device.py``).

Runs both engines (v1 + financial) on ``device`` and the float64 NumPy
oracle (``ref/pipeline_ref.py``) on the gating clips and reports
note-event F1 (the correctness metric: F1 >= 0.99 against the CPU
librosa-semantics reference, BASELINE.md).  The port's engines have no
oracle backend, so the tool runs ``run_analyze_ref`` itself, builds the
raw dict from its rows as the JAX facade does for its ``backend="ref"``
engine, and extracts events with the port's own extractors.

Gating clips (each must clear the threshold; the process exits nonzero
otherwise):
  * synthetic_track @ 22050   (E2/A2/D3 Karplus-Strong + rakes)
  * scale_track     @ 22050   (C-major scale + rake + hiss)
  * synthetic_track @ 44100   (the reference v1 engine's default rate)
  * bench_track_60s @ 22050   (the 60 s bench track; --quick skips it: its
                               CPU oracle takes minutes)
  * chord progressions of seeds 1 / 3 / 7 @ 22050 and 7 / 8 / 10 @ 44100
    through AegisPolyEngine, against the generator's truth

Non-gating extra fields: ``neural_f1`` (pitch_backend="neural" agreement
with the pyin oracle) and, on clips whose generator supplies ground truth,
``pyin_truth_f1`` / ``fin_truth_f1`` / ``neural_truth_f1`` (each backend
vs the actual notes).

Usage:  python -m aegis_tpu_torch.tools.validate_device [--quick]
        [--device cpu]   (or ``python -m aegis_tpu_torch validate``)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _oracle_raw(y: np.ndarray, eng, financial: bool) -> dict:
    """The oracle's rows for ``eng``'s configuration as the engine's
    extractors read them: v1 as the JAX facade's ``audio_to_midi`` builds
    its raw dict (``aegis_tpu/engine/engine.py:199-217``), financial as its
    ``analyze`` returns the rows."""
    from aegis_tpu_torch.ref.pipeline_ref import run_analyze_ref

    y = np.asarray(y, np.float32)
    out = run_analyze_ref(y, eng.audio, eng.pyin_cfg, 0.6,
                          financial=financial)
    if financial:
        return {**out, "y": y, "pitch_backend": "pyin"}
    return {
        "rake_mask": np.asarray(out["rake_mask"]),
        "f0": np.nan_to_num(np.asarray(out["f0"], dtype=np.float64)),
        "voiced_flag": np.asarray(out["voiced_flag"]),
        "voiced_probs": np.asarray(out["voiced_probs"], dtype=np.float64),
        "rms": np.asarray(out["rms"], dtype=np.float64),
        "y": y,
        "onset_env": np.asarray(out["onset_env"], dtype=np.float64),
        "mel_db": np.asarray(out["mel_db"]),
        "pitch_backend": "pyin",
    }


def validate(threshold: float = 0.99, include_bench: bool = True,
             quiet: bool = False, device="cuda") -> dict:
    from aegis_tpu_torch import resolve_device
    from aegis_tpu_torch.engine.engine import AegisEngine
    from aegis_tpu_torch.engine.financial import AegisFinancialEngine
    from aegis_tpu_torch.engine.poly import AegisPolyEngine
    from aegis_tpu_torch.models.pitchnet import have_default_weights
    from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                                  generate_chord_progression,
                                                  generate_scale_benchmark,
                                                  generate_test_track)
    from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

    device = resolve_device(device)
    # (name, sr, audio, truth): truth is the generator's ground-truth note
    # list in seconds where one exists
    kst_22k = generate_test_track(sr=22050)
    kst_44k = generate_test_track(sr=44100)
    scale = generate_scale_benchmark(sr=22050)
    clips = [
        ("synthetic_track", 22050, kst_22k[0], kst_22k[1]),
        ("scale_track", 22050, scale[0], scale[2]),
        ("synthetic_track_44k", 44100, kst_44k[0], kst_44k[1]),
    ]
    if include_bench:
        bench_y, bench_truth = generate_bench_track(60.0, return_truth=True)
        clips.append(("bench_track_60s", 22050, bench_y, bench_truth))
    hop = 512

    def f1(est_events, ref_events, sr):
        # seconds-based events, default tolerances (50ms onset, 0.5 semitone)
        return note_event_f1(events_to_seconds(ref_events, sr, hop),
                             events_to_seconds(est_events, sr, hop))["f1"]

    results = {}
    ok = True
    for name, sr, y, truth in clips:
        dev = AegisEngine(sample_rate=sr, device=device)
        ed = dev.extract_events(dev.audio_to_midi(y, None), None,
                                confidence_threshold=0.3)
        er = dev.extract_events(_oracle_raw(y, dev, False), None,
                                confidence_threshold=0.3)
        f1_v1 = f1(ed, er, sr)

        devf = AegisFinancialEngine(sample_rate=sr, device=device)
        edf, _ = devf.extract_events(devf.analyze(y, fetch_mel=False))
        erf, _ = devf.extract_events(_oracle_raw(y, devf, True))
        f1_fin = f1(edf, erf, sr)

        results[name] = {"v1_f1": round(f1_v1, 4),
                         "financial_f1": round(f1_fin, 4)}
        ok = ok and f1_v1 >= threshold and f1_fin >= threshold

        # informative (NON-gating): the learned backend vs the same oracle
        en = None
        if have_default_weights():
            en = dev.extract_events(
                dev.audio_to_midi(y, None, pitch_backend="neural"), None,
                confidence_threshold=0.3)
            results[name]["neural_f1"] = round(f1(en, er, sr), 4)

        # informative (NON-gating): each backend vs the generator's ground
        # truth where the clip has one; agreement with pyin punishes the
        # neural backend where pyin itself is wrong
        if truth is not None:
            results[name]["pyin_truth_f1"] = round(
                note_event_f1(truth, events_to_seconds(ed, sr, hop))["f1"], 4)
            results[name]["fin_truth_f1"] = round(
                note_event_f1(truth, events_to_seconds(edf, sr, hop))["f1"],
                4)
            if en is not None:
                results[name]["neural_truth_f1"] = round(
                    note_event_f1(truth,
                                  events_to_seconds(en, sr, hop))["f1"], 4)

        if not quiet:
            nf = results[name].get("neural_f1", float("nan"))
            extra = ""
            if "pyin_truth_f1" in results[name]:
                extra = (f" truth: pyin={results[name]['pyin_truth_f1']:.4f}"
                         f" fin={results[name]['fin_truth_f1']:.4f}"
                         f" neural="
                         f"{results[name].get('neural_truth_f1', float('nan')):.4f}")
            print(f"# {name}@{sr}: v1={f1_v1:.4f} fin={f1_fin:.4f} "
                  f"neural={nf:.4f}{extra}", file=sys.stderr)

    # polyphonic engine vs generator ground truth (GATING: the poly
    # pipeline has no librosa analogue, so chord-progression truth is its
    # correctness contract); at 44.1 kHz the seeds the JAX tool gates
    for sr_p, seeds in ((22050, (1, 3, 7)), (44100, (7, 8, 10))):
        poly_eng = AegisPolyEngine(sample_rate=sr_p, device=device)
        for seed in seeds:
            y, truth = generate_chord_progression(seed, sr=sr_p)
            events = poly_eng.extract_events(poly_eng.analyze(y))
            pf1 = note_event_f1(
                truth, events_to_seconds(events, sr_p,
                                         poly_eng.hop_length))["f1"]
            results[f"chord_progression_s{seed}_{sr_p}"] = {
                "poly_truth_f1": round(pf1, 4)}
            ok = ok and pf1 >= threshold
            if not quiet:
                print(f"# chord_progression_s{seed}@{sr_p}: "
                      f"poly_truth={pf1:.4f}", file=sys.stderr)
    return {"pass": ok, "threshold": threshold, "clips": results}


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The tool's flags; also the ``validate`` command's."""
    ap.add_argument("--quick", action="store_true",
                    help="skip the 60 s bench track (minutes of CPU oracle)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def run(args: argparse.Namespace) -> int:
    result = validate(include_bench=not args.quick, device=args.device)
    print(json.dumps(result))
    return 0 if result["pass"] else 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    sys.exit(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
