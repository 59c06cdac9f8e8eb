"""CLI of the PyTorch port: ``python -m aegis_tpu_torch transcribe in.wav out.mid``

  transcribe  WAV/MP3 -> MIDI via the v1 engine (two-phase), with the
              arguments of ``python -m aegis_tpu transcribe`` plus
              ``--device`` (cuda by default; cpu runs the plain versions)
"""

from __future__ import annotations

import argparse
import os
import sys


def _extract_kwargs(args) -> dict:
    kw = {}
    if args.no_onsets:
        kw["use_onsets"] = False
    if args.confidence is not None:
        kw["confidence_threshold"] = args.confidence
    if args.min_duration_ms is not None:
        kw["min_note_duration_ms"] = args.min_duration_ms
    if args.sustain_ms is not None:
        kw["sustain_ms"] = args.sustain_ms
    if args.bpm is not None:
        from aegis_tpu.core.tempo import parse_bpm

        try:
            kw["bpm"] = parse_bpm(args.bpm)
        except ValueError:
            print(f"error: --bpm must be a positive number or 'auto', "
                  f"got {args.bpm!r}", file=sys.stderr)
            raise SystemExit(2)
    return kw


def cmd_transcribe(args) -> int:
    from aegis_tpu_torch.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=args.sr, device=args.device)
    raw = eng.audio_to_midi(args.input, None, start_time=args.start,
                            end_time=args.end, turbo_mode=args.turbo,
                            rake_sensitivity=args.rake,
                            pitch_backend=args.pitch_backend)
    if raw is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    out = args.output or os.path.splitext(args.input)[0] + ".mid"
    events = eng.extract_events(raw, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aegis_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("transcribe")
    p.add_argument("input", help="input audio file (wav/mp3/...)")
    p.add_argument("output", nargs="?", default=None,
                   help="output .mid path (default: input stem + .mid)")
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=None)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--min-duration-ms", type=float, default=None)
    p.add_argument("--sustain-ms", type=float, default=None)
    p.add_argument("--bpm", default=None,
                   help="a number, or 'auto' to estimate the tempo")
    p.add_argument("--turbo", default="auto",
                   choices=["off", "tiles", "stream", "auto"],
                   help="only the fused program is ported: 'auto' runs it "
                        "up to 240 s, 'tiles' and 'stream' raise")
    p.add_argument("--no-onsets", action="store_true",
                   help="disable onset-envelope event refinement "
                        "(re-attack splitting + attack-time snap); "
                        "matches the reference's merge/lag semantics")
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--rake", type=float, default=0.6)
    p.add_argument("--pitch-backend", default="pyin",
                   choices=["pyin", "neural"],
                   help="only pyin is ported; neural raises")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_transcribe)

    args = ap.parse_args(argv)
    if args.end is not None and args.end <= args.start:
        ap.error(f"--end ({args.end}) must be greater than --start "
                 f"({args.start})")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
