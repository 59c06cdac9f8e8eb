"""CLI of the PyTorch port: ``python -m aegis_tpu_torch <command> ...``

Each command takes the arguments and defaults of ``python -m aegis_tpu
<command>`` plus ``--device`` (cuda by default; cpu runs the plain
versions):

  transcribe  WAV/MP3 -> MIDI via the v1 engine (two-phase)
  financial   WAV/MP3 -> MIDI via the v2 financial engine (5-phase)
  poly        WAV/MP3 -> MIDI via the polyphonic CQT engine
  auto        WAV/MP3 -> MIDI via the polyphony-aware router (chords
              through the CQT peel, fast lines through pYIN)
  tabs        WAV/MP3 -> ASCII guitar tablature (--engine v1 | poly)
  batch       every matching file of a folder -> MIDI (v1, financial,
              poly, auto)
  stream      live: s16le PCM on stdin -> JSON event lines, MIDI at EOF
  stems       WAV/MP3 -> the guitar-ish stem (Demucs when on PATH, else
              HPSS on the device); prints its path, exits 2 when that is
              the input itself
  serve       the REST API + SPA server (serve/server.py) on --host /
              --port, its engines on --device
  train       the PitchNet trainer (models/train.py): --steps --batch
              --clips --clip-len --seed --out; --out defaults to the
              packaged checkpoint, so name one to keep it
  validate    the F1 gate of the card against the CPU oracle
              (tools/validate_device.py): --quick; exit 1 on a failure
  warmup      pay the first call's builds and set-up at install time: one
              run of each --pipelines entry per --seconds duration on
              silence; run it once after install, before serve
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
        from aegis_tpu_torch.core.tempo import parse_bpm

        try:
            kw["bpm"] = parse_bpm(args.bpm)
        except ValueError:
            print(f"error: --bpm must be a positive number or 'auto', "
                  f"got {args.bpm!r}", file=sys.stderr)
            raise SystemExit(2)
    return kw


def _out_path(args) -> str:
    return args.output or os.path.splitext(args.input)[0] + ".mid"


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
    out = _out_path(args)
    events = eng.extract_events(raw, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_financial(args) -> int:
    from aegis_tpu_torch.engine.financial import AegisFinancialEngine

    eng = AegisFinancialEngine(sample_rate=args.sr, device=args.device)
    out = _out_path(args)
    result = eng.audio_to_midi_financial(
        args.input, out, start_time=args.start, end_time=args.end,
        rake_sensitivity=args.rake, turbo_mode=args.turbo,
        pitch_backend=args.pitch_backend, pitch_source=args.pitch_source,
        **_extract_kwargs(args))
    if result is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    print(f"-> {out}")
    return 0


def cmd_poly(args) -> int:
    from aegis_tpu_torch.engine.poly import AegisPolyEngine

    eng = AegisPolyEngine(sample_rate=args.sr, device=args.device)
    out = _out_path(args)
    analysis = eng.analyze(args.input, start_time=args.start,
                           end_time=args.end, turbo_mode=args.turbo)
    if analysis is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    events = eng.extract_events(analysis, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_auto(args) -> int:
    """Polyphony-aware routed transcription: chords through the CQT peel,
    fast monophonic lines through pYIN, merged on one frame grid
    (engine/auto.py)."""
    from aegis_tpu_torch.engine.auto import AegisAutoEngine

    eng = AegisAutoEngine(sample_rate=args.sr, device=args.device)
    out = _out_path(args)
    analysis = eng.analyze(args.input, start_time=args.start,
                           end_time=args.end)
    if analysis is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    events = eng.extract_events(analysis, out, **_extract_kwargs(args))
    print(f"{len(events)} events -> {out}")
    return 0


def cmd_tabs(args) -> int:
    from aegis_tpu_torch.midi.tabs import generate_tabs, render_ascii_tab

    if args.engine == "poly":
        if args.pitch_backend != "pyin":
            print("error: the polyphonic engine has no neural backend",
                  file=sys.stderr)
            return 2
        from aegis_tpu_torch.engine.poly import AegisPolyEngine

        peng = AegisPolyEngine(sample_rate=args.sr, device=args.device)
        analysis = peng.analyze(args.input, start_time=args.start,
                                end_time=args.end, turbo_mode=args.turbo)
        if analysis is None:
            print("error: empty audio", file=sys.stderr)
            return 1
        events = peng.extract_events(analysis, args.output,
                                     **_extract_kwargs(args))
        chords = peng.label_chords(events)
        if chords:
            print("  ".join(f"{c['time_sec']:.2f}s {c['name']}"
                            for c in chords))
            print()
        print(render_ascii_tab(peng.generate_tabs(events)))
        if args.output:
            print(f"# wrote {args.output}", file=sys.stderr)
        return 0

    from aegis_tpu_torch.engine.engine import AegisEngine

    eng = AegisEngine(sample_rate=args.sr, device=args.device)
    raw = eng.audio_to_midi(args.input, None, start_time=args.start,
                            end_time=args.end, turbo_mode=args.turbo,
                            rake_sensitivity=args.rake,
                            pitch_backend=args.pitch_backend)
    if raw is None:
        print("error: empty audio", file=sys.stderr)
        return 1
    # the optional positional writes the MIDI alongside the ASCII tab
    # (extract_events encodes when given an output target)
    events = eng.extract_events(raw, args.output, **_extract_kwargs(args))
    print(render_ascii_tab(generate_tabs(events)))
    if args.output:
        print(f"# wrote {args.output}", file=sys.stderr)
    return 0


def cmd_batch(args) -> int:
    """Folder sweep: every track dispatched to the device before any fetch."""
    from aegis_tpu_torch.engine.folder import transcribe_folder

    kw = {}
    if args.confidence is not None:
        kw["confidence_threshold"] = args.confidence
    if args.no_onsets:
        kw["use_onsets"] = False
    results = transcribe_folder(args.folder, args.output_dir,
                                pattern=args.pattern, sample_rate=args.sr,
                                pitch_backend=args.pitch_backend,
                                engine=args.engine, transport=args.transport,
                                device=args.device, **kw)
    if not results:
        print("no matching audio files", file=sys.stderr)
        return 1
    for wav, mid, n in results:
        print(f"{wav} -> {mid} ({n} events)")
    return 0


def cmd_stream(args) -> int:
    """Live transcription from a PCM pipe.

    Reads signed 16-bit little-endian mono PCM from stdin (what
    ``ffmpeg -f s16le -ac 1`` or ``sox -t raw -e signed -b 16`` emit, or a
    microphone bridge), prints a JSON line of the live event list every
    ``--poll-every`` seconds of audio, and on EOF finalizes — writing MIDI
    when an output path is given.  Engines: v1, financial
    (engine.realtime.StreamingTranscriber) and poly
    (engine.realtime.StreamingPolyTranscriber).

        ffmpeg -i in.wav -f s16le -ac 1 -ar 22050 - | \
            python -m aegis_tpu_torch stream --engine financial out.mid
    """
    import json

    import numpy as np

    from aegis_tpu_torch.config import AudioConfig
    from aegis_tpu_torch.engine.realtime import (StreamingPolyTranscriber,
                                                 StreamingTranscriber)

    lat = {}
    if args.tile_frames:
        lat["tile_frames"] = args.tile_frames
    if args.halo_frames:
        lat["halo_frames"] = args.halo_frames
    kw = {}
    if args.confidence is not None:
        kw["confidence_threshold"] = args.confidence
    elif args.engine == "v1":
        kw["confidence_threshold"] = 0.5
    if args.engine == "poly":
        rt = StreamingPolyTranscriber(sample_rate=args.sr,
                                      device=args.device, **kw, **lat)
    else:
        rt = StreamingTranscriber(audio=AudioConfig(sample_rate=args.sr),
                                  financial=(args.engine == "financial"),
                                  device=args.device, **kw, **lat)
    print(f"# engine={args.engine} sr={args.sr} "
          f"lookahead={rt.lookahead_s:.2f}s", file=sys.stderr)

    # hop differs by engine/sr (poly scales its window with sr)
    hop = rt.hop if args.engine == "poly" else rt.audio.hop_length
    spf = hop / float(args.sr)  # seconds per frame

    def _jsonable(events, live):
        return json.dumps({
            "live": live, "n": len(events),
            "events": [{
                "note": int(e["note"]),
                "start": int(e["start"]), "end": int(e["end"]),
                "start_s": round(e["start"] * spf, 4),
                "end_s": round(e["end"] * spf, 4),
                "confidence": round(float(e.get("confidence", 0.0)), 4),
                "velocity": int(e.get("velocity", 0)),
                "track": e.get("track", "main"),
            } for e in events]})

    poll_samples = max(int(args.poll_every * args.sr), 1)
    src = sys.stdin.buffer
    fed_since_poll = 0
    carry = b""  # odd trailing byte of a short read belongs to the NEXT
    # sample — dropping it would byte-shift (byte-swap) the whole rest of
    # the s16le stream
    while True:
        data = src.read(8192)
        if not data:
            break
        data = carry + data
        cut = len(data) // 2 * 2
        carry = data[cut:]
        pcm = np.frombuffer(data[:cut],
                            dtype="<i2").astype(np.float32) / 32768.0
        rt.feed(pcm)
        fed_since_poll += len(pcm)
        if fed_since_poll >= poll_samples:
            fed_since_poll = 0
            print(_jsonable(rt.poll_events(), live=True), flush=True)
    events = rt.finalize()
    if not events:
        print("# no events detected", file=sys.stderr)
    if args.output:
        # engine-matched encoders, same defaults as the offline facades:
        # poly program 25, v1 program 27, financial named-track layout
        if args.engine == "financial":
            from aegis_tpu_torch.midi.encode import events_to_midi_financial

            events_to_midi_financial(events, args.sr, hop,
                                     output=args.output)
        else:
            from aegis_tpu_torch.midi.encode import events_to_midi

            program = (args.midi_program if args.midi_program is not None
                       else 25 if args.engine == "poly" else 27)
            events_to_midi(events, args.sr, hop,
                           midi_program=program, output=args.output)
        print(f"# wrote {args.output}", file=sys.stderr)
    print(_jsonable(events, live=False), flush=True)
    return 0


def cmd_stems(args) -> int:
    from aegis_tpu_torch.synth.stems import separate_stems

    path = separate_stems(args.input, args.output_dir, method=args.method,
                          device=args.device)
    print(path)
    return 0 if path != args.input else 2


def cmd_serve(args) -> int:
    """The REST server until interrupted (``python -m
    aegis_tpu_torch.serve.server`` takes the same flags)."""
    from aegis_tpu_torch.serve.server import main as serve_main

    serve_main(args.host, args.port, device=args.device)
    return 0


WARM_PIPELINES = ("v1", "neural", "financial", "neural-financial", "poly",
                  "stream", "neural-stream", "live-v1", "live-financial",
                  "live-poly")


def warmup(pipelines=("v1", "financial"), seconds=(60.0,), sr: int = 22050,
           device="cuda") -> None:
    """One run of each pipeline (``WARM_PIPELINES``) per duration, on
    silence, through the port's facades; prints one ``warm`` line a run.

    What a first call pays on the card and this moves to install time: the
    nvcc build of the Viterbi kernels (csrc/viterbi.cu, into
    ``build/aegis_tpu_torch/`` beside the package) and the g++ build of
    the native host library (``~/.cache/aegis_tpu_torch``), which both stay
    on disk for every later process; and, for this process only, the CUDA
    context, the cuBLAS handle and cuFFT plans, the PitchNet checkpoint on
    the device (the neural pipelines) and the kernel library's loading.  A
    new process, such as the server started after this command, pays that
    per-process part again (seconds, not the builds).  The live pipelines
    feed one tile of silence to ``StreamingTranscriber`` /
    ``StreamingPolyTranscriber``; the stream pipelines run the slab
    program, whose shapes do not depend on the track's length."""
    import time

    import numpy as np

    from aegis_tpu_torch import resolve_device
    from aegis_tpu_torch.native import get_lib

    bad = set(pipelines) - set(WARM_PIPELINES)
    if bad:
        raise ValueError(f"unknown pipeline(s) {sorted(bad)}; choose from "
                         f"{sorted(WARM_PIPELINES)}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    get_lib()
    if dev.type == "cuda":
        from aegis_tpu_torch.core import pyin_cuda

        pyin_cuda.library()
        pyin_cuda.trough_library()
    print(f"# builds ready in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    def run(pipe: str, y: np.ndarray) -> None:
        if pipe.startswith("live-"):
            from aegis_tpu_torch.engine import realtime

            if pipe == "live-poly":
                rt = realtime.StreamingPolyTranscriber(sample_rate=sr,
                                                       device=dev)
            else:
                from aegis_tpu_torch.config import AudioConfig

                rt = realtime.StreamingTranscriber(
                    audio=AudioConfig(sample_rate=sr),
                    financial=(pipe == "live-financial"), device=dev)
            rt.feed(np.zeros(rt._tile_samp + 2 * rt._ctx + 1, np.float32))
            return
        if pipe == "poly":
            from aegis_tpu_torch.engine.poly import AegisPolyEngine

            AegisPolyEngine(sample_rate=sr, device=dev).analyze(y)
            return
        kw = {}
        if pipe in ("neural", "neural-financial", "neural-stream"):
            kw["pitch_backend"] = "neural"
        if pipe.endswith("stream"):
            kw["turbo_mode"] = "stream"
        if pipe in ("financial", "neural-financial"):
            from aegis_tpu_torch.engine.financial import AegisFinancialEngine

            AegisFinancialEngine(sample_rate=sr,
                                 device=dev).audio_to_midi_financial(
                y, None, **kw)
        else:
            from aegis_tpu_torch.engine.engine import AegisEngine

            AegisEngine(sample_rate=sr, device=dev).audio_to_midi(y, None,
                                                                  **kw)

    for sec in seconds:
        y = np.zeros(int(sec * sr), np.float32)
        for pipe in pipelines:
            t0 = time.perf_counter()
            run(pipe, y)
            if dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            print(f"warm {pipe:>17s} @ {sec:g}s/{sr}Hz: "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)


def cmd_warmup(args) -> int:
    """Pay the first call's builds and set-up at install time (see
    ``warmup``): one run of each requested pipeline per duration on
    silence."""
    try:
        warmup(args.pipelines.split(","),
               [float(s) for s in args.seconds.split(",")], args.sr,
               args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    from aegis_tpu_torch.core.analyze import TRANSPORTS

    ap = argparse.ArgumentParser(prog="aegis_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)
    for name, fn in (("transcribe", cmd_transcribe),
                     ("financial", cmd_financial),
                     ("poly", cmd_poly), ("auto", cmd_auto),
                     ("tabs", cmd_tabs)):
        p = sub.add_parser(name)
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
                       help="off = the fused program, tiles = the tiled "
                            "program, stream = bounded-memory slabs, auto = "
                            "stream past 240 s, else fused (poly: stream "
                            "runs the tiles; neural: tiles run fused; the "
                            "auto command always runs fused)")
        p.add_argument("--no-onsets", action="store_true",
                       help="disable onset-envelope event refinement "
                            "(re-attack splitting + attack-time snap); "
                            "matches the reference's merge/lag semantics")
        p.add_argument("--sr", type=int,
                       default=44100 if name in ("transcribe", "tabs")
                       else 22050)
        if name not in ("poly", "auto"):  # CQT / routed: no pitch backend
            p.add_argument("--rake", type=float, default=0.6)
            p.add_argument("--pitch-backend", default="pyin",
                           choices=["pyin", "neural"],
                           help="pyin (default) or neural (PitchNet, no "
                                "Viterbi)")
        if name == "financial":
            p.add_argument("--pitch-source", default="pyin",
                           choices=["pyin", "trend"],
                           help="series that note pitches quantize from: "
                                "the median-smoothed pYIN f0 (default) or "
                                "the consensus trend (the reference's v2 "
                                "semantics)")
        if name == "tabs":
            p.add_argument("--engine", default="v1",
                           choices=["v1", "poly"],
                           help="poly = chord-capable engine: chord-aware "
                                "fingering + named chord line")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        p.set_defaults(fn=fn)

    p = sub.add_parser("batch")
    p.add_argument("folder")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--pattern", default="*.wav")
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--no-onsets", action="store_true",
                   help="disable onset event refinement (the reference's "
                        "exact merge/lag semantics)")
    p.add_argument("--pitch-backend", default="pyin",
                   choices=["pyin", "neural"],
                   help="neural = PitchNet dispatch-ahead sweep (v1 and "
                        "financial)")
    p.add_argument("--engine", default="v1",
                   choices=["v1", "financial", "poly", "auto"],
                   help="pipeline per track: v1 two-phase (default), "
                        "financial 5-phase, polyphonic CQT, or the "
                        "polyphony-aware router (auto)")
    p.add_argument("--transport", default="int8",
                   choices=TRANSPORTS,
                   help="audio upload packing (int4 = throughput over "
                        "fidelity; poly and auto keep their own)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("stream", description=cmd_stream.__doc__,
                       formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("output", nargs="?", default=None,
                   help="optional .mid written at EOF")
    p.add_argument("--engine", default="v1",
                   choices=["v1", "financial", "poly"],
                   help="v1 (default), financial or poly")
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--confidence", type=float, default=None)
    p.add_argument("--poll-every", type=float, default=2.0,
                   help="seconds of audio between live event prints")
    p.add_argument("--tile-frames", type=int, default=None,
                   help="live tile size in frames (default 24); smaller "
                        "tiles cut the feed->event lookahead at more "
                        "tiles a second (see engine/realtime.py)")
    p.add_argument("--halo-frames", type=int, default=None,
                   help="halo context frames per side (default 8)")
    p.add_argument("--midi-program", type=int, default=None,
                   help="GM program (default: the engine's own, poly 25, "
                        "v1 27; financial uses its named-track encoder)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("stems")
    p.add_argument("input")
    p.add_argument("output_dir")
    p.add_argument("--method", default="auto",
                   choices=["auto", "demucs", "hpss"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_stems)

    p = sub.add_parser("serve", description="REST API + SPA server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8508)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("warmup", description=cmd_warmup.__doc__)
    p.add_argument("--sr", type=int, default=22050)
    p.add_argument("--seconds", default="60",
                   help="comma-separated durations to warm")
    p.add_argument("--pipelines", default="v1,financial",
                   help="comma-separated: " + ",".join(WARM_PIPELINES)
                        + " (the live-* tile programs are what "
                          "/api/stream-* runs)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_warmup)

    from aegis_tpu_torch.models import train
    from aegis_tpu_torch.tools import validate_device
    for name, mod, note in (
            ("train", train, "PitchNet trainer (models/train.py)"),
            ("validate", validate_device,
             "on-device F1 gate (tools/validate_device.py)")):
        p = sub.add_parser(name, description=note)
        mod.add_arguments(p)
        p.set_defaults(fn=mod.run)

    args = ap.parse_args(argv)
    if getattr(args, "end", None) is not None and args.end <= args.start:
        ap.error(f"--end ({args.end}) must be greater than --start "
                 f"({args.start})")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
