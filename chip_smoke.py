#!/usr/bin/env python3
"""Smoke run of aegis_tpu_torch, the PyTorch / CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the v1 WAV -> MIDI transcription
(``AegisEngine.audio_to_midi`` -> ``extract_events`` -> MIDI bytes), the
financial (v2) engine, the tiled, streamed and folder-batch modes, the
live transcribers, the CUDA kernels, the polyphonic stack, the auto router,
the neural (PitchNet) backend, HPSS stems, the ADSR synth and effect chain
and the self-verification loops, in twenty-four phases; each raises on
failure:

  1. device  — a CUDA device must be present; prints nvidia-smi's name and
               power limit; TF32 off.
  2. build   — compiles the Viterbi kernels from aegis_tpu_torch/csrc/ with
               nvcc and prints the seconds and the ptxas report.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               synthetic observations (w = 101, T = 2625; w = 51, T = 5249;
               the stream's slab, B = 16, T = 1152; fewer states than one
               band, n = 150 < 2w + 1) and on the real observations of the
               60 s bench track at 22 050 and 44 100 Hz: backpointers, final
               delta and states identical, with the cluster the wrapper
               picks and with one CTA a sequence.
  4. slice   — the engine on the card: the 60 s bench track at 22 050 Hz,
               the Karplus-Strong test track and the 60 s bench track at
               44 100 Hz; every kernel's launch count must rise by one per
               clip; note-event F1 >= 0.99 against the same engine on the
               CPU, truth F1 >= 0.99 on the 22 050 Hz bench track.
  5. times   — warm medians of 5 (CUDA events): audio_to_midi on each 60 s
               track, and each kernel against its plain version at the
               slice's shapes, beside its bound (the card's least time for
               the same bytes and operations) and its serial floor; every
               variant of the forward kernel (tile, cluster, table in
               global memory) at the fused shape; a torch.profiler breakdown of one run.
  6. financial — AegisFinancialEngine on the 60 s bench track at 22 050 Hz
               and the Karplus-Strong track at 44 100 Hz: one launch per
               kernel per clip, note-event F1 >= 0.99 against the CPU
               engine, truth F1 >= 0.99 on the bench track.
  7. tiles   — v1 and financial with turbo_mode="tiles" on both 60 s
               tracks: one launch per kernel per call at B = n_tiles, the
               kernels equal to their plain versions on the real tile
               observations (B = 3, B = 6, and the first 16 tiles of the
               10-minute track), F1 >= 0.99 against the fused engine.
  8. batch   — transcribe_folder over four 60 s bench tracks (seeds 42-45)
               as WAVs, v1 and financial: one launch per kernel per track,
               MIDI equal to the per-track facade's; the synchronizing
               calls of dispatch_analyze (torch's sync debug mode), printed;
               run_analyze_batch on the same tracks: one launch per kernel
               at B = 4 * n_tiles, per-track scalar rows of shape (4,).
  9. stream  — the 10-minute bench track, v1 and financial, default slabs
               (26 tiles in 2 slabs of 16): two launches per kernel, truth
               F1 >= 0.99, event F1 = 1.0 against tiles with the int16
               transport; prints whether the pYIN rows are bit-identical.
 10. times   — warm medians of 5 (CUDA events): the financial engine on
               60 s, v1 tiles on 60 s, the four-track folder, the 10-minute
               stream, the kernels at B = n_tiles against their plain
               versions; a torch.profiler breakdown of the financial run
               with the trend stack's device time apart.
 11. live kernels — each kernel against its plain version on real tile
               observations at the live transcriber's launch shapes: B = 1,
               T = 40 (tile 24, halo 8) and T = 128 (64, 32), at 22 050 Hz
               (w = 101) and 44 100 Hz (w = 51); the cluster the wrapper
               picks and one CTA a sequence; backpointers, final delta and
               states identical.
 12. live    — StreamingTranscriber on the card, fed 0.5 s chunks and polled
               every 2 s of audio: v1 on the 60 s track at both rates and
               both presets and on the 10-minute track, financial on the
               60 s and the 10-minute track.  Each kernel launched exactly
               once a tile with B = 1; poll_events() == _poll_full() at the
               first, middle and last poll; finalize() F1 >= 0.99 against
               the tiled engine on the card at the same tile and halo,
               against the truth, and (60 s at 22 050 Hz) against the same
               session on the CPU.
 13. times   — of each live session, beside the card's name and power limit:
               wall ms a tile (median, p95), the ingest margin, the audio
               seconds from a note's onset to the first poll that shows it,
               poll_events() ms, finalize() ms; device-busy ms and launches
               a tile (torch.profiler over eight tiles); the kernels at the
               live shapes against their plain versions and the one-CTA
               variant, with bound and serial floor.
 14. poly parts — the polyphonic device half on the card, at 22 050 and
               44 100 Hz on the CQT of a chord clip: the voice peel against
               its NumPy oracle (picks equal on >= 0.999 of entries,
               saliences rtol 5e-4), the f16 plane packing against its host
               twin byte for byte, the packed program against the same
               program on the CPU.
 15. poly    — AegisPolyEngine on the card: chord progressions of seeds 1,
               3, 7 at 22 050 Hz and 7, 8, 10 at 44 100 Hz, truth F1 >= 0.99
               and F1 >= 0.99 against the CPU engine (prints whether the
               events are equal); then a 60 s chord track at each rate and a
               10-minute one at 22 050 Hz, which "auto" sends to the tiles:
               fused against tiles F1 >= 0.99, truth F1 at the JAX engine's
               own on the same track (JAX_CPU_TRUTH_F1).
 16. poly folder — transcribe_folder(engine="poly") over four 60 s chord
               WAVs: MIDI bytes equal to the facade's; no synchronizing call
               in dispatch_analyze_poly (torch's sync debug mode).
 17. poly live — StreamingPolyTranscriber at tile 24 / halo 8 on the three
               chord tracks, 0.5 s chunks, polled every 2 s: the first,
               middle and last poll equal to _poll_full(), finalize() F1 >=
               0.99 against the offline engine on the card (prints whether
               note, start and end are equal).
 18. times   — of the polyphonic paths, beside the card's name and power
               limit, warm medians of 5: analyze and audio_to_midi fused and
               tiled at 60 s (both rates) and 10 minutes, the device program
               apart from the host extraction, the folder, each live
               session's tile ms, ingest margin, poll and finalize ms; a
               torch.profiler pass over one fused 60 s analyze.
               The polyphonic paths run no pYIN: phases 15-17 fail if either
               Viterbi kernel is launched in them.
 19. auto    — AegisAutoEngine on the card: mixed clips of seeds 1-3 and the
               chord progression of seed 3 at 22 050 Hz, mixed seed 1 and
               chord seed 3 at 44 100 Hz, the 60 s bench track at both rates
               (the v1 half on hop 1024 at 44 100 Hz: B = 1, T = 2625,
               w = 101): exactly one launch of each Viterbi kernel a call at
               B = 1, F1 >= 0.99 against the same engine on the CPU, truth F1
               no more than 0.01 under the JAX engine's own on the CPU
               (JAX_CPU_AUTO_TRUTH_F1); both kernels against their plain
               versions on the router's observations of the 60 s tracks;
               transcribe_folder(engine="auto") over four clips as WAVs:
               MIDI equal to the facade's, no synchronizing call in
               dispatch_analyze_auto.
 20. neural  — AegisEngine(pitch_backend="neural") fused on the 60 s track
               at both rates and streamed on the 10-minute track, the
               financial engine neural on 60 s, the neural folder over four
               60 s WAVs: no Viterbi launch, F1 >= 0.99 against the CPU
               engine, truth F1 at the JAX engine's own
               (JAX_CPU_NEURAL_TRUTH_F1), the streamed rows against the fused
               program's at int16 (discrete rows equal, floats within
               rtol 1e-5), folder MIDI equal to the facade's.
 21. times   — warm medians of 5, beside the card's name and power limit:
               auto analyze and audio_to_midi at 60 s at both rates,
               extract_events apart, the auto folder; neural fused analyze
               and audio_to_midi at both rates, the 10-minute stream, the
               neural folder; a torch.profiler pass over a fused auto and a
               fused neural analyze; the kernels at the auto 44 100 Hz shape.
 22. hpss    — hpss on the card: the 60 s bench track at 22 050 Hz (one
               program), at 44 100 Hz (two slabs), the 10-minute track
               (seven slabs); each within 1e-4 of the port's CPU run, the
               60 s 22 050 Hz one also of the float64 oracle;
               AegisEngine.separate_stems and the stems command (exit 0)
               write other.wav / drums.wav; warm medians of 5 of each size
               and a torch.profiler pass over the 60 s call.
 23. synth   — synthesize_midi_adsr on the 60 s bench track's notes at
               44 100 Hz against the CPU (render within 1e-5, envelope
               segment lengths equal), then apply_effect_chain of every
               EFFECT_PRESETS entry on that render (1e-4); their times.
 24. verify  — the self-verification loops on the card's v1 engine at
               44 100 Hz with the FluidSynth binary missing (the ADSR synth
               renders, and the phase says so): reverse_analysis (metrics
               equal to the CPU run, note accuracy at least the JAX
               engine's, one launch of each Viterbi kernel, both kernels
               identical to their plain versions on its observations),
               learning_loop on "full_fx" (one launch of each),
               auto_match_parameters (the CPU twin on the first 15 s: the
               same pick, score within 1e-5), optimize_all_notes (the same
               parameters per note as the CPU on the events of the first
               15 s), verify_technique_by_audio_matching (the same
               decisions as the CPU); the loops' times.

Prints one JSON object per result and each phase's seconds, then the
kernels line (each kernel's launches on the main paths, its error, and at
every shape the launches one call made in this run, its time beside the
plain version's, its bound and its serial floor; no single PyTorch call
computes a Viterbi decode, so library_ms is null), then
as the last line {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when torch.cuda.is_available() is False or
the package is missing.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.core import cqt as tcqt
from aegis_tpu_torch.core import poly as tpoly
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.analyze import (dequant_transport, dispatch_analyze,
                                          fetch_analyze, pad_to_bucket,
                                          quantize_pcm8)
from aegis_tpu_torch.core.events import extract_events_v1
from aegis_tpu_torch.core.tables import poly_tables, tables_from_numpy
from aegis_tpu_torch.engine import turbo as tturbo
from aegis_tpu_torch.engine.auto import (AegisAutoEngine,
                                         dispatch_analyze_auto,
                                         fetch_analyze_auto)
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.engine.poly import (AegisPolyEngine,
                                         dispatch_analyze_poly,
                                         fetch_analyze_poly)
from aegis_tpu_torch.engine.realtime import (StreamingPolyTranscriber,
                                             StreamingTranscriber)
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import (MidiFile, MidiMessage, MidiTrack,
                                  midi_to_notes, second2tick)
from aegis_tpu_torch.models.pitchnet import (run_analyze_neural,
                                             run_analyze_neural_streamed)
from aegis_tpu_torch.ref.poly_ref import peel_voices_ref
from aegis_tpu_torch.tools.bench_viterbi import (band_and_table, cuda_ms,
                                                 forward_variant,
                                                 synthetic_inputs)
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                              generate_chord_progression,
                                              generate_mixed_clip,
                                              generate_test_track)
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

HOP = 512
CFG = PyinConfig()
LOG_STAY = float(np.log1p(-CFG.switch_prob))
LOG_SWITCH = float(np.log(CFG.switch_prob))
KERNEL_SOURCE = "aegis_tpu_torch/csrc/viterbi.cu"
# NVIDIA H100 SXM, from its data sheet: float32 outside the tensor cores,
# device memory, streaming multiprocessors
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
N_SMS = 132
# the live transcriber's presets: (tile, halo) frames
LIVE_PRESETS = ((24, 8), (64, 32))
CARD = {"nvidia_smi": None}   # the card's name and power limit, set by phase 1
REPLACES = {"viterbi_fwd": "aegis_tpu/core/pyin_pallas.py:98",
            "viterbi_back": "aegis_tpu/core/pyin_pallas.py:198"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_bounds(name: str, B: int, T: int, n: int, w: int) -> dict:
    """The least time the card could take for one call of a kernel: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations over the float32 rate; and the
    serial floor, T - 1 dependent steps at one SM's rate, which no design
    for one sequence can pass because step t needs step t - 1."""
    if name == "viterbi_fwd":
        # an add and a compare-select per in-band pair and chain
        step_ops = 4 * (n * (2 * w + 1) - w * (w + 1))
        ops = B * (T - 1) * step_ops
        n_cls = n if n < 2 * w + 1 else w + 1
        nbytes = 4 * (B * T * n + B * T + n_cls * (w + 1)   # observations, table
                      + 2 * B * T * n + 2 * B * n)          # backpointers, delta
        floor_ms = 1e3 * (T - 1) * step_ops / (PEAK_FP32_FLOPS / N_SMS)
    else:
        # the final delta, then one backpointer read and one state written
        # a frame; an argmax compare a state and a step a frame
        ops = B * (2 * n + T)
        nbytes = 4 * B * (2 * n + 2 * T)
        floor_ms = None
    t_ops = 1e3 * ops / PEAK_FP32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "serial_floor_ms": floor_ms}


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "needs one NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    CARD["nvidia_smi"] = smi
    dev = resolve_device("cuda")
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})
    return dev


def phase_build() -> None:
    t0 = time.perf_counter()
    so_path = pyin_cuda.build()
    pyin_cuda.library()
    seconds = time.perf_counter() - t0
    report = so_path.with_suffix(".ptxas.txt").read_text()
    for line in report.splitlines():
        if "ptxas" in line:
            print(line.strip(), flush=True)
    emit({"phase": "build", "seconds": seconds, "library": so_path.name})


def real_obs(y: np.ndarray, sr: int, dev: torch.device, hop: int = HOP):
    """The decode's observations for a track, as the main path computes
    them on the card (bucket padding, int8 transport, pYIN stages); ``hop``
    1024 at 44 100 Hz is the auto router's v1 half."""
    tables = tables_from_numpy(AudioConfig(sample_rate=sr, hop_length=hop),
                               CFG, dev)
    y8, s8 = quantize_pcm8(pad_to_bucket(np.asarray(y, np.float32)))
    yd = dequant_transport(torch.from_numpy(y8).to(dev),
                           torch.from_numpy(s8).to(dev))
    frames = tpyin.extract_pyin_frames(yd, hop, CFG)
    obs, vprob = tpyin.frame_observations(frames, sr, CFG, tables)
    return obs, vprob, tables


def compare_kernels(name: str, lo_v, lo_u, band, tab, w: int, floor: float,
                    errs: dict) -> dict:
    """Run both kernels and both plain versions on the same inputs."""
    n = band.shape[0]
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w,
                                                 LOG_STAY, LOG_SWITCH, tab)
    torch.cuda.synchronize()
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    one_cta = forward_variant(lo_v, lo_u, tab, n, w, 88, 1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b)
               for a, b in zip(one_cta, (psi_v, psi_u, d_last))):
        raise AssertionError(f"{name}: one CTA a sequence differs from the "
                             "cluster")
    p_v, p_u, p_last = pyin_cuda.viterbi_fwd_plain(
        lo_v, lo_u, pyin_cuda.dense_from_band(band, n, w), LOG_STAY,
        LOG_SWITCH)
    p_states = pyin_cuda.viterbi_back_plain(p_last, p_v, p_u)
    back_same_in = pyin_cuda.viterbi_back_plain(d_last, psi_v, psi_u)
    agree = float((states == p_states).double().mean())
    fwd_err = float((d_last - p_last).abs().max())
    back_err = float((states - back_same_in).abs().max())
    errs["viterbi_fwd"] = max(errs.get("viterbi_fwd", 0.0), fwd_err)
    errs["viterbi_back"] = max(errs.get("viterbi_back", 0.0), back_err)
    row = {"phase": "kernel_vs_plain", "case": name, "B": lo_v.shape[0],
           "T": lo_v.shape[1], "n": n, "w": w, "state_agreement": agree,
           "delta_last_identical": bool(torch.equal(d_last, p_last)),
           "psi_identical": bool(torch.equal(psi_v, p_v)
                                 and torch.equal(psi_u, p_u)),
           "delta_last_max_abs_err": fwd_err,
           "back_max_abs_err_same_inputs": back_err, "floor": floor}
    emit(row)
    if agree < floor:
        raise AssertionError(f"{name}: state agreement {agree} < {floor}")
    if floor == 1.0 and not (row["psi_identical"]
                             and row["delta_last_identical"]):
        raise AssertionError(f"{name}: backpointers or final delta differ "
                             "from the plain version")
    if back_err != 0:
        raise AssertionError(f"{name}: backtrace kernel differs from plain")
    return row


def phase_kernels(dev, tracks, errs) -> dict:
    n = CFG.n_pitch_bins
    # (B, T, n, w): the fused shapes, the stream's slab, n < 2w + 1
    for B, T, n_s, w, seed in ((1, 2625, n, 101, 11), (1, 5249, n, 51, 21),
                               (16, 1152, n, 101, 31), (2, 300, 150, 101, 41)):
        lo_v, lo_u = synthetic_inputs(B, T, n_s, dev, seed, 9)
        band, tab = band_and_table(n_s, w, dev)
        compare_kernels(f"synthetic_B{B}_T{T}_n{n_s}_w{w}", lo_v, lo_u, band,
                        tab, w, 1.0, errs)
    shapes = {}
    for sr, (y, _) in tracks.items():
        obs, vprob, tables = real_obs(y, sr, dev)
        lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
        compare_kernels(f"bench60_{sr}", lo_v, lo_u, tables.band,
                        tables.band_tab, tables.half_width, 1.0, errs)
        shapes[sr] = (obs, vprob, tables)
    return shapes


def phase_slice(dev, tracks, per_call: dict) -> dict:
    """Returns each kernel's launch count over the main path's runs; notes
    each clip's own counts in ``per_call``."""
    clips = [("bench60_22050", 22050, *tracks[22050]),
             ("ks_44100", 44100, *generate_test_track(sr=44100)),
             ("bench60_44100", 44100, *tracks[44100])]
    engines = {sr: AegisEngine(sample_rate=sr, device=dev)
               for sr in (22050, 44100)}
    for k in pyin_cuda.LAUNCHES:
        pyin_cuda.LAUNCHES[k] = 0
    runs = []
    for name, sr, y, truth in clips:
        before = dict(pyin_cuda.LAUNCHES)
        eng = engines[sr]
        raw = eng.audio_to_midi(y)
        buf = io.BytesIO()
        events = eng.extract_events(raw, buf, confidence_threshold=0.3)
        per_call[name] = {k: v - before[k]
                          for k, v in pyin_cuda.LAUNCHES.items()}
        for k, v in per_call[name].items():
            if v != 1:
                raise AssertionError(f"{name}: {k} launched {v} times, "
                                     "expected 1")
        runs.append((name, sr, y, truth, raw, events, buf.getvalue()))
    launches = dict(pyin_cuda.LAUNCHES)
    emit({"phase": "slice_launches", **launches})
    if any(v != len(clips) for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {len(clips)}")

    for name, sr, y, truth, raw, events, midi in runs:
        T = 1 + len(y) // HOP
        for key in ("f0", "voiced_probs", "rms", "onset_env"):
            if raw[key].shape != (T,) or not np.isfinite(raw[key]).all():
                raise AssertionError(f"{name}: bad {key} row")
        if not midi.startswith(b"MThd") or not events:
            raise AssertionError(f"{name}: no MIDI / no events")
        cpu = AegisEngine(sample_rate=sr, device="cpu")
        ev_cpu = cpu.extract_events(cpu.audio_to_midi(y), None,
                                    confidence_threshold=0.3)
        f1 = note_event_f1(events_to_seconds(ev_cpu, sr, HOP),
                           events_to_seconds(events, sr, HOP))
        row = {"phase": "slice", "clip": name, "sr": sr,
               "seconds": len(y) / sr, "events": len(events),
               "cpu_events": len(ev_cpu), "f1_vs_cpu": f1["f1"],
               "notes_equal_cpu": [(e["note"], e["start"], e["end"])
                                   for e in events]
               == [(e["note"], e["start"], e["end"]) for e in ev_cpu],
               "midi_bytes": len(midi)}
        if truth is not None:
            row["truth_f1"] = note_event_f1(
                truth, events_to_seconds(events, sr, HOP))["f1"]
            row["truth_notes"] = len(truth)
        emit(row)
        if f1["f1"] < 0.99:
            raise AssertionError(f"{name}: F1 vs CPU {f1['f1']} < 0.99")
        if name == "bench60_22050" and row["truth_f1"] < 0.99:
            raise AssertionError(f"{name}: truth F1 {row['truth_f1']} < 0.99")
    return launches


def time_kernels(obs, vprob, tables, with_decode: bool) -> dict:
    """Warm medians of each kernel and its plain version on one batch of
    observations (B, T, n), with the bounds of that shape."""
    n, w, band, tab = (CFG.n_pitch_bins, tables.half_width, tables.band,
                       tables.band_tab)
    lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
    B, T = lo_v.shape[:2]
    dense = pyin_cuda.dense_from_band(band, n, w)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w,
                                                 LOG_STAY, LOG_SWITCH, tab)
    row = {
        "viterbi_fwd": cuda_ms(lambda: pyin_cuda.viterbi_fwd(
            lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH, tab)),
        "viterbi_fwd_plain": cuda_ms(lambda: pyin_cuda.viterbi_fwd_plain(
            lo_v, lo_u, dense, LOG_STAY, LOG_SWITCH)),
        "viterbi_back": cuda_ms(lambda: pyin_cuda.viterbi_back(
            d_last, psi_v, psi_u)),
        "viterbi_back_plain": cuda_ms(lambda: pyin_cuda.viterbi_back_plain(
            d_last, psi_v, psi_u)),
    }
    if with_decode:
        row["viterbi_decode_cuda"] = cuda_ms(
            lambda: pyin_cuda.viterbi_decode_cuda(
                lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH, tab))
        row["viterbi_decode_plain"] = cuda_ms(lambda: tpyin.viterbi_decode(
            obs[0], vprob[0], dense, CFG.switch_prob))
    row["shape"] = {"B": B, "T": T, "n": n, "w": w}
    row["bounds"] = {k: kernel_bounds(k, B, T, n, w)
                     for k in ("viterbi_fwd", "viterbi_back")}
    return row


def time_experiments(obs, vprob, tables) -> None:
    """Every variant of the forward kernel at one shape (both destination
    tiles, one to eight CTAs a sequence, the table in global memory), each
    beside the one the wrapper picks."""
    n, w, band, tab = (CFG.n_pitch_bins, tables.half_width, tables.band,
                       tables.band_tab)
    lo_v, lo_u = tpyin.decode_inputs(obs, vprob)

    def ms(tile, cluster, in_smem=True):
        return cuda_ms(lambda: forward_variant(lo_v, lo_u, tab, n, w, tile,
                                               cluster, in_smem))

    row = {f"tile{t}_cluster{c}": ms(t, c)
           for t in pyin_cuda.FWD_TILES for c in pyin_cuda.FWD_CLUSTERS
           if t != 96 or c > 1}
    row["tile88_cluster1_table_in_global_memory"] = ms(88, 1, False)
    row["picked_by_the_wrapper"] = cuda_ms(lambda: pyin_cuda.viterbi_fwd(
        lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH, tab))
    emit({"phase": "times", "what": "viterbi_fwd_experiments",
          "B": lo_v.shape[0], "T": lo_v.shape[1], "w": w, "median_ms": row})


def phase_times(dev, tracks, shapes) -> dict:
    e2e = {}
    for sr, (y, _) in tracks.items():
        eng = AegisEngine(sample_rate=sr, device=dev)
        ms = cuda_ms(lambda: eng.audio_to_midi(y))
        e2e[sr] = ms
        emit({"phase": "times", "what": "audio_to_midi", "sr": sr,
              "track_s": len(y) / sr, "median_ms": ms,
              "realtime_factor": len(y) / sr / (ms / 1000.0)})

    kernel_ms = {}
    for sr, (obs, vprob, tables) in shapes.items():
        row = time_kernels(obs[None], vprob[None], tables, True)
        kernel_ms[sr] = row
        emit({"phase": "times", "what": "viterbi", "sr": sr, **row["shape"],
              "median_ms": row})
        time_experiments(obs[None], vprob[None], tables)

    y, _ = tracks[22050]
    eng = AegisEngine(sample_rate=22050, device=dev)
    eng.audio_to_midi(y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        eng.audio_to_midi(y)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1000.0
    avgs = prof.key_averages()

    def dev_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    kernels = [a for a in avgs
               if a.device_type == torch.autograd.DeviceType.CUDA
               and not a.key.startswith("aegis.")]
    busy_ms = sum(dev_us(a) for a in kernels) / 1000.0
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit({"phase": "profile", "sr": 22050, "wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "kernel_launches": sum(a.count
                                                            for a in kernels),
          "idle_share_of_warm_median": 1.0 - busy_ms / e2e[22050],
          "top_device_kernels": [[a.key[:70], dev_us(a) / 1000.0, a.count]
                                 for a in top]})
    return kernel_ms


def run_counted(fn):
    """fn() with every launch count set to 0 just before; returns (result,
    counts, the batch size of each kernel's last launch)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(pyin_cuda.LAUNCHES), dict(pyin_cuda.LAST_BATCH)


def reset_counts() -> None:
    for counts in (pyin_cuda.LAUNCHES, pyin_cuda.SEQUENCES):
        for k in counts:
            counts[k] = 0


def expect_launches(name: str, counts: dict, batch: dict, n: int,
                    b: int | None = None) -> None:
    for k in pyin_cuda.LAUNCHES:
        if counts[k] != n:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times, "
                                 f"expected {n}")
        if b is not None and batch[k] != b:
            raise AssertionError(f"{name}: {k} launched at B={batch[k]}, "
                                 f"expected {b}")


def f1_of(ref, est) -> float:
    return note_event_f1(ref, est)["f1"]


def secs(events, sr):
    return events_to_seconds(events, sr, HOP)


def n_tiles_of(y: np.ndarray, sr: int, turbo: TurboConfig) -> int:
    return max(1, -(-AudioConfig(sample_rate=sr).n_frames(len(y))
                    // turbo.tile_frames))


def phase_financial(dev, tracks, total: dict) -> None:
    """The financial engine's one-shot entry point on the card, through its
    MIDI bytes: launches, F1 against the CPU engine and against the truth."""
    clips = [("bench60_22050", 22050, *tracks[22050]),
             ("ks_44100", 44100, *generate_test_track(sr=44100))]
    with tempfile.TemporaryDirectory() as d:
        for name, sr, y, truth in clips:
            eng = AegisFinancialEngine(sample_rate=sr, device=dev)
            path = os.path.join(d, f"{name}.mid")
            out, counts, batch = run_counted(
                lambda: eng.audio_to_midi_financial(y, path))
            expect_launches(name, counts, batch, 1, 1)
            add_counts(total, counts)
            if out != path:
                raise AssertionError(f"{name}: no MIDI written")
            notes = midi_to_notes(path)
            cpu_path = os.path.join(d, f"{name}_cpu.mid")
            AegisFinancialEngine(sample_rate=sr, device="cpu"
                                 ).audio_to_midi_financial(y, cpu_path)
            cpu_notes = midi_to_notes(cpu_path)
            row = {"phase": "financial", "clip": name, "sr": sr,
                   "notes": len(notes), "cpu_notes": len(cpu_notes),
                   "f1_vs_cpu": f1_of(cpu_notes, notes),
                   "midi_equal_cpu": open(path, "rb").read()
                   == open(cpu_path, "rb").read()}
            if truth is not None:
                row["truth_f1"] = f1_of(truth, notes)
                row["truth_notes"] = len(truth)
            emit(row)
            if row["f1_vs_cpu"] < 0.99:
                raise AssertionError(f"{name}: F1 vs CPU {row['f1_vs_cpu']}")
            if name.startswith("bench") and row["truth_f1"] < 0.99:
                raise AssertionError(f"{name}: truth F1 {row['truth_f1']}")


def tile_obs(y: np.ndarray, sr: int, dev, turbo: TurboConfig):
    """The decode's observations of every tile as the tiled program computes
    them on the card: int16 transport, haloed slabs, pYIN stages."""
    audio = AudioConfig(sample_rate=sr)
    tables = tables_from_numpy(audio, CFG, dev)
    n_tiles = n_tiles_of(y, sr, turbo)
    y16, scale = tturbo._tiled_inputs(
        np.asarray(y, np.float32)[None],
        n_tiles * turbo.tile_frames * HOP, "int16", dev)
    slabs = tturbo.tile_slabs(y16, scale, audio, CFG, turbo, n_tiles)
    frames = tturbo._frame_slab(slabs, turbo.tile_frames + 2 * turbo.halo_frames,
                                HOP, CFG.frame_length, 0)
    obs, vprob = tpyin.frame_observations(frames, sr, CFG, tables)
    return obs, vprob, tables


def phase_tiles(dev, tracks, y10, errs, total: dict, per_call: dict) -> dict:
    """Returns each rate's tile observations, and those of the streamed
    mode's first slab, for the times phase; notes the counts of one tiled
    call at each rate in ``per_call``."""
    turbo = TurboConfig()
    shapes = {}
    # the stream's launch shape on real observations: the first 16 tiles of
    # the 10-minute track
    obs, vprob, tables = tile_obs(y10[:(16 * turbo.tile_frames - 1) * HOP], 22050,
                                  dev, turbo)
    compare_kernels("stream_slab_22050", *tpyin.decode_inputs(obs, vprob),
                    tables.band, tables.band_tab, tables.half_width, 1.0, errs)
    shapes["stream_slab_22050"] = (obs, vprob, tables)
    for sr, (y, _) in tracks.items():
        obs, vprob, tables = tile_obs(y, sr, dev, turbo)
        lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
        compare_kernels(f"tiles60_{sr}", lo_v, lo_u, tables.band,
                        tables.band_tab, tables.half_width, 1.0, errs)
        shapes[f"tiles60_{sr}"] = (obs, vprob, tables)
        n_tiles = n_tiles_of(y, sr, turbo)

        v1 = AegisEngine(sample_rate=sr, device=dev)
        raw, counts, batch = run_counted(
            lambda: v1.audio_to_midi(y, turbo_mode="tiles"))
        expect_launches(f"v1 tiles {sr}", counts, batch, 1, n_tiles)
        add_counts(total, counts)
        per_call[f"tiles60_{sr}"] = counts
        ev = v1.extract_events(raw, None, confidence_threshold=0.3)
        ev_fused = v1.extract_events(v1.audio_to_midi(y), None,
                                     confidence_threshold=0.3)

        fin = AegisFinancialEngine(sample_rate=sr, device=dev)
        a, counts, batch = run_counted(
            lambda: fin.analyze(y, turbo_mode="tiles"))
        expect_launches(f"financial tiles {sr}", counts, batch, 1, n_tiles)
        add_counts(total, counts)
        fev, _ = fin.extract_events(a)
        fev_fused, _ = fin.extract_events(fin.analyze(y))
        row = {"phase": "tiles", "sr": sr, "n_tiles": n_tiles,
               "v1_events": len(ev), "v1_f1_vs_fused":
               f1_of(secs(ev_fused, sr), secs(ev, sr)),
               "financial_events": len(fev), "financial_f1_vs_fused":
               f1_of(secs(fev_fused, sr), secs(fev, sr))}
        emit(row)
        if min(row["v1_f1_vs_fused"], row["financial_f1_vs_fused"]) < 0.99:
            raise AssertionError(f"tiles {sr}: F1 vs fused below 0.99")
    return shapes


def sync_warnings_of(fn):
    """fn() under torch's CUDA sync debug mode: the result and the messages
    of the synchronizing calls it made."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message).splitlines()[0][:120] for w in caught]


def phase_batch(dev, folder: str, ys: list, total: dict) -> None:
    audio = AudioConfig(sample_rate=22050)
    for engine in ("v1", "financial"):
        out_dir = os.path.join(folder, f"mid_{engine}")
        results, counts, batch = run_counted(lambda: transcribe_folder(
            folder, out_dir, engine=engine, device=dev))
        expect_launches(f"folder {engine}", counts, batch, len(ys), 1)
        add_counts(total, counts)
        same = []
        for wav, mid, n in results:
            ref = os.path.join(folder, f"facade_{engine}.mid")
            if engine == "v1":
                eng = AegisEngine(sample_rate=22050, device=dev)
                n_ref = len(eng.extract_events(eng.audio_to_midi(wav), ref))
            else:
                eng = AegisFinancialEngine(sample_rate=22050, device=dev)
                eng.audio_to_midi_financial(wav, ref)
                n_ref = len(eng.extract_events(eng.analyze(wav))[0])
            same.append(n == n_ref and open(mid, "rb").read()
                        == open(ref, "rb").read())
        emit({"phase": "batch", "engine": engine, "tracks": len(results),
              "events": [n for _, _, n in results],
              "equal_to_facade": same})
        if not all(same) or len(results) != len(ys):
            raise AssertionError(f"folder {engine}: differs from the facade")

    # the folder's dispatch half must queue work without waiting for it
    handles, msgs = sync_warnings_of(lambda: [dispatch_analyze(
        y, audio, CFG, financial=True, fetch_mel=False, device=dev)
        for y in ys])
    for h in handles:
        fetch_analyze(h)
    emit({"phase": "batch", "dispatch_sync_calls": len(msgs),
          "first": msgs[:3]})

    n_tiles = n_tiles_of(ys[0], 22050, TurboConfig())
    out, counts, batch = run_counted(lambda: tturbo.run_analyze_batch(
        np.stack(ys), audio, CFG, financial=True, fetch_mel=False,
        device=dev))
    expect_launches("run_analyze_batch", counts, batch, 1, len(ys) * n_tiles)
    add_counts(total, counts)
    shapes = {k: out[k].shape for k in ("adaptive_threshold",
                                         "distortion_score", "f0", "trend")}
    emit({"phase": "batch", "engine": "run_analyze_batch",
          "B": batch["viterbi_fwd"], "shapes": shapes,
          "adaptive_threshold": out["adaptive_threshold"].tolist()})
    T = audio.n_frames(len(ys[0]))
    if (shapes["adaptive_threshold"] != (len(ys),)
            or shapes["distortion_score"] != (len(ys),)
            or shapes["f0"] != (len(ys), T)):
        raise AssertionError(f"run_analyze_batch shapes {shapes}")


def raw_of(out: dict) -> dict:
    """An analyze result as the v1 facade's raw_data (f0 zero-filled)."""
    return {**out, "f0": np.nan_to_num(np.asarray(out["f0"], np.float64))}


def phase_stream(dev, y10, truth10, total: dict, per_call: dict) -> None:
    audio = AudioConfig(sample_rate=22050)
    v1 = AegisEngine(sample_rate=22050, device=dev)
    fin = AegisFinancialEngine(sample_rate=22050, device=dev)
    raw, counts, batch = run_counted(
        lambda: v1.audio_to_midi(y10, turbo_mode="stream"))
    expect_launches("v1 stream", counts, batch, 2, 16)
    add_counts(total, counts)
    per_call["stream_slab_22050"] = counts
    ev = v1.extract_events(raw, None, confidence_threshold=0.3)
    a, counts, batch = run_counted(
        lambda: fin.analyze(y10, turbo_mode="stream"))
    expect_launches("financial stream", counts, batch, 2, 16)
    add_counts(total, counts)
    fev, _ = fin.extract_events(a)

    tiles16 = tturbo.run_analyze_turbo(y10, audio, CFG, fetch_mel=False,
                                       device=dev)
    st16 = tturbo.run_analyze_streamed(y10, audio, CFG, transport="int16",
                                       device=dev)
    ev_t = v1.extract_events(raw_of(tiles16), None, confidence_threshold=0.3)
    ev_s = v1.extract_events(raw_of(st16), None, confidence_threshold=0.3)
    ftiles = tturbo.run_analyze_turbo(y10, audio, CFG, fetch_mel=False,
                                      financial=True, device=dev)
    fst16 = tturbo.run_analyze_streamed(y10, audio, CFG, transport="int16",
                                        financial=True, device=dev)
    bit = {k: bool(np.array_equal(st16[k], tiles16[k], equal_nan=k == "f0"))
           for k in ("f0", "voiced_flag", "voiced_probs", "rms")}
    row = {"phase": "stream", "seconds": len(y10) / 22050,
           "n_tiles": n_tiles_of(y10, 22050, TurboConfig()), "slabs": 2,
           "v1_events": len(ev), "financial_events": len(fev),
           "truth_notes": len(truth10),
           "v1_truth_f1": f1_of(truth10, secs(ev, 22050)),
           "financial_truth_f1": f1_of(truth10, secs(fev, 22050)),
           "v1_int16_f1_vs_tiles": f1_of(secs(ev_t, 22050), secs(ev_s, 22050)),
           "financial_int16_f1_vs_tiles": f1_of(
               secs(fin.extract_events(ftiles)[0], 22050),
               secs(fin.extract_events(fst16)[0], 22050)),
           "pyin_rows_bit_identical_to_tiles": bit}
    emit(row)
    if min(row["v1_truth_f1"], row["financial_truth_f1"]) < 0.99:
        raise AssertionError("stream: truth F1 below 0.99")
    if min(row["v1_int16_f1_vs_tiles"], row["financial_int16_f1_vs_tiles"]) < 1.0:
        raise AssertionError("stream: int16 events differ from tiles")


def phase_times2(dev, tracks, folder: str, y10, tile_shapes) -> dict:
    y, _ = tracks[22050]
    fin = AegisFinancialEngine(sample_rate=22050, device=dev)
    v1 = AegisEngine(sample_rate=22050, device=dev)
    rows = {
        "financial_fused_60s": (60.0, lambda: fin.audio_to_midi_financial(
            y, io.BytesIO())),
        "v1_tiles_60s": (60.0, lambda: v1.audio_to_midi(y, turbo_mode="tiles")),
        "folder_v1_4x60s": (240.0, lambda: transcribe_folder(
            folder, os.path.join(folder, "t_v1"), engine="v1", device=dev)),
        "folder_financial_4x60s": (240.0, lambda: transcribe_folder(
            folder, os.path.join(folder, "t_fin"), engine="financial",
            device=dev)),
        "v1_stream_600s": (len(y10) / 22050, lambda: v1.audio_to_midi(
            y10, turbo_mode="stream")),
    }
    for what, (audio_s, fn) in rows.items():
        ms = cuda_ms(fn)
        emit({"phase": "times", "what": what, "median_ms": ms,
              "audio_s": audio_s,
              "realtime_factor": audio_s / (ms / 1000.0)})

    kernel_ms = {}
    for key, (obs, vprob, tables) in tile_shapes.items():
        row = time_kernels(obs, vprob, tables, False)
        kernel_ms[key] = row
        emit({"phase": "times", "what": "viterbi_tiles", "of": key,
              **row["shape"], "median_ms": row})

    fin.analyze(y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fin.analyze(y)
        torch.cuda.synchronize()
    avgs = prof.key_averages()

    def dev_us(a, total_=False):
        names = (("device_time_total", "cuda_time_total") if total_
                 else ("self_device_time_total", "self_cuda_time_total"))
        for nm in names:
            if hasattr(a, nm):
                return getattr(a, nm)
        return 0.0

    kernels = [a for a in avgs
               if a.device_type == torch.autograd.DeviceType.CUDA
               and not a.key.startswith(("aegis.", "financial."))]
    busy_ms = sum(dev_us(a) for a in kernels) / 1000.0
    trend = [{"key": a.key, "device_type": str(a.device_type),
              "device_ms_total": dev_us(a, True) / 1000.0,
              "cpu_ms_total": a.cpu_time_total / 1000.0, "count": a.count}
             for a in avgs if a.key == "aegis.trend"]
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit({"phase": "profile", "what": "financial_fused_60s_analyze",
          "device_busy_ms": busy_ms,
          "kernel_launches": sum(a.count for a in kernels),
          "trend_stack": trend,
          "top_device_kernels": [[a.key[:70], dev_us(a) / 1000.0, a.count]
                                 for a in top]})
    return kernel_ms


# --------------------------------------------------------------------------
# The live transcribers
# --------------------------------------------------------------------------

def phase_live_kernels(dev, tracks, errs) -> dict:
    """Both kernels at the live launch shapes, on the real observations of
    the first, a middle and the last tile of 10 s of each bench track.
    Returns the middle tile's observations per (rate, tile, halo)."""
    shapes = {}
    for sr, (y, _) in tracks.items():
        for tile, halo in LIVE_PRESETS:
            turbo = TurboConfig(tile_frames=tile, halo_frames=halo)
            obs, vprob, tables = tile_obs(y[:10 * sr], sr, dev, turbo)
            n_t = obs.shape[0]
            for k in sorted({0, n_t // 2, n_t - 1}):
                compare_kernels(
                    f"live_{sr}_T{tile + 2 * halo}_tile{k}",
                    *tpyin.decode_inputs(obs[k:k + 1], vprob[k:k + 1]),
                    tables.band, tables.band_tab, tables.half_width, 1.0, errs)
            mid = slice(n_t // 2, n_t // 2 + 1)
            shapes[(sr, tile, halo)] = (obs[mid].contiguous(),
                                        vprob[mid].contiguous(), tables)
    return shapes


def live_transcriber(dev, sr: int, tile: int, halo: int, financial: bool):
    kw = {"financial": True} if financial else {"confidence_threshold": 0.5}
    return StreamingTranscriber(audio=AudioConfig(sample_rate=sr),
                                tile_frames=tile, halo_frames=halo,
                                device=dev, **kw)


def live_session(dev, y, sr: int, tile: int, halo: int, financial: bool,
                 chunk_s: float = 0.5, poll_s: float = 2.0, rt=None):
    """One live session on the card: ``y`` fed in chunks, polled every
    ``poll_s`` of audio (and after every chunk until the first note shows),
    finalized.  Returns (final events, stats); raises when a kernel was not
    launched exactly once a tile at B = 1 or a sampled poll differs from
    the cache-free one.  ``rt`` is a ready StreamingPolyTranscriber: its
    tiles run no pYIN, so they must launch neither kernel."""
    poly = rt is not None
    hop = rt.hop if poly else HOP
    if rt is None:
        rt = live_transcriber(dev, sr, tile, halo, financial)
    chunk = int(chunk_s * sr)
    n_polls = int(len(y) / sr / poll_s)
    sampled = {0, n_polls // 2, n_polls - 1}
    tile_ms, poll_ms, checked = [], [], []
    feed_s, next_poll, polls, first_event = 0.0, poll_s, 0, None
    reset_counts()
    for i in range(0, len(y), chunk):
        t0 = time.perf_counter()
        done = rt.feed(y[i:i + chunk])   # ends in the rows' device->host copy
        dt = time.perf_counter() - t0
        feed_s += dt
        tile_ms += [1e3 * dt / max(done, 1)] * done
        fed_s = min(i + chunk, len(y)) / sr
        due = fed_s >= next_poll
        if not due and first_event is not None:
            continue
        t0 = time.perf_counter()
        events = rt.poll_events()
        dt = time.perf_counter() - t0
        if events and first_event is None:
            # audio fed when a poll first shows a note, less its onset
            first_event = fed_s - min(e["start"] for e in events) * hop / sr
        if due:
            next_poll += poll_s
            poll_ms.append(1e3 * dt)
            if polls in sampled:
                if events != rt._poll_full():
                    raise AssertionError(
                        f"live: poll {polls} differs from _poll_full()")
                checked.append(polls)
            polls += 1
    t0 = time.perf_counter()
    final = rt.finalize()
    finalize_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = dict(pyin_cuda.LAUNCHES)
    tiles = len(rt._rows)
    per_tile = 0 if poly else 1
    for k in counts:
        if (counts[k] != per_tile * tiles
                or pyin_cuda.SEQUENCES[k] != per_tile * tiles):
            raise AssertionError(
                f"live: {k} launched {counts[k]} times with "
                f"{pyin_cuda.SEQUENCES[k]} sequences over {tiles} tiles")
    if len(checked) != len(sampled) or not final:
        raise AssertionError(f"live: polls checked {checked}, "
                             f"{len(final)} events")
    warm = sorted(tile_ms[1:])
    stats = {
        "sr": sr, "tile": tile, "halo": halo, "audio_s": len(y) / sr,
        "engine": "poly" if poly else "financial" if financial else "v1",
        "tiles": tiles,
        "launches": counts, "lookahead_s": rt.lookahead_s,
        "tile_wall_ms_median": warm[len(warm) // 2],
        "tile_wall_ms_p95": warm[int(0.95 * (len(warm) - 1))],
        "tile_wall_ms_first": tile_ms[0],
        "feed_s": feed_s, "ingest_margin": len(y) / sr / feed_s,
        "first_event_audio_s": first_event,
        "polls": polls, "polls_equal_to_poll_full": checked,
        "poll_ms_first": poll_ms[0], "poll_ms_last": poll_ms[-1],
        "poll_ms_median_last_quarter": float(np.median(
            poll_ms[-max(len(poll_ms) // 4, 1):])),
        "finalize_ms": finalize_ms, "events": len(final),
        "card": CARD["nvidia_smi"]}
    return final, stats


def tiled_events(dev, y, sr: int, tile: int, halo: int, financial: bool):
    """The tiled engine's events on the card at the same tile and halo."""
    out = tturbo.run_analyze_turbo(
        y, AudioConfig(sample_rate=sr), CFG,
        turbo=TurboConfig(tile_frames=tile, halo_frames=halo),
        fetch_mel=False, financial=financial, device=dev)
    if financial:
        return AegisFinancialEngine(sample_rate=sr,
                                    device=dev).extract_events(out)[0]
    return extract_events_v1(
        rake_mask=out["rake_mask"], f0=np.nan_to_num(out["f0"]),
        voiced_flag=out["voiced_flag"], active_probs=out["voiced_probs"],
        rms=out["rms"], sr=sr, hop_length=HOP, confidence_threshold=0.5,
        onset_env=out["onset_env"])


def phase_live(dev, tracks, y10, truth10, total: dict, per_call: dict) -> list:
    """Returns every session's stats for the times phase."""
    long_ = {22050: (y10, truth10)}
    sessions = [   # (track, rate, tile, halo, financial, also on the CPU)
        (tracks, 22050, 24, 8, False, True),
        (tracks, 44100, 24, 8, False, False),
        (tracks, 22050, 64, 32, False, False),
        (tracks, 44100, 64, 32, False, False),
        (tracks, 22050, 24, 8, True, True),
        (long_, 22050, 24, 8, False, False),
        (long_, 22050, 24, 8, True, False),
    ]
    all_stats = []
    for src, sr, tile, halo, financial, on_cpu in sessions:
        y, truth = src[sr]
        final, stats = live_session(dev, y, sr, tile, halo, financial)
        add_counts(total, stats["launches"])
        if not financial and src is tracks:
            per_call[("live", sr, tile, halo)] = stats["launches"]
        stats["f1_vs_tiled_engine"] = f1_of(
            secs(tiled_events(dev, y, sr, tile, halo, financial), sr),
            secs(final, sr))
        stats["truth_f1"] = f1_of(truth, secs(final, sr))
        stats["truth_notes"] = len(truth)
        gates = [stats["f1_vs_tiled_engine"], stats["truth_f1"]]
        if on_cpu:
            cpu = live_transcriber("cpu", sr, tile, halo, financial)
            cpu.feed(y)
            ev_cpu = cpu.finalize()
            stats["f1_vs_cpu_session"] = f1_of(secs(ev_cpu, sr),
                                               secs(final, sr))
            stats["events_equal_cpu_session"] = [
                (e["note"], e["start"], e["end"]) for e in final] == [
                (e["note"], e["start"], e["end"]) for e in ev_cpu]
            gates.append(stats["f1_vs_cpu_session"])
        emit({"phase": "live", **stats})
        if min(gates) < 0.99:
            raise AssertionError(f"live {stats['engine']} {sr} Hz "
                                 f"({tile}, {halo}): F1 {gates} below 0.99")
        all_stats.append(stats)
    return all_stats


def profile_kernels(fn, n: int = 1):
    """torch.profiler over ``n`` runs of fn() -> ({kernel name: [device us,
    launches]} summed over the n runs, host ms a run under the profiler).
    One more run comes first inside the profiler and is left out by its time
    stamps: a tracing session may lose its first few dozen device events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function("aegis.profiled_runs"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / n
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events if e.name == "aegis.profiled_runs"
                and e.device_type != cuda)
    kernels: dict = {}
    for e in events:
        if (e.device_type == cuda and not e.name.startswith("aegis.")
                and e.time_range.start >= mark.time_range.start):
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    return kernels, host_ms


def live_profile(dev, y, sr: int, tile: int, halo: int, financial: bool,
                 tile_wall_ms: float, n: int = 8, rt=None) -> dict:
    """Device-busy ms and launches a tile: torch.profiler over ``n`` warm
    tiles, each fed as exactly one tile's samples.  The idle share is taken
    against ``tile_wall_ms``, the session's median without the profiler
    (tracing every launch several times over slows the host)."""
    poly = rt is not None
    if rt is None:
        rt = live_transcriber(dev, sr, tile, halo, financial)
    tile_samp = rt._tile_samp
    pos = rt._ctx + 4 * tile_samp
    rt.feed(y[:pos])
    torch.cuda.synchronize()

    def one_tile():
        nonlocal pos
        if rt.feed(y[pos:pos + tile_samp]) != 1:
            raise AssertionError("live profile: a feed of one tile's "
                                 "samples did not run one tile")
        pos += tile_samp

    kernels, wall_ms = profile_kernels(one_tile, n)
    busy_ms = sum(us for us, _ in kernels.values()) / 1000.0 / n
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    return {"phase": "profile", "what": "live_tile", "sr": sr, "tile": tile,
            "halo": halo,
            "engine": "poly" if poly else "financial" if financial else "v1",
            "tiles_profiled": n, "wall_ms_a_tile_profiled": wall_ms,
            "device_busy_ms_a_tile": busy_ms,
            "kernel_launches_a_tile":
                sum(c for _, c in kernels.values()) / n,
            "tile_wall_ms_median_of_the_session": tile_wall_ms,
            "idle_share": 1.0 - busy_ms / tile_wall_ms,
            "top_device_kernels_ms_a_tile": [
                [name[:70], us / 1000.0 / n, c / n]
                for name, (us, c) in top],
            "card": CARD["nvidia_smi"]}


def phase_times_live(dev, tracks, live_shapes, all_stats) -> dict:
    wall = {}
    for stats in all_stats:
        emit({"phase": "times", "what": "live_session", **stats})
        if stats["audio_s"] == 60.0:
            wall[(stats["sr"], stats["tile"], stats["halo"],
                  stats["engine"] == "financial")] = stats["tile_wall_ms_median"]
    for key in ((22050, 24, 8, False), (22050, 24, 8, True),
                (44100, 24, 8, False), (22050, 64, 32, False)):
        emit(live_profile(dev, tracks[key[0]][0], *key, wall[key]))
    kernel_ms = {}
    for key, (obs, vprob, tables) in live_shapes.items():
        row = time_kernels(obs, vprob, tables, False)
        lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
        n, w = CFG.n_pitch_bins, tables.half_width
        # the cluster the wrapper picks beside one CTA a sequence, in turns
        picked = pyin_cuda.pick_forward_variant(1, N_SMS)
        turns = [cuda_ms(lambda v=v: forward_variant(lo_v, lo_u,
                                                     tables.band_tab, n, w, *v))
                 for v in (picked, (88, 1), (88, 1), picked)]
        row["viterbi_fwd_picked_onecta_onecta_picked"] = turns
        kernel_ms[key] = row
        emit({"phase": "times", "what": "viterbi_live", "sr": key[0],
              "tile": key[1], "halo": key[2], **row["shape"],
              "picked_variant": list(picked), "median_ms": row,
              "card": CARD["nvidia_smi"]})
    return kernel_ms


# --------------------------------------------------------------------------
# The polyphonic stack (no hand kernel: the poly paths are pYIN-free)
# --------------------------------------------------------------------------

def chord_track(seconds: float, sr: int, first_seed: int = 1):
    """A chord track of ``seconds``: chord progressions of successive seeds
    (tools.signal_gen.generate_chord_progression, 4.8 s each) joined, the
    truth of each shifted to its place; cut at ``seconds``, truth notes that
    start in the last quarter second dropped and the others' ends clipped."""
    n = int(round(seconds * sr))
    pieces, truth, pos, seed = [], [], 0, first_seed
    while pos < n:
        y, tr = generate_chord_progression(seed, sr)
        truth += [{"note": e["note"], "start": e["start"] + pos / sr,
                   "end": e["end"] + pos / sr} for e in tr]
        pieces.append(y)
        pos += len(y)
        seed += 1
    end = n / sr
    truth = [dict(e, end=min(e["end"], end)) for e in truth
             if e["start"] < end - 0.25]
    return np.concatenate(pieces)[:n], truth


# Truth F1 of the JAX package's AegisPolyEngine on the CPU (JAX_PLATFORMS=cpu)
# on the very tracks chord_track makes: analyze + extract_events with the
# engine's defaults (the 10-minute track with turbo_mode="auto", which sends
# it to the tiles, on a one-device mesh), scored by note_event_f1 against the
# joined truth.  The port on the card is gated at these less POLY_TRUTH_SLACK
# (one or two notes of a track may sit on a decision edge that the card's
# matmul order moves).
JAX_CPU_TRUTH_F1 = {("chord60", 22050): 1.0,                   # 152 of 152
                    ("chord60", 44100): 0.9868421052631579,    # 150 of 152
                    ("chord600", 22050): 0.9833776595744681}   # 1479 of 1500
POLY_TRUTH_SLACK = 0.01
POLY_GATING_SEEDS = ((22050, (1, 3, 7)), (44100, (7, 8, 10)))


def poly_window(sr: int):
    scale = max(1, round(sr / 22050))
    return 2048 * scale, 512 * scale


def note_tuples(events):
    return [(e["note"], e["start"], e["end"]) for e in events]


def viterbi_launches_zero(what: str) -> None:
    if any(pyin_cuda.LAUNCHES.values()):
        raise AssertionError(f"{what}: a poly path launched a Viterbi kernel "
                             f"{dict(pyin_cuda.LAUNCHES)}")


def phase_poly_parts(dev) -> None:
    """The device half on the card: the peel against the NumPy oracle on the
    CQT of a chord clip, the f16 packing against its host twin, the packed
    program against the same program on the CPU."""
    cpu = torch.device("cpu")
    for sr in (22050, 44100):
        n_fft, hop = poly_window(sr)
        y = generate_chord_progression(7, sr)[0]
        tb = poly_tables(sr, n_fft, 84, 12, 128, dev)
        power = tcqt.pseudo_cqt_t(torch.from_numpy(y).to(dev), hop, tb)
        bins, sals = tpoly.peel_voices(power, tb.supp, tb.sub)
        b_r, s_r = peel_voices_ref(power.cpu().numpy(), tb.supp.cpu().numpy(),
                                   tb.sub.cpu().numpy())
        bins, sals = bins.cpu().numpy(), sals.cpu().numpy()
        agree = float(np.mean(bins == b_r))
        same = (bins == b_r).all(axis=1)
        sal_ok = bool(np.allclose(sals[same], s_r[same], rtol=5e-4, atol=1e-4))
        first_diff = (int(np.argmin(same)) if not same.all() else None)

        mag = torch.sqrt(torch.clamp_min(power, 0.0))
        packed = tpoly.pack_cqt_f16(mag).cpu().numpy()
        twin = mag.cpu().numpy().astype(np.float16)
        bytes_ok = packed.tobytes() == twin.tobytes()
        back_ok = bool(np.array_equal(tpoly.unpack_cqt_f16(packed, 84),
                                      twin.astype(np.float32)))

        bufs = [fetch_packed(dispatch_analyze_poly(
            y, sr, n_fft, hop, device=d)) for d in (dev, cpu)]
        V = 6
        prog_bins = float(np.mean(bufs[0][:, :V] == bufs[1][:, :V]))
        rows = (bufs[0][:, :V] == bufs[1][:, :V]).all(axis=1)
        prog_ok = bool(
            np.allclose(bufs[0][rows, V:2 * V], bufs[1][rows, V:2 * V],
                        rtol=5e-4, atol=1e-4)
            and np.allclose(bufs[0][:, 2 * V], bufs[1][:, 2 * V], atol=1e-6)
            and np.allclose(bufs[0][:, 2 * V + 1], bufs[1][:, 2 * V + 1],
                            atol=2e-3)
            and np.allclose(tpoly.unpack_cqt_f16(bufs[0][:, 2 * V + 2:], 84),
                            tpoly.unpack_cqt_f16(bufs[1][:, 2 * V + 2:], 84),
                            rtol=2e-3, atol=1e-4))
        emit({"phase": "poly_parts", "sr": sr, "frames": int(bins.shape[0]),
              "peel_pick_agreement_vs_oracle": agree,
              "peel_first_differing_frame": first_diff,
              "peel_saliences_within_rtol_5e-4": sal_ok,
              "pack_bytes_equal_host_twin": bytes_ok,
              "unpack_roundtrip": back_ok,
              "packed_program_bins_agreement_vs_cpu": prog_bins,
              "packed_program_rows_within_tolerance": prog_ok})
        if agree < 0.999 or not sal_ok:
            raise AssertionError(f"poly_parts {sr}: peel differs from the "
                                 f"oracle (picks {agree})")
        if not (bytes_ok and back_ok):
            raise AssertionError(f"poly_parts {sr}: pack_cqt_f16 differs from "
                                 "its host twin")
        if prog_bins < 0.999 or not prog_ok:
            raise AssertionError(f"poly_parts {sr}: the packed program on the "
                                 "card differs from the CPU's")


def fetch_packed(handle) -> np.ndarray:
    buf, true_frames = handle[0], handle[1]
    return buf[:true_frames].cpu().numpy()


def poly_f1(eng, ref_events, events) -> float:
    return f1_of(events_to_seconds(ref_events, eng.sr, eng.hop_length),
                 events_to_seconds(events, eng.sr, eng.hop_length))


def phase_poly(dev, chord_tracks) -> None:
    """The truth gate on the six gating seeds, card against CPU; then the
    60 s chord tracks at both rates and the 10-minute one: fused against
    tiles, truth F1 against the JAX engine's on the CPU."""
    reset_counts()
    for sr, seeds in POLY_GATING_SEEDS:
        eng = AegisPolyEngine(sample_rate=sr, device=dev)
        cpu = AegisPolyEngine(sample_rate=sr, device="cpu")
        for seed in seeds:
            y, truth = generate_chord_progression(seed, sr)
            buf = io.BytesIO()
            analysis = eng.analyze(y)
            events = eng.extract_events(analysis, buf)
            ev_cpu = cpu.extract_events(cpu.analyze(y))
            T = 1 + len(y) // eng.hop_length
            if (analysis["roll"].shape != (T, 128)
                    or analysis["cqt_mag"].shape != (T, 84)
                    or not np.isfinite(analysis["rms"]).all()
                    or not buf.getvalue().startswith(b"MThd")):
                raise AssertionError(f"poly seed {seed} @ {sr}: bad analysis "
                                     "or no MIDI")
            row = {"phase": "poly", "clip": f"chord_progression_s{seed}",
                   "sr": sr, "events": len(events),
                   "truth_notes": len(truth),
                   "truth_f1": f1_of(truth, events_to_seconds(
                       events, sr, eng.hop_length)),
                   "f1_vs_cpu": poly_f1(eng, ev_cpu, events),
                   "notes_equal_cpu": note_tuples(events) == note_tuples(ev_cpu),
                   "events_equal_cpu": events == ev_cpu}
            emit(row)
            if min(row["truth_f1"], row["f1_vs_cpu"]) < 0.99:
                raise AssertionError(f"poly seed {seed} @ {sr}: {row}")

    for (name, sr), (y, truth) in chord_tracks.items():
        eng = AegisPolyEngine(sample_rate=sr, device=dev)
        fused = eng.extract_events(eng.analyze(y))
        tiles = eng.extract_events(eng.analyze(y, turbo_mode="tiles"))
        auto = eng.extract_events(eng.analyze(y, turbo_mode="auto"))
        want_auto = tiles if len(y) / sr > 240.0 else fused
        row = {"phase": "poly", "clip": name, "sr": sr,
               "seconds": len(y) / sr, "truth_notes": len(truth),
               "fused_events": len(fused), "tiles_events": len(tiles),
               "tiles_f1_vs_fused": poly_f1(eng, fused, tiles),
               "auto_is": "tiles" if want_auto is tiles else "fused",
               "auto_equals_that_path": note_tuples(auto) == note_tuples(want_auto),
               "fused_truth_f1": f1_of(truth, events_to_seconds(
                   fused, sr, eng.hop_length)),
               "tiles_truth_f1": f1_of(truth, events_to_seconds(
                   tiles, sr, eng.hop_length)),
               "jax_cpu_truth_f1": JAX_CPU_TRUTH_F1[(name, sr)],
               "card": CARD["nvidia_smi"]}
        emit(row)
        gate = JAX_CPU_TRUTH_F1[(name, sr)] - POLY_TRUTH_SLACK
        if row["tiles_f1_vs_fused"] < 0.99 or not row["auto_equals_that_path"]:
            raise AssertionError(f"poly {name} @ {sr}: tiles against fused "
                                 f"{row}")
        if min(row["fused_truth_f1"], row["tiles_truth_f1"]) < gate:
            raise AssertionError(f"poly {name} @ {sr}: truth F1 below the JAX "
                                 f"engine's {gate}: {row}")
    viterbi_launches_zero("poly")


def phase_poly_folder(dev, folder: str, ys: list) -> None:
    """Four 60 s chord WAVs through the folder sweep: MIDI bytes equal to
    the facade's, and the dispatch half queues every track without a
    synchronizing call."""
    reset_counts()
    out_dir = os.path.join(folder, "mid_poly")
    results = transcribe_folder(folder, out_dir, engine="poly", device=dev)
    eng = AegisPolyEngine(sample_rate=22050, device=dev)
    same = []
    for wav, mid, n in results:
        ref = io.BytesIO()
        n_ref = len(eng.extract_events(eng.analyze(wav), ref))
        same.append(n == n_ref and open(mid, "rb").read() == ref.getvalue())
    handles, msgs = sync_warnings_of(lambda: [dispatch_analyze_poly(
        y, 22050, device=dev) for y in ys])
    frames = [fetch_analyze_poly(h)["roll"].shape[0] for h in handles]
    emit({"phase": "poly_folder", "tracks": len(results),
          "events": [n for _, _, n in results], "equal_to_facade": same,
          "dispatch_sync_calls": len(msgs), "first": msgs[:3],
          "frames": frames})
    if not all(same) or len(results) != len(ys):
        raise AssertionError("poly folder: differs from the facade")
    if msgs:
        raise AssertionError(f"poly folder: dispatch_analyze_poly made "
                             f"{len(msgs)} synchronizing calls: {msgs[:3]}")
    viterbi_launches_zero("poly_folder")


def phase_poly_live(dev, chord_tracks) -> list:
    """StreamingPolyTranscriber at tile 24 / halo 8 on every chord track,
    0.5 s chunks, polled every 2 s: sampled polls equal to _poll_full(),
    finalize() against the offline engine on the card."""
    all_stats = []
    for (name, sr), (y, truth) in chord_tracks.items():
        rt = StreamingPolyTranscriber(sample_rate=sr, tile_frames=24,
                                      halo_frames=8, device=dev)
        final, stats = live_session(dev, y, sr, 24, 8, False, rt=rt)
        eng = AegisPolyEngine(sample_rate=sr, device=dev)
        mode = "tiles" if name == "chord600" else False
        offline = eng.extract_events(eng.analyze(y, turbo_mode=mode))
        stats["track"] = name
        stats["f1_vs_offline_engine"] = poly_f1(eng, offline, final)
        stats["notes_equal_offline_engine"] = \
            note_tuples(final) == note_tuples(offline)
        stats["truth_f1"] = f1_of(truth, events_to_seconds(
            final, sr, eng.hop_length))
        stats["truth_notes"] = len(truth)
        emit({"phase": "poly_live", **stats})
        if stats["f1_vs_offline_engine"] < 0.99:
            raise AssertionError(f"poly_live {name} @ {sr}: finalize() F1 "
                                 f"{stats['f1_vs_offline_engine']} against "
                                 "the offline engine")
        all_stats.append(stats)
    return all_stats


def wall_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` host-clock runs of fn() (host code)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_times_poly(dev, chord_tracks, folder: str, live_stats) -> None:
    """Warm medians of 5, beside the card's name and power limit: analyze
    and audio_to_midi fused and tiled on each chord track, the device
    program apart from the host extraction, the folder, the live sessions;
    a torch.profiler pass over one fused 60 s analyze."""
    for (name, sr), (y, _) in chord_tracks.items():
        eng = AegisPolyEngine(sample_rate=sr, device=dev)
        audio_s = len(y) / sr
        for mode in (False, "tiles"):
            label = "tiles" if mode else "fused"
            analysis = eng.analyze(y, turbo_mode=mode)
            row = {
                "analyze_ms": cuda_ms(
                    lambda: eng.analyze(y, turbo_mode=mode)),
                "audio_to_midi_ms": cuda_ms(
                    lambda: eng.audio_to_midi(y, io.BytesIO(),
                                              turbo_mode=mode)),
                "extract_events_host_ms": wall_ms(
                    lambda: eng.extract_events(analysis)),
            }
            if not mode:
                n_fft, hop = poly_window(sr)
                row["device_program_ms"] = cuda_ms(lambda: fetch_packed(
                    dispatch_analyze_poly(y, sr, n_fft, hop, device=dev)))
            emit({"phase": "times", "what": f"poly_{label}", "track": name,
                  "sr": sr, "audio_s": audio_s, "median_ms": row,
                  "realtime_factor": audio_s / (row["audio_to_midi_ms"] / 1e3),
                  "card": CARD["nvidia_smi"]})
    ms = cuda_ms(lambda: transcribe_folder(
        folder, os.path.join(folder, "t_poly"), engine="poly", device=dev))
    emit({"phase": "times", "what": "folder_poly_4x60s", "median_ms": ms,
          "audio_s": 240.0, "realtime_factor": 240.0 / (ms / 1e3),
          "card": CARD["nvidia_smi"]})
    for stats in live_stats:
        emit({"phase": "times", "what": "poly_live_session", **stats})
        if stats["track"] == "chord60":
            sr = stats["sr"]
            emit(live_profile(
                dev, chord_tracks[("chord60", sr)][0], sr, 24, 8, False,
                stats["tile_wall_ms_median"],
                rt=StreamingPolyTranscriber(sample_rate=sr, tile_frames=24,
                                            halo_frames=8, device=dev)))

    (y, _), sr = chord_tracks[("chord60", 22050)], 22050
    eng = AegisPolyEngine(sample_rate=sr, device=dev)
    emit(profile_row("poly_fused_60s_analyze", lambda: eng.analyze(y), sr))


# --------------------------------------------------------------------------
# The auto router (pYIN + the peel in one program) and the neural backend
# --------------------------------------------------------------------------

# Truth F1 of the JAX package's engines on the CPU (JAX_PLATFORMS=cpu) on the
# very clips and tracks these phases make, with the engines' defaults
# (AegisAutoEngine: analyze + extract_events; the neural v1 engine:
# audio_to_midi(pitch_backend="neural") + extract_events at confidence 0.3,
# the 10-minute track with turbo_mode="stream"; the neural financial engine:
# analyze + extract_events), scored by note_event_f1 against the clip's
# truth.  The port on the card is gated at these less TRUTH_SLACK.
JAX_CPU_AUTO_TRUTH_F1 = {("mixed1", 22050): 0.9803921568627451,   # 26 events, 25 notes
                         ("mixed2", 22050): 1.0,                  # 25 of 25
                         ("mixed3", 22050): 0.92,                 # 25, 25
                         ("chord3", 22050): 1.0,                  # 12 of 12
                         ("mixed1", 44100): 1.0,                  # 25 of 25
                         ("chord3", 44100): 1.0,                  # 12 of 12
                         ("bench60", 22050): 0.9967213114754099,  # 153, 152
                         ("bench60", 44100): 0.9900332225913622}  # 151, 150
JAX_CPU_NEURAL_TRUTH_F1 = {("bench60", 22050): 1.0,                 # 152 of 152
                           ("bench60", 44100): 0.8996763754045306,  # 159, 150
                           ("bench600", 22050): 0.9842122942559623,  # 1496, 1481
                           ("financial60", 22050): 0.9706840390879479}  # 155, 152
TRUTH_SLACK = 0.01


def auto_clips(tracks):
    """(name, sr, y, truth) of the auto phase: the mixed and chord clips,
    then the 60 s bench track at both rates."""
    clips = [(f"mixed{s}", 22050, *generate_mixed_clip(s)) for s in (1, 2, 3)]
    clips += [("chord3", 22050, *generate_chord_progression(3, 22050)),
              ("mixed1", 44100, *generate_mixed_clip(1, sr=44100)),
              ("chord3", 44100, *generate_chord_progression(3, 44100))]
    clips += [("bench60", sr, *tracks[sr]) for sr in (22050, 44100)]
    return clips


def phase_auto(dev, tracks, folder: str, errs, total: dict,
               per_call: dict) -> dict:
    """AegisAutoEngine on the card: one launch of each Viterbi kernel a
    call at B = 1, F1 >= 0.99 against the same engine on the CPU, truth F1
    at the JAX engine's own; both kernels against their plain versions on
    the router's observations of the 60 s tracks (44 100 Hz: hop 1024); the
    folder sweep against the facade, its dispatch half without a
    synchronizing call.  Returns the 44 100 Hz observations."""
    engines = {sr: (AegisAutoEngine(sample_rate=sr, device=dev),
                    AegisAutoEngine(sample_rate=sr, device="cpu"))
               for sr in (22050, 44100)}
    for name, sr, y, truth in auto_clips(tracks):
        eng, cpu = engines[sr]
        a, counts, batch = run_counted(lambda: eng.analyze(y))
        expect_launches(f"auto {name} {sr}", counts, batch, 1, 1)
        add_counts(total, counts)
        if name == "bench60":
            per_call[f"auto60_{sr}"] = counts
        buf = io.BytesIO()
        events = eng.extract_events(a, buf)
        ev_cpu = cpu.extract_events(cpu.analyze(y))
        T = 1 + len(y) // eng.hop_length
        if (a["v1"]["f0"].shape != (T,) or a["poly"]["roll"].shape != (T, 128)
                or not np.isfinite(a["v1"]["rms"]).all()
                or not buf.getvalue().startswith(b"MThd")):
            raise AssertionError(f"auto {name} @ {sr}: bad analysis or no MIDI")
        row = {"phase": "auto", "clip": name, "sr": sr,
               "seconds": len(y) / sr, "events": len(events),
               "sources": sorted({e["source"] for e in events}),
               "truth_notes": len(truth),
               "truth_f1": f1_of(truth, events_to_seconds(
                   events, sr, eng.hop_length)),
               "jax_cpu_truth_f1": JAX_CPU_AUTO_TRUTH_F1[(name, sr)],
               "f1_vs_cpu": poly_f1(eng, ev_cpu, events),
               "notes_equal_cpu": note_tuples(events) == note_tuples(ev_cpu)}
        emit(row)
        if row["f1_vs_cpu"] < 0.99:
            raise AssertionError(f"auto {name} @ {sr}: F1 vs CPU {row}")
        if row["truth_f1"] < row["jax_cpu_truth_f1"] - TRUTH_SLACK:
            raise AssertionError(f"auto {name} @ {sr}: truth F1 below the "
                                 f"JAX engine's: {row}")

    shapes = {}
    for sr, (y, _) in tracks.items():
        obs, vprob, tables = real_obs(y, sr, dev, engines[sr][0].hop_length)
        lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
        compare_kernels(f"auto60_{sr}", lo_v, lo_u, tables.band,
                        tables.band_tab, tables.half_width, 1.0, errs)
        shapes[sr] = (obs, vprob, tables)

    eng = engines[22050][0]
    results, counts, batch = run_counted(lambda: transcribe_folder(
        folder, os.path.join(folder, "mid_auto"), engine="auto", device=dev))
    expect_launches("auto folder", counts, batch, len(results), 1)
    add_counts(total, counts)
    same = []
    for wav, mid, n in results:
        ref = io.BytesIO()
        n_ref = len(eng.extract_events(eng.analyze(wav), ref))
        same.append(n == n_ref and open(mid, "rb").read() == ref.getvalue())
    ys = [eng.analyze(wav)["y"] for wav, _, _ in results]
    handles, msgs = sync_warnings_of(lambda: [dispatch_analyze_auto(
        y, eng, device=dev) for y in ys])
    for h in handles:
        fetch_analyze_auto(h, eng)
    emit({"phase": "auto_folder", "tracks": len(results),
          "events": [n for _, _, n in results], "equal_to_facade": same,
          "dispatch_sync_calls": len(msgs), "first": msgs[:3]})
    if not all(same) or len(results) != 4:
        raise AssertionError("auto folder: differs from the facade")
    if msgs:
        raise AssertionError(f"auto folder: dispatch_analyze_auto made "
                             f"{len(msgs)} synchronizing calls: {msgs[:3]}")
    return shapes[44100]


def neural_events(eng, raw):
    return eng.extract_events(raw, None, confidence_threshold=0.3)


def phase_neural(dev, tracks, y10, truth10, folder: str) -> None:
    """AegisEngine(pitch_backend="neural") on the card, fused at both rates
    on 60 s and streamed on 10 minutes; the financial engine neural on 60
    s; the neural folder.  No Viterbi launch anywhere; F1 >= 0.99 against
    the same engine on the CPU; truth F1 at the JAX engine's own; the
    streamed rows equal the fused rows at the int16 transport; folder MIDI
    equal to the facade's."""
    reset_counts()
    for sr, (y, truth) in tracks.items():
        eng = AegisEngine(sample_rate=sr, device=dev)
        cpu = AegisEngine(sample_rate=sr, device="cpu")
        raw = eng.audio_to_midi(y, pitch_backend="neural")
        events = neural_events(eng, raw)
        ev_cpu = neural_events(cpu, cpu.audio_to_midi(
            y, pitch_backend="neural"))
        row = {"phase": "neural", "mode": "fused", "clip": "bench60",
               "sr": sr, "events": len(events), "truth_notes": len(truth),
               "truth_f1": f1_of(truth, secs(events, sr)),
               "jax_cpu_truth_f1": JAX_CPU_NEURAL_TRUTH_F1[("bench60", sr)],
               "f1_vs_cpu": f1_of(secs(ev_cpu, sr), secs(events, sr)),
               "notes_equal_cpu": note_tuples(events) == note_tuples(ev_cpu)}
        emit(row)
        neural_gates(row)

    eng = AegisEngine(sample_rate=22050, device=dev)
    raw = eng.audio_to_midi(y10, pitch_backend="neural", turbo_mode="stream")
    events = neural_events(eng, raw)
    cpu = AegisEngine(sample_rate=22050, device="cpu")
    ev_cpu = neural_events(cpu, cpu.audio_to_midi(
        y10, pitch_backend="neural", turbo_mode="stream"))
    streamed = run_analyze_neural_streamed(y10, 22050, 512, device=dev)
    fused = run_analyze_neural(y10, 22050, 512, fetch_mel=False,
                               transport="int16", device=dev)
    discrete_equal = {k: bool(np.array_equal(streamed[k], fused[k]))
                      for k in ("voiced_flag", "rake_mask")}
    within = {k: bool(np.allclose(np.nan_to_num(streamed[k]),
                                  np.nan_to_num(fused[k]),
                                  rtol=1e-5, atol=1e-6))
              for k in ("f0", "voiced_probs", "rms", "onset_env")}
    row = {"phase": "neural", "mode": "stream", "clip": "bench600",
           "sr": 22050, "events": len(events), "truth_notes": len(truth10),
           "truth_f1": f1_of(truth10, secs(events, 22050)),
           "jax_cpu_truth_f1": JAX_CPU_NEURAL_TRUTH_F1[("bench600", 22050)],
           "f1_vs_cpu": f1_of(secs(ev_cpu, 22050), secs(events, 22050)),
           "stream_discrete_rows_equal_fused_int16": discrete_equal,
           "stream_float_rows_within_rtol_1e-5_atol_1e-6": within,
           "stream_rows_bit_identical": {
               k: bool(np.array_equal(streamed[k], fused[k], equal_nan=True))
               for k in ("f0", "voiced_probs", "rms", "onset_env")}}
    emit(row)
    neural_gates(row)
    if not (all(discrete_equal.values()) and all(within.values())):
        raise AssertionError(f"neural stream: rows differ from the fused "
                             f"program at int16: {row}")

    y, truth = tracks[22050]
    fin = AegisFinancialEngine(sample_rate=22050, device=dev)
    fcpu = AegisFinancialEngine(sample_rate=22050, device="cpu")
    fev, _ = fin.extract_events(fin.analyze(y, pitch_backend="neural"))
    fev_cpu, _ = fcpu.extract_events(fcpu.analyze(y, pitch_backend="neural"))
    row = {"phase": "neural", "mode": "financial", "clip": "bench60",
           "sr": 22050, "events": len(fev), "truth_notes": len(truth),
           "truth_f1": f1_of(truth, secs(fev, 22050)),
           "jax_cpu_truth_f1": JAX_CPU_NEURAL_TRUTH_F1[("financial60",
                                                        22050)],
           "f1_vs_cpu": f1_of(secs(fev_cpu, 22050), secs(fev, 22050))}
    emit(row)
    neural_gates(row)

    results = transcribe_folder(folder, os.path.join(folder, "mid_neural"),
                                pitch_backend="neural", device=dev)
    eng = AegisEngine(sample_rate=22050, device=dev)
    same = []
    for wav, mid, n in results:
        ref = io.BytesIO()
        n_ref = len(eng.extract_events(
            eng.audio_to_midi(wav, pitch_backend="neural", fetch_mel=False),
            ref))
        same.append(n == n_ref and open(mid, "rb").read() == ref.getvalue())
    emit({"phase": "neural_folder", "tracks": len(results),
          "events": [n for _, _, n in results], "equal_to_facade": same})
    if not all(same) or len(results) != 4:
        raise AssertionError("neural folder: differs from the facade")
    if any(pyin_cuda.LAUNCHES.values()):
        raise AssertionError(f"neural: a neural path launched a Viterbi "
                             f"kernel {dict(pyin_cuda.LAUNCHES)}")


def neural_gates(row: dict) -> None:
    if row["f1_vs_cpu"] < 0.99:
        raise AssertionError(f"neural: F1 vs CPU below 0.99: {row}")
    if row["truth_f1"] < row["jax_cpu_truth_f1"] - TRUTH_SLACK:
        raise AssertionError(f"neural: truth F1 below the JAX engine's: "
                             f"{row}")


def profile_row(what: str, fn, sr: int) -> dict:
    """torch.profiler over one run of fn() beside its warm median: device
    busy ms, launches, idle share."""
    warm = cuda_ms(fn)
    kernels, profiled_ms = profile_kernels(fn)
    busy_ms = sum(us for us, _ in kernels.values()) / 1000.0
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {"phase": "profile", "what": what, "sr": sr,
            "wall_ms_profiled": profiled_ms, "warm_median_ms": warm,
            "device_busy_ms": busy_ms,
            "kernel_launches": sum(c for _, c in kernels.values()),
            "idle_share_of_warm_median": 1.0 - busy_ms / warm,
            "top_device_kernels": [[name[:70], us / 1000.0, c]
                                   for name, (us, c) in top],
            "card": CARD["nvidia_smi"]}


def phase_times_auto_neural(dev, tracks, y10, auto_folder: str,
                            neural_folder: str, auto_obs) -> dict:
    """Warm medians of 5 (CUDA events), beside the card's name and power
    limit: the auto router's analyze and audio_to_midi at 60 s at both
    rates (extract_events apart, host clock), the auto folder, the neural
    engine fused at both rates, streamed on 10 minutes, its folder; a
    torch.profiler pass over a fused auto and a fused neural analyze; the
    kernels at the router's 44 100 Hz shape.  Returns that kernel row."""
    for sr, (y, _) in tracks.items():
        eng = AegisAutoEngine(sample_rate=sr, device=dev)
        analysis = eng.analyze(y)
        row = {"analyze_ms": cuda_ms(lambda: eng.analyze(y)),
               "audio_to_midi_ms": cuda_ms(
                   lambda: eng.audio_to_midi(y, io.BytesIO())),
               "extract_events_host_ms": wall_ms(
                   lambda: eng.extract_events(analysis))}
        emit({"phase": "times", "what": "auto_fused", "sr": sr,
              "audio_s": len(y) / sr, "median_ms": row,
              "realtime_factor": len(y) / sr / (row["audio_to_midi_ms"] / 1e3),
              "card": CARD["nvidia_smi"]})
    ms = cuda_ms(lambda: transcribe_folder(
        auto_folder, os.path.join(auto_folder, "t_auto"), engine="auto",
        device=dev))
    emit({"phase": "times", "what": "folder_auto_4_clips", "median_ms": ms,
          "card": CARD["nvidia_smi"]})
    for sr, (y, _) in tracks.items():
        eng = AegisEngine(sample_rate=sr, device=dev)
        row = {"analyze_ms": cuda_ms(
                   lambda: eng.audio_to_midi(y, pitch_backend="neural")),
               "audio_to_midi_ms": cuda_ms(
                   lambda: eng.audio_to_midi(y, io.BytesIO(),
                                             pitch_backend="neural"))}
        emit({"phase": "times", "what": "neural_fused", "sr": sr,
              "audio_s": len(y) / sr, "median_ms": row,
              "realtime_factor": len(y) / sr / (row["audio_to_midi_ms"] / 1e3),
              "card": CARD["nvidia_smi"]})
    eng = AegisEngine(sample_rate=22050, device=dev)
    ms = cuda_ms(lambda: eng.audio_to_midi(y10, pitch_backend="neural",
                                           turbo_mode="stream"))
    emit({"phase": "times", "what": "neural_stream_600s", "median_ms": ms,
          "audio_s": len(y10) / 22050,
          "realtime_factor": len(y10) / 22050 / (ms / 1e3),
          "card": CARD["nvidia_smi"]})
    ms = cuda_ms(lambda: transcribe_folder(
        neural_folder, os.path.join(neural_folder, "t_neural"),
        pitch_backend="neural", device=dev))
    emit({"phase": "times", "what": "folder_neural_4x60s", "median_ms": ms,
          "audio_s": 240.0, "realtime_factor": 240.0 / (ms / 1e3),
          "card": CARD["nvidia_smi"]})

    y, _ = tracks[22050]
    aeng = AegisAutoEngine(sample_rate=22050, device=dev)
    emit(profile_row("auto_fused_60s_analyze", lambda: aeng.analyze(y), 22050))
    emit(profile_row("neural_fused_60s_analyze", lambda: eng.audio_to_midi(
        y, pitch_backend="neural"), 22050))

    obs, vprob, tables = auto_obs
    row = time_kernels(obs[None], vprob[None], tables, False)
    emit({"phase": "times", "what": "viterbi_auto", "sr": 44100, "hop": 1024,
          **row["shape"], "median_ms": row, "card": CARD["nvidia_smi"]})
    return row


# --------------------------------------------------------------------------
# HPSS stems, the ADSR synth and effect chain, the verification loops
# --------------------------------------------------------------------------

def notes_midi(notes) -> bytes:
    """SMF bytes of a note list [{note, start, end}] in seconds (velocity
    100, the default 120 BPM / 480 ticks a beat), note-offs before note-ons
    on the same tick."""
    mid = MidiFile()
    track = MidiTrack()
    mid.tracks.append(track)
    marks = sorted([(int(round(second2tick(n["start"]))), 1, n["note"])
                    for n in notes]
                   + [(int(round(second2tick(n["end"]))), 0, n["note"])
                      for n in notes])
    last = 0
    for tick, on, note in marks:
        track.append(MidiMessage("note_on" if on else "note_off", note=note,
                                 velocity=100 if on else 0, time=tick - last))
        last = tick
    return mid.save(None)


# The JAX package's v1 engine on the CPU (JAX_PLATFORMS=cpu), 44 100 Hz:
# reverse_analysis of notes_midi(the 60 s bench track's truth) with the
# FluidSynth binary missing (the ADSR synth renders), and learning_loop on
# the same MIDI with preset "full_fx" (5 iterations, seed 0).  The port on
# the card must reach this note accuracy.
JAX_CPU_REVERSE = {"original_notes": 150, "reversed_notes": 143,
                   "note_accuracy": 0.92}
JAX_CPU_LOOP_BEST_OVERALL = 0.9083166666666667
# A CPU twin of a loop that would take more than about a minute at 60 s runs
# on the track's first CPU_TWIN_S seconds, beside the card's run of the same
# cut (the card's 60 s run is timed apart).
CPU_TWIN_S = 15.0


def stem_err(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def phase_hpss(dev, tracks, y10, folder: str) -> None:
    """HPSS on the card at the bench lengths: 60 s at 22 050 Hz (one
    program), 60 s at 44 100 Hz (two slabs), 10 minutes at 22 050 Hz (seven
    slabs); each within 1e-4 of the port's CPU run, the 60 s 22 050 Hz one
    also of the float64 oracle; AegisEngine.separate_stems and the stems
    command write the two stems; warm medians of 5 of each size; a
    torch.profiler pass over the 60 s call."""
    from aegis_tpu_torch.core import hpss as H
    from aegis_tpu_torch.core.analyze import quantize_pcm16
    from aegis_tpu_torch.ref.hpss_ref import hpss_ref

    halo = 8 * HOP + 2 * 2048
    step = ((H._SLAB_SAMPLES - 2 * halo) // HOP) * HOP
    cases = [("bench60", 22050, tracks[22050][0], 1),
             ("bench60", 44100, tracks[44100][0], 2),
             ("bench600", 22050, y10, 7)]
    for name, sr, y, want_slabs in cases:
        slabs = 1 if len(y) <= H._SLAB_SAMPLES else -(-len(y) // step)
        card = H.hpss(y, device=dev)
        cpu = H.hpss(y, device="cpu")
        row = {"phase": "hpss", "track": name, "sr": sr,
               "samples": len(y), "slabs": slabs,
               "frames": 1 + len(y) // HOP,
               "max_abs_err_vs_cpu": stem_err(card, cpu),
               "finite": bool(all(np.isfinite(s).all() for s in card))}
        if name == "bench60" and sr == 22050:
            y16, scale = quantize_pcm16(y)
            row["max_abs_err_vs_oracle"] = stem_err(
                card, hpss_ref(y16.astype(np.float32) * scale))
        row["median_ms"] = cuda_ms(lambda: H.hpss(y, device=dev))
        row["card"] = CARD["nvidia_smi"]
        emit(row)
        if (slabs != want_slabs or not row["finite"]
                or any(s.shape != y.shape for s in card)):
            raise AssertionError(f"hpss {name} @ {sr}: {row}")
        if max(row["max_abs_err_vs_cpu"],
               row.get("max_abs_err_vs_oracle", 0.0)) > 1e-4:
            raise AssertionError(f"hpss {name} @ {sr}: above 1e-4: {row}")

    y = tracks[22050][0]
    emit(profile_row("hpss_60s_22050", lambda: H.hpss(y, device=dev), 22050))

    wav = os.path.join(folder, "bench60.wav")
    write_wav(wav, y, 22050)
    eng = AegisEngine(sample_rate=22050, device=dev)
    paths = {"separate_stems": eng.separate_stems(wav, os.path.join(folder,
                                                                    "eng"))}
    proc = subprocess.run(
        [sys.executable, "-m", "aegis_tpu_torch", "stems", wav,
         os.path.join(folder, "cli"), "--method", "hpss"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    paths["stems_command"] = proc.stdout.strip().splitlines()[-1] \
        if proc.stdout.strip() else ""
    row = {"phase": "hpss_stems", "stems_command_rc": proc.returncode}
    for how, path in paths.items():
        stems = [os.path.join(os.path.dirname(path), f)
                 for f in ("other.wav", "drums.wav")]
        row[how] = {"other": path, "written": [os.path.isfile(p)
                                               for p in stems]}
    emit(row)
    if proc.returncode != 0 or not all(
            all(row[how]["written"]) and row[how]["other"].endswith(
                "other.wav") for how in paths):
        raise AssertionError(f"hpss stems: {row} {proc.stderr[-2000:]}")


def phase_synth(dev, midi: bytes) -> np.ndarray:
    """The 60 s bench track's MIDI through synthesize_midi_adsr at 44 100 Hz
    on the card against the CPU (WAV within one int16 step; the float render
    within 1e-5, the envelope segment lengths equal), then every effect
    preset on that render against the CPU (1e-4); times of each.  Returns
    the card's float render."""
    from aegis_tpu_torch.synth import adsr
    from aegis_tpu_torch.synth.effects import (EFFECT_PRESETS,
                                               apply_effect_chain)
    from aegis_tpu_torch.io import read_wav

    sr = 44100
    notes = midi_to_notes(midi)
    p = adsr.GUITAR_ADSR_PRESETS["electric_clean"]
    kw = dict(attack_ms=p["attack_ms"], decay_ms=p["decay_ms"],
              sustain_level=p["sustain_level"], release_ms=p["release_ms"],
              waveform=p["waveform"])
    wavs = {d: adsr.synthesize_midi_adsr(midi, sample_rate=sr, device=d)
            for d in (dev, "cpu")}
    (a, ra), (b, rb) = (read_wav(w) for w in wavs.values())
    x = adsr.synthesize_note_arrays(notes, sr, device=dev, **kw)
    x_cpu = adsr.synthesize_note_arrays(notes, sr, device="cpu", **kw)
    ms = np.linspace(0.5, 1000.0, 20001, dtype=np.float32)
    seg_equal = all(
        torch.equal(s.cpu(), c) for s, c in zip(
            adsr.segment_lengths(*(torch.from_numpy(ms).to(dev),) * 3, sr),
            adsr.segment_lengths(*(torch.from_numpy(ms),) * 3, sr)))
    row = {"phase": "synth", "notes": len(notes), "sr": sr,
           "seconds": len(x) / sr, "wav_rates": [ra, rb],
           "wav_max_abs_err_vs_cpu": float(np.abs(a - b).max()),
           "render_max_abs_err_vs_cpu": float(np.abs(x - x_cpu).max()),
           "segment_lengths_equal_cpu": seg_equal,
           "synthesize_midi_adsr_ms": cuda_ms(lambda: adsr.synthesize_midi_adsr(
               midi, sample_rate=sr, device=dev)),
           "card": CARD["nvidia_smi"]}
    emit(row)
    if (row["wav_max_abs_err_vs_cpu"] > 1.0 / 32767 + 1e-9
            or row["render_max_abs_err_vs_cpu"] > 1e-5 or not seg_equal
            or ra != sr or not np.isfinite(x).all()):
        raise AssertionError(f"synth: {row}")
    for preset, cfg in EFFECT_PRESETS.items():
        got = apply_effect_chain(x, cfg, sr, device=dev)
        want = apply_effect_chain(x, cfg, sr, device="cpu")
        row = {"phase": "effects", "preset": preset,
               "effects": [name for name, _ in cfg],
               "max_abs_err_vs_cpu": float(np.abs(got - want).max()),
               "median_ms": cuda_ms(lambda: apply_effect_chain(
                   x, cfg, sr, device=dev)),
               "card": CARD["nvidia_smi"]}
        emit(row)
        if got.shape != x.shape or row["max_abs_err_vs_cpu"] > 1e-4:
            raise AssertionError(f"effects {preset}: {row}")
    return x


def phase_verify(dev, tracks, midi: bytes, errs: dict, total: dict,
                 per_call: dict) -> dict:
    """The self-verification loops on the card's v1 engine at 44 100 Hz,
    each against the port's CPU run; the ADSR synth renders (no FluidSynth
    binary).  Returns the Viterbi kernels' times at the reverse-analysis
    shape."""
    from aegis_tpu_torch.io import read_wav
    from aegis_tpu_torch.io.audio import to_mono
    from aegis_tpu_torch.synth import adsr, fluidsynth
    from aegis_tpu_torch.verify.auto_match import auto_match_parameters
    from aegis_tpu_torch.verify.effect_loop import learning_loop
    from aegis_tpu_torch.verify.per_note import optimize_all_notes
    from aegis_tpu_torch.verify.reverse import reverse_analysis
    from aegis_tpu_torch.verify.technique import (
        verify_technique_by_audio_matching)

    sr = 44100
    os.environ["AEGIS_FLUIDSYNTH_BIN"] = os.path.join(
        tempfile.gettempdir(), "no-fluidsynth-here")
    fluidsynth._singleton = None
    renders = []
    real_render = adsr.synthesize_midi_adsr

    def counted_render(*a, **k):
        renders.append(str(k.get("device")))
        return real_render(*a, **k)

    adsr.synthesize_midi_adsr = counted_render
    try:
        eng = AegisEngine(sample_rate=sr, device=dev)
        cpu = AegisEngine(sample_rate=sr, device="cpu")

        # reverse analysis: MIDI -> ADSR -> v1 engine -> compare
        res, counts, batch = run_counted(
            lambda: reverse_analysis(midi, eng, sample_rate=sr))
        expect_launches("reverse_analysis", counts, batch, 1, 1)
        add_counts(total, counts)
        per_call["reverse60_44100"] = counts
        ref = reverse_analysis(midi, cpu, sample_rate=sr)
        keys = [k for k in ref if k not in ("reversed_midi",
                                            "reversed_events")]
        row = {"phase": "verify", "loop": "reverse_analysis", "sr": sr,
               **{k: res[k] for k in keys},
               "metrics_equal_cpu": all(
                   res[k] == ref[k] or (res[k] != res[k] and ref[k] != ref[k])
                   for k in keys),
               "events_equal_cpu": [(e["note"], e["start"], e["end"])
                                    for e in res["reversed_events"]]
               == [(e["note"], e["start"], e["end"])
                   for e in ref["reversed_events"]],
               "jax_cpu": JAX_CPU_REVERSE, "launches": counts,
               "synthesizer": ("fluidsynth"
                               if fluidsynth.get_synthesizer().is_available()
                               else "adsr"),
               "adsr_renders": renders[:]}
        emit(row)
        if (not row["metrics_equal_cpu"] or row["synthesizer"] != "adsr"
                or str(dev) not in renders
                or res["note_accuracy"] < JAX_CPU_REVERSE["note_accuracy"]):
            raise AssertionError(f"reverse_analysis: {row}")
        audio, _ = read_wav(real_render(midi, sample_rate=sr, device=dev))
        obs, vprob, tables = real_obs(to_mono(audio), sr, dev)
        lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
        compare_kernels("reverse60_44100", lo_v, lo_u, tables.band,
                        tables.band_tab, tables.half_width, 1.0, errs)
        kernel_row = time_kernels(obs[None], vprob[None], tables, False)
        emit({"phase": "times", "what": "viterbi_reverse", "sr": sr,
              **kernel_row["shape"], "median_ms": kernel_row,
              "card": CARD["nvidia_smi"]})

        # the effect learning loop on one preset
        loop, counts, batch = run_counted(lambda: learning_loop(
            midi, eng, preset="full_fx", sample_rate=sr))
        expect_launches("learning_loop", counts, batch, 1, 1)
        add_counts(total, counts)
        loop_cpu = learning_loop(midi, cpu, preset="full_fx", sample_rate=sr)
        row = {"phase": "verify", "loop": "learning_loop",
               "preset": "full_fx", "best_accuracy": loop["best_accuracy"],
               "best_params": loop["best_params"],
               "iterations": len(loop["history"]),
               "equal_cpu": loop == loop_cpu,
               "cpu_best_overall": loop_cpu["best_accuracy"]["overall"],
               "jax_cpu_best_overall": JAX_CPU_LOOP_BEST_OVERALL,
               "launches": counts}
        emit(row)
        # the chain's output is within 1e-4 of the CPU's (phase 23), which
        # the int8 transport may round apart on a few samples
        if abs(row["best_accuracy"]["overall"]
               - row["cpu_best_overall"]) > 0.01:
            raise AssertionError(f"learning_loop: {row} / {loop_cpu}")

        # auto-match: the card at 60 s; card and CPU on the first 15 s
        y = tracks[sr][0]
        raw = eng.audio_to_midi(y)
        am = auto_match_parameters(y, eng, raw)
        y15 = y[: int(CPU_TWIN_S * sr)]
        raw15 = eng.audio_to_midi(y15)
        am15 = auto_match_parameters(y15, eng, raw15)
        am15_cpu = auto_match_parameters(y15, cpu, raw15)
        picks = [{k: v for k, v in d.items() if k != "score"}
                 for d in (am15, am15_cpu)]
        row = {"phase": "verify", "loop": "auto_match_parameters",
               "card_60s": am, "card_15s": am15, "cpu_15s": am15_cpu,
               "cpu_twin": f"first {CPU_TWIN_S:.0f} s (the CPU run of the 60 s "
                           "call takes more than a minute)",
               "same_pick": picks[0] == picks[1],
               "score_abs_err": abs(am15["score"] - am15_cpu["score"])}
        emit(row)
        if am is None or not row["same_pick"] or row["score_abs_err"] > 1e-5:
            raise AssertionError(f"auto_match: {row}")

        # per-note ADSR optimization over the track's events
        events = eng.extract_events(raw, None, confidence_threshold=0.5,
                                    sustain_ms=150)
        opt = optimize_all_notes(y, events, sr, HOP, device=dev)
        ev15 = [e for e in events if e["end"] * HOP / sr < CPU_TWIN_S]
        opt15 = optimize_all_notes(y, ev15, sr, HOP, device=dev)
        opt15_cpu = optimize_all_notes(y, ev15, sr, HOP, device="cpu")
        differ = [(a, b) for a, b in zip(opt15, opt15_cpu) if a != b]
        row = {"phase": "verify", "loop": "optimize_all_notes",
               "events": len(events), "combos": 27 * len(events),
               "events_15s": len(ev15),
               "cpu_twin": f"events ending in the first {CPU_TWIN_S:.0f} s",
               "params_equal_cpu": not differ, "differ": differ[:3],
               "finite": all(0.0 <= r["similarity_score"] <= 1.0
                             for r in opt)}
        emit(row)
        if differ or len(opt) != len(events) or not row["finite"]:
            raise AssertionError(f"optimize_all_notes: {row}")

        # technique verification: bends, vibrato, hammer-ons, pull-offs
        techs = ("bend", "hammer_on", "vibrato", "pull_off", None)
        tev = [dict(e, technique=techs[i % len(techs)])
               for i, e in enumerate(events)]
        ver = verify_technique_by_audio_matching(y, tev, sr, HOP, device=dev)
        ver_cpu = verify_technique_by_audio_matching(y, tev, sr, HOP,
                                                     device="cpu")
        decisions = [(e["technique"], e.get("technique_verified"))
                     for e in ver]
        row = {"phase": "verify", "loop": "verify_technique_by_audio_matching",
               "events": len(tev),
               "checked": sum(e.get("technique") is not None for e in tev),
               "kept": sum(1 for d in decisions if d[1]),
               "decisions_equal_cpu": decisions == [
                   (e["technique"], e.get("technique_verified"))
                   for e in ver_cpu]}
        emit(row)
        if not row["decisions_equal_cpu"]:
            raise AssertionError(f"technique: {row}")

        times = {
            "reverse_analysis": wall_ms(
                lambda: reverse_analysis(midi, eng, sample_rate=sr)),
            "learning_loop_full_fx": wall_ms(lambda: learning_loop(
                midi, eng, preset="full_fx", sample_rate=sr)),
            "auto_match_parameters_60s": wall_ms(
                lambda: auto_match_parameters(y, eng, raw)),
            "optimize_all_notes_60s": wall_ms(
                lambda: optimize_all_notes(y, events, sr, HOP, device=dev)),
            "verify_technique_60s": wall_ms(
                lambda: verify_technique_by_audio_matching(
                    y, tev, sr, HOP, device=dev))}
        emit({"phase": "times", "what": "verify_loops_warm_median_of_5_ms",
              "sr": sr, "median_ms": times, "card": CARD["nvidia_smi"]})
    finally:
        adsr.synthesize_midi_adsr = real_render
    return kernel_row


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def main() -> int:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    dev = timed("device", phase_device)
    timed("build", phase_build)
    tracks = {sr: generate_bench_track(60.0, sr=sr, return_truth=True)
              for sr in (22050, 44100)}
    errs: dict = {}
    shapes = timed("kernels", phase_kernels, dev, tracks, errs)
    per_call: dict = {}   # a main-path call -> each kernel's launches in it
    launches = timed("slice", phase_slice, dev, tracks, per_call)
    fused_ms = timed("times", phase_times, dev, tracks, shapes)
    total = dict(launches)
    timed("financial", phase_financial, dev, tracks, total)
    y10, truth10 = generate_bench_track(600.0, sr=22050, return_truth=True)
    tile_shapes = timed("tiles", phase_tiles, dev, tracks, y10, errs, total,
                        per_call)
    with tempfile.TemporaryDirectory() as folder:
        ys = []
        for seed in (42, 43, 44, 45):
            y = generate_bench_track(60.0, sr=22050, seed=seed)
            write_wav(os.path.join(folder, f"bench60_seed{seed}.wav"), y,
                      22050)
            ys.append(y)
        timed("batch", phase_batch, dev, folder, ys, total)
        timed("stream", phase_stream, dev, y10, truth10, total, per_call)
        tiles_ms = timed("times_modes", phase_times2, dev, tracks, folder, y10,
                         tile_shapes)
    live_shapes = timed("live_kernels", phase_live_kernels, dev, tracks, errs)
    live_stats = timed("live", phase_live, dev, tracks, y10, truth10, total,
                       per_call)
    live_ms = timed("times_live", phase_times_live, dev, tracks, live_shapes,
                    live_stats)

    # the polyphonic stack: no hand kernel (its paths run no pYIN), so every
    # phase also checks that neither Viterbi kernel was launched
    timed("poly_parts", phase_poly_parts, dev)
    chord_tracks = {("chord60", 22050): chord_track(60.0, 22050),
                    ("chord60", 44100): chord_track(60.0, 44100),
                    ("chord600", 22050): chord_track(600.0, 22050)}
    timed("poly", phase_poly, dev, chord_tracks)
    with tempfile.TemporaryDirectory() as folder:
        ys = []
        for first_seed in (1, 14, 27, 40):
            y, _ = chord_track(60.0, 22050, first_seed)
            write_wav(os.path.join(folder, f"chord60_seed{first_seed}.wav"),
                      y, 22050)
            ys.append(y)
        timed("poly_folder", phase_poly_folder, dev, folder, ys)
        poly_live_stats = timed("poly_live", phase_poly_live, dev,
                                chord_tracks)
        timed("times_poly", phase_times_poly, dev, chord_tracks, folder,
              poly_live_stats)

    # the auto router (its v1 half launches both kernels once a call) and
    # the neural backend (which launches neither)
    with tempfile.TemporaryDirectory() as auto_folder, \
            tempfile.TemporaryDirectory() as neural_folder:
        for name, sr, y, _ in auto_clips(tracks)[:4]:
            write_wav(os.path.join(auto_folder, f"{name}.wav"), y, sr)
        for seed in (42, 43, 44, 45):
            write_wav(os.path.join(neural_folder, f"bench60_seed{seed}.wav"),
                      generate_bench_track(60.0, sr=22050, seed=seed), 22050)
        auto_obs = timed("auto", phase_auto, dev, tracks, auto_folder, errs,
                         total, per_call)
        timed("neural", phase_neural, dev, tracks, y10, truth10,
              neural_folder)
        auto_ms = timed("times_auto_neural", phase_times_auto_neural, dev,
                        tracks, y10, auto_folder, neural_folder, auto_obs)

    # HPSS stems, the ADSR synth and effect chain, the verification loops
    # (no hand kernel of their own; the loops' v1 engine launches both)
    with tempfile.TemporaryDirectory() as stems_folder:
        timed("hpss", phase_hpss, dev, tracks, y10, stems_folder)
    midi44 = notes_midi(tracks[44100][1])
    timed("synth", phase_synth, dev, midi44)
    reverse_ms = timed("verify", phase_verify, dev, tracks, midi44, errs,
                       total, per_call)
    emit({"phase_seconds": "total", "seconds": time.perf_counter() - t_start})

    # every main-path shape of the kernels: the call that launches it, that
    # call's own launch counts in this run, and the kernels' times at its shape
    by_shape = [
        ("audio_to_midi fused, 60 s at 22 050 Hz", per_call["bench60_22050"],
         fused_ms[22050]),
        ("audio_to_midi fused, 60 s at 44 100 Hz", per_call["bench60_44100"],
         fused_ms[44100]),
        ("turbo_mode tiles, 60 s at 22 050 Hz", per_call["tiles60_22050"],
         tiles_ms["tiles60_22050"]),
        ("turbo_mode tiles, 60 s at 44 100 Hz", per_call["tiles60_44100"],
         tiles_ms["tiles60_44100"]),
        ("turbo_mode stream, 10 minutes at 22 050 Hz in slabs of 16 tiles",
         per_call["stream_slab_22050"], tiles_ms["stream_slab_22050"]),
        ("AegisAutoEngine.analyze, 60 s at 44 100 Hz, hop 1024",
         per_call["auto60_44100"], auto_ms),
        ("reverse_analysis, 60 s at 44 100 Hz", per_call["reverse60_44100"],
         reverse_ms),
    ] + [
        (f"live v1, tile {tile} / halo {halo}, 60 s at {sr} Hz, one tile a "
         "launch", per_call[("live", sr, tile, halo)],
         live_ms[(sr, tile, halo)])
        for sr in (22050, 44100) for tile, halo in LIVE_PRESETS]

    def entry(name: str) -> dict:
        first = by_shape[0][2]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": total[name],
                "max_abs_err": errs[name], "ms": first[name],
                "plain_ms": first[f"{name}_plain"],
                "bound_ms": first["bounds"][name]["bound_ms"],
                "bound_by": first["bounds"][name]["bound_by"],
                "library_ms": None,
                "shapes": [{"path": path, **row["shape"],
                            "launches_per_call": counts[name],
                            "ms": row[name],
                            "plain_ms": row[f"{name}_plain"],
                            "bound_ms": row["bounds"][name]["bound_ms"],
                            "bound_by": row["bounds"][name]["bound_by"],
                            "serial_floor_ms":
                                row["bounds"][name]["serial_floor_ms"],
                            "library_ms": None}
                           for path, counts, row in by_shape]}

    emit({"kernels": [entry("viterbi_fwd"), entry("viterbi_back")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
