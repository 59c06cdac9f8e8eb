#!/usr/bin/env python3
"""Smoke run of aegis_tpu_torch, the PyTorch / CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the v1 WAV -> MIDI transcription
(``AegisEngine.audio_to_midi`` -> ``extract_events`` -> MIDI bytes), the
financial (v2) engine, the tiled, streamed and folder-batch modes, the
live transcribers and the CUDA kernels, in thirteen phases; each raises on
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

Prints one JSON object per result and each phase's seconds, then the
kernels line (each kernel's launches on the main paths, its error, and at
every shape the launches one call made in this run, its time beside the
plain version's and its bound; the serial floor stands on the times lines;
no single PyTorch call computes a Viterbi decode, so library_ms is null), then
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
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.analyze import (dequant_transport, dispatch_analyze,
                                          fetch_analyze, pad_to_bucket,
                                          quantize_pcm8)
from aegis_tpu_torch.core.events import extract_events_v1
from aegis_tpu_torch.core.tables import tables_from_numpy
from aegis_tpu_torch.engine import turbo as tturbo
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.engine.financial import AegisFinancialEngine
from aegis_tpu_torch.engine.folder import transcribe_folder
from aegis_tpu_torch.engine.realtime import StreamingTranscriber
from aegis_tpu_torch.io import write_wav
from aegis_tpu_torch.midi import midi_to_notes
from aegis_tpu_torch.tools.bench_viterbi import (band_and_table, cuda_ms,
                                                 forward_variant,
                                                 synthetic_inputs)
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
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


def real_obs(y: np.ndarray, sr: int, dev: torch.device):
    """The decode's observations for a track, as the main path computes
    them on the card (bucket padding, int8 transport, pYIN stages)."""
    tables = tables_from_numpy(AudioConfig(sample_rate=sr), CFG, dev)
    y8, s8 = quantize_pcm8(pad_to_bucket(np.asarray(y, np.float32)))
    yd = dequant_transport(torch.from_numpy(y8).to(dev),
                           torch.from_numpy(s8).to(dev))
    frames = tpyin.extract_pyin_frames(yd, HOP, CFG)
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
                 chunk_s: float = 0.5, poll_s: float = 2.0):
    """One live session on the card: ``y`` fed in chunks, polled every
    ``poll_s`` of audio (and after every chunk until the first note shows),
    finalized.  Returns (final events, stats); raises when a kernel was not
    launched exactly once a tile at B = 1 or a sampled poll differs from
    the cache-free one."""
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
            first_event = fed_s - min(e["start"] for e in events) * HOP / sr
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
    for k in counts:
        if counts[k] != tiles or pyin_cuda.SEQUENCES[k] != tiles:
            raise AssertionError(
                f"live: {k} launched {counts[k]} times with "
                f"{pyin_cuda.SEQUENCES[k]} sequences over {tiles} tiles")
    if len(checked) != len(sampled) or not final:
        raise AssertionError(f"live: polls checked {checked}, "
                             f"{len(final)} events")
    warm = sorted(tile_ms[1:])
    stats = {
        "sr": sr, "tile": tile, "halo": halo, "audio_s": len(y) / sr,
        "engine": "financial" if financial else "v1", "tiles": tiles,
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


def live_profile(dev, y, sr: int, tile: int, halo: int, financial: bool,
                 tile_wall_ms: float, n: int = 8) -> dict:
    """Device-busy ms and launches a tile: torch.profiler over ``n`` warm
    tiles, each fed as exactly one tile's samples.  The idle share is taken
    against ``tile_wall_ms``, the session's median without the profiler
    (tracing every launch several times over slows the host)."""
    rt = live_transcriber(dev, sr, tile, halo, financial)
    tile_samp = tile * HOP
    pos = rt._ctx + 4 * tile_samp
    rt.feed(y[:pos])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            if rt.feed(y[pos:pos + tile_samp]) != 1:
                raise AssertionError("live profile: a feed of one tile's "
                                     "samples did not run one tile")
            pos += tile_samp
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n

    def dev_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA
               and not a.key.startswith("aegis.")]
    busy_ms = sum(dev_us(a) for a in kernels) / 1000.0 / n
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"phase": "profile", "what": "live_tile", "sr": sr, "tile": tile,
            "halo": halo, "engine": "financial" if financial else "v1",
            "tiles_profiled": n, "wall_ms_a_tile_profiled": wall_ms,
            "device_busy_ms_a_tile": busy_ms,
            "kernel_launches_a_tile": sum(a.count for a in kernels) / n,
            "tile_wall_ms_median_of_the_session": tile_wall_ms,
            "idle_share": 1.0 - busy_ms / tile_wall_ms,
            "top_device_kernels_ms_a_tile": [
                [a.key[:70], dev_us(a) / 1000.0 / n, a.count / n]
                for a in top],
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
                            "library_ms": None}
                           for path, counts, row in by_shape]}

    emit({"kernels": [entry("viterbi_fwd"), entry("viterbi_back")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
