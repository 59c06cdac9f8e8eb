#!/usr/bin/env python3
"""Smoke run of aegis_tpu_torch, the PyTorch / CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the v1 WAV -> MIDI transcription
(``AegisEngine.audio_to_midi`` -> ``extract_events`` -> MIDI bytes), and
its CUDA kernels, in five phases; each raises on failure:

  1. device  — a CUDA device must be present; prints nvidia-smi's name and
               power limit; TF32 off.
  2. build   — compiles the Viterbi kernels from aegis_tpu_torch/csrc/ with
               nvcc and prints the seconds and the ptxas report.
  3. kernels — each kernel against its plain PyTorch version on the card, on
               synthetic observations (w = 101, T = 2625 and w = 51,
               T = 5249: >= 0.99 state agreement) and on the real
               observations of the 60 s bench track at 22 050 and 44 100 Hz
               (states identical).
  4. slice   — the engine on the card: the 60 s bench track at 22 050 Hz,
               the Karplus-Strong test track and the 60 s bench track at
               44 100 Hz; every kernel's launch count must rise by one per
               clip; note-event F1 >= 0.99 against the same engine on the
               CPU, truth F1 >= 0.99 on the 22 050 Hz bench track.
  5. times   — warm medians of 5 (CUDA events): audio_to_midi on each 60 s
               track, and each kernel against its plain version at the
               slice's shapes; a torch.profiler breakdown of one run.

Prints one JSON object per result, then the kernels line, then as the last
line {"ok": true, "device": {...}}.  Exits non-zero, printing no result,
when torch.cuda.is_available() is False or the package is missing.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core.analyze import (dequant_transport, pad_to_bucket,
                                          quantize_pcm8)
from aegis_tpu_torch.core.tables import tables_from_numpy
from aegis_tpu_torch.engine.engine import AegisEngine
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                              generate_test_track,
                                              wandering_pitch_obs)
from aegis_tpu_torch.verify.metrics import events_to_seconds, note_event_f1

HOP = 512
CFG = PyinConfig()
LOG_STAY = float(np.log1p(-CFG.switch_prob))
LOG_SWITCH = float(np.log(CFG.switch_prob))
KERNEL_SOURCE = "aegis_tpu_torch/csrc/viterbi.cu"
REPLACES = {"viterbi_fwd": "aegis_tpu/core/pyin_pallas.py:98",
            "viterbi_back": "aegis_tpu/core/pyin_pallas.py:198"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` runs of fn(), timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "needs one NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
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


def compare_kernels(name: str, lo_v, lo_u, band, w: int, floor: float,
                    errs: dict) -> dict:
    """Run both kernels and both plain versions on the same inputs."""
    n = band.shape[0]
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w,
                                                 LOG_STAY, LOG_SWITCH)
    torch.cuda.synchronize()
    states = pyin_cuda.viterbi_back(d_last, psi_v, psi_u)
    torch.cuda.synchronize()
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
    row = {"phase": "kernel_vs_plain", "case": name, "T": lo_v.shape[1],
           "n": n, "w": w, "state_agreement": agree,
           "psi_identical": bool(torch.equal(psi_v, p_v)
                                 and torch.equal(psi_u, p_u)),
           "delta_last_max_abs_err": fwd_err,
           "back_max_abs_err_same_inputs": back_err, "floor": floor}
    emit(row)
    if agree < floor:
        raise AssertionError(f"{name}: state agreement {agree} < {floor}")
    if back_err != 0:
        raise AssertionError(f"{name}: backtrace kernel differs from plain")
    return row


def phase_kernels(dev, tracks, errs) -> dict:
    n = CFG.n_pitch_bins
    for w, T, seed, sr in ((101, 2625, 11, 22050), (51, 5249, 21, 44100)):
        obs, vprob = wandering_pitch_obs(T, n, seed, 200, 8,
                                         (-2, -1, 0, 1, 2), True)
        lo_v, lo_u = tpyin.decode_inputs(torch.from_numpy(obs).to(dev),
                                         torch.from_numpy(vprob).to(dev))
        tables = tables_from_numpy(AudioConfig(sample_rate=sr), CFG, dev)
        if tables.half_width != w:
            raise AssertionError(f"half-width {tables.half_width} != {w}")
        compare_kernels(f"synthetic_w{w}", lo_v, lo_u, tables.band, w, 0.99,
                        errs)
    shapes = {}
    for sr, (y, _) in tracks.items():
        obs, vprob, tables = real_obs(y, sr, dev)
        lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
        compare_kernels(f"bench60_{sr}", lo_v, lo_u, tables.band,
                        tables.half_width, 1.0, errs)
        shapes[sr] = (obs, vprob, tables)
    return shapes


def phase_slice(dev, tracks) -> dict:
    """Returns each kernel's launch count over the main path's runs."""
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
        for k, v in pyin_cuda.LAUNCHES.items():
            if v != before[k] + 1:
                raise AssertionError(f"{name}: {k} launched {v - before[k]} "
                                     "times, expected 1")
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
        n, w, band = CFG.n_pitch_bins, tables.half_width, tables.band
        lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
        dense = pyin_cuda.dense_from_band(band, n, w)
        psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w,
                                                     LOG_STAY, LOG_SWITCH)
        row = {
            "viterbi_fwd": cuda_ms(lambda: pyin_cuda.viterbi_fwd(
                lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH)),
            "viterbi_fwd_plain": cuda_ms(lambda: pyin_cuda.viterbi_fwd_plain(
                lo_v, lo_u, dense, LOG_STAY, LOG_SWITCH)),
            "viterbi_back": cuda_ms(lambda: pyin_cuda.viterbi_back(
                d_last, psi_v, psi_u)),
            "viterbi_back_plain": cuda_ms(lambda: pyin_cuda.viterbi_back_plain(
                d_last, psi_v, psi_u)),
            "viterbi_decode_cuda": cuda_ms(lambda: pyin_cuda.viterbi_decode_cuda(
                lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH)),
            "viterbi_decode_plain": cuda_ms(lambda: tpyin.viterbi_decode(
                obs, vprob, dense, CFG.switch_prob)),
        }
        kernel_ms[sr] = row
        emit({"phase": "times", "what": "viterbi", "sr": sr,
              "T": lo_v.shape[1], "w": w, "median_ms": row})

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


def main() -> int:
    dev = phase_device()
    phase_build()
    tracks = {sr: generate_bench_track(60.0, sr=sr, return_truth=True)
              for sr in (22050, 44100)}
    errs: dict = {}
    shapes = phase_kernels(dev, tracks, errs)
    launches = phase_slice(dev, tracks)
    kernel_ms = phase_times(dev, tracks, shapes)[22050]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": kernel_ms[name],
         "plain_ms": kernel_ms[f"{name}_plain"],
         "shape": "B=1, T=2625, n=450, w=101 (60 s at 22050 Hz)"}
        for name in ("viterbi_fwd", "viterbi_back")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
