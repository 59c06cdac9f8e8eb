#!/usr/bin/env python3
"""Smoke run of aegis_tpu_torch, the PyTorch / CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, the v1 WAV -> MIDI transcription
(``AegisEngine.audio_to_midi`` -> ``extract_events`` -> MIDI bytes), the
financial (v2) engine, the tiled, streamed and folder-batch modes, the
live transcribers, the CUDA kernels, the polyphonic stack, the auto router,
the neural (PitchNet) backend, HPSS stems, the ADSR synth and effect chain,
the self-verification loops, the REST server, the PitchNet trainer, the
validation tools, the Streamlit apps, the multi-device paths, the finer
pitch grids and the warm-up command, in thirty-three phases; each raises on
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
               a tile (torch.profiler over eight tiles, whose kernel events
               must show one forward and one of each backtrace kernel a
               tile, none a poly tile); the kernels at the
               live shapes against their plain versions and the one-CTA
               variant, with bound and serial floor.
 13a. live graph — every live tile replays one captured CUDA graph: over
               a 20 s session (v1 at 44 100 and 22 050 Hz, financial at
               44 100 Hz, v1 at n = 900) each tile's rows and running
               reference bitwise those of the tile program's body run
               eagerly, each kernel counted once a tile at its shape, a
               second session bitwise the first and capturing nothing; two
               10 s sessions interleaved tile by tile and fed from two
               threads at once give what each gives alone; sessions at rake
               0.3 and 0.9 replay one graph, each bitwise the eager body at
               its rake; a new program captured while another thread runs a
               REST analyze and eager tiles, both staying equal to what
               they give alone.  Prints the tile wall ms replayed and
               eager, and a replay's host launch ms and device ms (v1,
               44 100 Hz).
 13b. fused graph — the fused program replays one captured CUDA graph a
               key: at the six length buckets of the benchmark's 15-120 s
               takes @ 44 100 Hz, at n = 450 (viterbi_fwd_kernel) and
               n = 900 (viterbi_fwd_wide_kernel), each replay's packed rows
               bitwise the eager program's, one launch of each kernel
               counted a replay; prints each capture's seconds, the eager
               and replayed wall ms, a replay's host launch ms and device
               ms, and the peak device memory with the six buckets of one
               grid captured and with both grids' twelve.
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
 25. serve   — the REST server as AegisServer() builds it (44 100 Hz, hop
               512, the card) behind ThreadingHTTPServer on 127.0.0.1:
               /api/health unprobed and probed ("gpu", the device count);
               the 60 s bench track uploaded (multipart) and analysed
               (auto -> fused): events and MIDI equal to the facade's on the
               same decoded samples, truth F1 >= 0.99, one launch of each
               kernel a request, both kernels identical to their plain
               versions on the request's observations; turbo=tiles; a
               10-minute upload under turbo=auto ("stream", one launch a
               slab); pitch_backend=neural (no launch); refilter, midi,
               tabs, spectrogram; analyze-poly on chord seed 3 and
               analyze-auto on mixed seed 1 against their facades;
               reverse-analysis and adsr-synth on the analysed session; a
               live v1 session fed 0.5 s int16 chunks, polled every 2 s of
               audio, against a StreamingTranscriber run directly; four
               concurrent clients against their sequential answers.  Every
               request's status is checked.  One line of per-endpoint warm
               medians of 5 request wall times beside the facade's, their
               difference, and device busy ms and launches of one profiled
               request.
 26. train   — models/train.py::train at the train command's defaults (3000
               steps, batch 256, 2048 clips x 16 384 samples, hidden
               (512, 256), seed 0), the checkpoint written to a temporary
               directory: the data-synthesis seconds, the logged losses
               (finite, the last under half the first), rpa_50c and
               voicing_acc no more than TRAIN_SLACK under the JAX trainer's
               on the CPU (JAX_CPU_TRAIN); the checkpoint through load_params
               and run_analyze_neural on the card tracks 110 / 196 / 440 Hz
               tones within 50 cents, voiced share > 0.5; two 50-step runs
               from one seed give bitwise-equal parameters; the warm ms a
               step, device busy ms and launches a step (torch.profiler over
               20 steps); 8 steps on the card and on the CPU from the same
               parameters and crops (card_vs_cpu_steps): parameters within
               1e-5, each loss within 1e-5 of the CPU's, relative; no
               device range counted as a kernel; the packaged checkpoint's
               sha256 unchanged; no Viterbi launch.
 27. validate — tools/validate_device.py::validate(include_bench=False) on
               the card: the gate passes, every v1 and financial F1 against
               the oracle 1.0, every truth and poly F1 within 0.01 of the
               JAX tool's on the CPU; tools/benchmark.py::run_benchmark(0.4)
               beats its naive baseline; inharmonic_sweep --quick's rows
               within 0.01 of the JAX tool's; then each clip the three
               tools run (the gating clips at 22 050 and 44 100 Hz, the
               scale track, the benchmark's scale, the sweep's two
               melodies): one launch of each kernel a v1 and a financial
               call at the clip's shape (B = 1), both kernels identical to
               their plain versions on its observations, and timed there;
               the tools launched at no other shape.
 28. apps    — the Streamlit apps, headless through the recording
               stand-in for streamlit below (StreamlitStandIn: scripted
               widgets, recorded outputs, a session_state that lives across
               reruns), one main(device=...) call a rerun, on the 60 s
               bench track at 44 100 Hz (22 050 Hz for the 22 050 Hz apps):
               the Tuning Center (upload with the defaults; the confidence
               slider moved, which launches nothing; turbo, B = 6; the HPSS
               stem, then a fused call; neural, no launch), Tuner Pro (the
               30 s turbo analysis, B = 3, T = 1152, w = 51, both kernels
               held to their plain versions there on tile observations
               first; then one rerun a tab: auto-match, crossfade, reverse,
               ADSR, the effect loop cut to two iterations, per-note), the
               Live Monitor (v1, financial, poly; the first APP_LIVE_S of
               the track in 2 s chunks: one launch of each kernel a tile,
               none for poly), both financial apps (and a Phase-2 rerun),
               the stem lab, the MIDI sandbox's four engines, the collector
               studio and the dashboard (no launch).  Each rerun's MIDI,
               events, stems, markup or results equal its facade's (or the
               direct call's) on the same input, and launch what it
               launches; both kernels are held to their plain versions on
               the apps' own inputs at every shape the apps launched (a
               replayed live tile's through its program's eager body on
               the first tile; the phase fails on a launched shape it did
               not check).  Each
               rerun's wall ms (warm median of 5, CUDA events, where the
               rerun repeats), device busy ms and launches (profiled) and
               its facade's ms, beside the card's name and power limit.
 29. mesh    — the multi-device paths (aegis_tpu_torch/utils/mesh.py) on
               the one card.  A world of one NCCL rank in this process:
               run_analyze_batch v1 and financial on the four-track folder
               (seeds 42-45, 60 s at 22 050 Hz, default TurboConfig),
               run_analyze_poly_turbo on the 60 s chord track,
               run_analyze_streamed on the 10-minute track,
               run_analyze_neural_batch on the folder and 20 training
               steps at batch 256 (train_on_batches), each on a (1, 1)
               mesh bit for bit equal to its call with no mesh, with the
               same launches at the same shapes.  Two gloo ranks sharing
               the card (spmd, collectives staged through the host): the
               batch v1 and financial at (2, 1), and at (1, 2) on the
               tracks cut to 2 x tile_frames frames, the neural batch at
               (2, 1), the 20 steps twice; every rank's result equal, the
               rows within the parity tests' tolerances of the
               one-process program (and whether bit-equal), the distortion
               score's summation-order gap, event F1 >= 0.99 against the
               one-process run, truth F1 no more than 0.01 under it, the
               loss within rtol 1e-5 of world 1 and the two runs bitwise
               equal; one launch of each kernel a rank and call (none for
               neural and training), each per-rank shape held to the plain
               versions on that rank's observations and timed.  Then
               graft_entry_torch.dryrun_multichip(1) on NCCL and (2) over
               gloo.  Prints the backend, world, mesh, staging, each
               rank's device and the wall ms a call (median of 5, CUDA
               events).
 30. grids   — the finer pitch grids of PyinConfig.resolution (0.05 and
               0.04 @ 44 100 Hz, 0.05 @ 22 050 Hz, 0.02 at both rates:
               n = 900 / 1125 / 900 / 2250 / 2250, w = 101 / 126 / 201 /
               251 / 501, hop 512): both kernels against their plain
               versions on the bench track's observations (a 10 s cut past
               2000 states) at B = 1, 6 and 16 (consecutive windows), with
               the variant the wrapper picks (the wide kernel where a CTA's
               tiles outnumber its threads) and one CTA a sequence, each
               shape timed beside its bound and serial floor; then the v1
               engine fused on the 60 s track and a live v1 session on its
               first GRID_LIVE_S (tile 24 / halo 8, 0.5 s chunks) at
               resolution 0.05 @ 44 100 Hz (n = 900, w = 101) on the card:
               one launch of each kernel a call or tile at n = 900, note
               events equal to the same calls on the CPU, truth F1 >= 0.99
               or within 0.01 of the JAX package's (JAX_CPU_GRID_TRUTH_F1),
               both kernels held to their plain versions on the live tiles.
 31. warmup  — in a temporary copy of aegis_tpu_torch/ (a fresh build/)
               with HOME in a temporary directory (a fresh native-library
               cache): `python -m aegis_tpu_torch transcribe` of the 60 s
               WAV @ 22 050 Hz cold; both builds deleted; `warmup --seconds
               60 --sr 22050 --pipelines v1,financial,poly,live-v1`, which
               must build both again; the same transcribe, which must
               build nothing (every library file keeps its mtime) and
               write the cold run's MIDI bytes.  Prints each run's seconds
               and each warm line.

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

import base64
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.config import AudioConfig, PyinConfig, TurboConfig
from aegis_tpu_torch.core import cqt as tcqt
from aegis_tpu_torch.core import poly as tpoly
from aegis_tpu_torch.core import pyin as tpyin
from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.core import analyze as tanalyze
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
from aegis_tpu_torch.models import pitchnet as tpn
from aegis_tpu_torch.models import train as ttrain
from aegis_tpu_torch.models.data import make_clips
from aegis_tpu_torch.models.pitchnet import (run_analyze_neural,
                                             run_analyze_neural_streamed)
from aegis_tpu_torch.ref.poly_ref import peel_voices_ref
from aegis_tpu_torch.tools import (benchmark, inharmonic_sweep,
                                   validate_device)
from aegis_tpu_torch.tools.bench_viterbi import (band_and_table, cuda_ms,
                                                 forward_variant,
                                                 synthetic_inputs)
from aegis_tpu_torch.tools.signal_gen import (generate_bench_track,
                                              generate_chord_progression,
                                              generate_mixed_clip,
                                              generate_scale_benchmark,
                                              generate_test_track)
from aegis_tpu_torch.utils import mesh as mesh_lib
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


def real_obs(y: np.ndarray, sr: int, dev: torch.device, hop: int = HOP,
             cfg: PyinConfig = CFG):
    """The decode's observations for a track, as the main path computes
    them on the card (bucket padding, int8 transport, pYIN stages); ``hop``
    1024 at 44 100 Hz is the auto router's v1 half; ``cfg`` a finer pitch
    grid (phase 30)."""
    tables = tables_from_numpy(AudioConfig(sample_rate=sr, hop_length=hop),
                               cfg, dev)
    y8, s8 = quantize_pcm8(pad_to_bucket(np.asarray(y, np.float32)))
    yd = dequant_transport(torch.from_numpy(y8).to(dev),
                           torch.from_numpy(s8).to(dev))
    frames = tpyin.extract_pyin_frames(yd, hop, cfg)
    obs, vprob = tpyin.frame_observations(frames, sr, cfg, tables)
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
    row = time_kernel_inputs(lo_v, lo_u, band, tab, w)
    if with_decode:
        dense = pyin_cuda.dense_from_band(band, n, w)
        row["viterbi_decode_cuda"] = cuda_ms(
            lambda: pyin_cuda.viterbi_decode_cuda(
                lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH, tab))
        row["viterbi_decode_plain"] = cuda_ms(lambda: tpyin.viterbi_decode(
            obs[0], vprob[0], dense, CFG.switch_prob))
    return row


def time_kernel_inputs(lo_v, lo_u, band, tab, w: int,
                       plain_reps: int = 5) -> dict:
    """Warm medians of each kernel (of 5) and its plain version (of
    ``plain_reps``) on the decode's inputs (B, T, n), with the bounds of
    that shape."""
    n = band.shape[0]
    B, T = lo_v.shape[:2]
    dense = pyin_cuda.dense_from_band(band, n, w)
    psi_v, psi_u, d_last = pyin_cuda.viterbi_fwd(lo_v, lo_u, band, n, w,
                                                 LOG_STAY, LOG_SWITCH, tab)
    row = {
        "viterbi_fwd": cuda_ms(lambda: pyin_cuda.viterbi_fwd(
            lo_v, lo_u, band, n, w, LOG_STAY, LOG_SWITCH, tab)),
        "viterbi_fwd_plain": cuda_ms(lambda: pyin_cuda.viterbi_fwd_plain(
            lo_v, lo_u, dense, LOG_STAY, LOG_SWITCH), plain_reps),
        "viterbi_back": cuda_ms(lambda: pyin_cuda.viterbi_back(
            d_last, psi_v, psi_u)),
        "viterbi_back_plain": cuda_ms(lambda: pyin_cuda.viterbi_back_plain(
            d_last, psi_v, psi_u), plain_reps),
    }
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
    for shapes in pyin_cuda.SHAPES.values():
        shapes.clear()


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


def tile_obs(y: np.ndarray, sr: int, dev, turbo: TurboConfig,
             cfg: PyinConfig = CFG):
    """The decode's observations of every tile as the tiled program computes
    them on the card: int16 transport, haloed slabs, pYIN stages."""
    audio = AudioConfig(sample_rate=sr)
    tables = tables_from_numpy(audio, cfg, dev)
    n_tiles = n_tiles_of(y, sr, turbo)
    y16, scale = tturbo._tiled_inputs(
        np.asarray(y, np.float32)[None],
        n_tiles * turbo.tile_frames * HOP, "int16", dev)
    slabs = tturbo.tile_slabs(y16, scale, audio, cfg, turbo, n_tiles)
    frames = tturbo._frame_slab(slabs, turbo.tile_frames + 2 * turbo.halo_frames,
                                HOP, cfg.frame_length, 0)
    obs, vprob = tpyin.frame_observations(frames, sr, cfg, tables)
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


def live_transcriber(dev, sr: int, tile: int, halo: int, financial: bool,
                     pyin_cfg: PyinConfig = CFG, rake: float = 0.6):
    kw = {"financial": True} if financial else {"confidence_threshold": 0.5}
    return StreamingTranscriber(audio=AudioConfig(sample_rate=sr),
                                pyin_cfg=pyin_cfg, tile_frames=tile,
                                halo_frames=halo, device=dev,
                                rake_sensitivity=rake, **kw)


def live_session(dev, y, sr: int, tile: int, halo: int, financial: bool,
                 chunk_s: float = 0.5, poll_s: float = 2.0, rt=None,
                 pyin_cfg: PyinConfig = CFG):
    """One live session on the card: ``y`` fed in chunks, polled every
    ``poll_s`` of audio (and after every chunk until the first note shows),
    finalized.  Returns (final events, stats); raises when a kernel was not
    launched exactly once a tile at B = 1 or a sampled poll differs from
    the cache-free one.  ``rt`` is a ready StreamingPolyTranscriber: its
    tiles run no pYIN, so they must launch neither kernel."""
    poly = rt is not None
    hop = rt.hop if poly else HOP
    if rt is None:
        rt = live_transcriber(dev, sr, tile, halo, financial, pyin_cfg)
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
    # the profiler's raw events, the same ones prof.events() would turn into
    # a tree of Python objects (at ~0.1 ms an event: seconds for a session)
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    cuda = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events if e.name() == "aegis.profiled_runs"
                and e.device_type() != cuda)
    kernels: dict = {}
    for e in events:
        # ranges on the device's timeline (the engines' phases, torch.optim's
        # Optimizer.step#...) are user annotations, not kernels
        if (e.device_type() == cuda and not e.is_user_annotation()
                and e.start_ns() >= mark.start_ns()):
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e3
            k[1] += 1
    return kernels, host_ms


# the decode's device kernels, as the benchmark's readers name them
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bench_torch", "metrics",
                       "viterbi_kernels.json")) as _f:
    VITERBI_KERNELS = json.load(_f)["kernels"]


def live_profile(dev, y, sr: int, tile: int, halo: int, financial: bool,
                 tile_wall_ms: float, n: int = 8, rt=None) -> dict:
    """Device-busy ms and launches a tile: torch.profiler over ``n`` warm
    tiles, each fed as exactly one tile's samples.  The idle share is taken
    against ``tile_wall_ms``, the session's median without the profiler
    (tracing every launch several times over slows the host).  Raises
    unless the profiler's own kernel events show each tile running a
    forward kernel and each backtrace kernel exactly once (a replayed
    graph's launches are counted from its capture, not measured), or no
    decode kernel for a poly tile."""
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
    viterbi = {k: sum(c for name, (_, c) in kernels.items() if k in name) / n
               for k in VITERBI_KERNELS}
    a_tile = {"forward": sum(c for k, c in viterbi.items() if "_fwd" in k),
              **{k: c for k, c in viterbi.items() if "_back" in k}}
    if set(a_tile.values()) != {0 if poly else 1}:
        raise AssertionError(f"live profile {sr} Hz ({tile}, {halo}): "
                             f"decode kernels a tile {a_tile}")
    busy_ms = sum(us for us, _ in kernels.values()) / 1000.0 / n
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    return {"phase": "profile", "what": "live_tile", "sr": sr, "tile": tile,
            "halo": halo,
            "engine": "poly" if poly else "financial" if financial else "v1",
            "tiles_profiled": n, "wall_ms_a_tile_profiled": wall_ms,
            "device_busy_ms_a_tile": busy_ms,
            "kernel_launches_a_tile":
                sum(c for _, c in kernels.values()) / n,
            "decode_kernels_a_tile_traced": a_tile,
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
        launch = pyin_cuda.pick_forward_variant(
            1, N_SMS, n, w, pyin_cuda.max_shared_memory(dev))
        picked = (launch.tile, launch.cluster)
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
# The live tile program as one CUDA graph a tile
# --------------------------------------------------------------------------

# (name, rate, financial, pyin config): every session of one of these keys
# replays one captured graph a tile; n = 900 takes the wide forward kernel
LIVE_GRAPH_CASES = (("v1_44100", 44100, False, CFG),
                    ("v1_22050", 22050, False, CFG),
                    ("financial_44100", 44100, True, CFG),
                    ("v1_n900_44100", 44100, False, PyinConfig(resolution=0.05)))


def tile_pieces(y, rt) -> list:
    """``y`` cut so that each piece, fed in turn, completes one tile."""
    ts, ctx = rt._tile_samp, rt._ctx
    n = (len(y) - ts - ctx) // ts + 1
    return [y[:ts + ctx]] + [y[ts + ctx + (k - 1) * ts:ts + ctx + k * ts]
                             for k in range(1, n)]


def feed_tile(rt, piece):
    """One tile of a session: (its rows, the running reference after it,
    the feed's wall ms)."""
    t0 = time.perf_counter()
    if rt.feed(piece) != 1:
        raise AssertionError("live graph: a piece did not complete one tile")
    ms = 1e3 * (time.perf_counter() - t0)
    return rt._rows[-1], rt._ref_power.cpu().numpy().copy(), ms


def graph_session(dev, y, sr: int, financial: bool = False,
                  pyin_cfg: PyinConfig = CFG, rake: float = 0.6) -> list:
    """A live session on the card fed a tile at a time: each tile's (rows,
    reference, wall ms)."""
    rt = live_transcriber(dev, sr, 24, 8, financial, pyin_cfg, rake)
    return [feed_tile(rt, p) for p in tile_pieces(y, rt)]


def eager_tiles(dev, y, sr: int, financial: bool = False,
                pyin_cfg: PyinConfig = CFG, rake: float = 0.6) -> list:
    """The same tiles through the tile program's body run eagerly on the
    card (no graph): each tile's (rows, reference, wall ms)."""
    from aegis_tpu_torch.core.analyze import ingest

    rt = live_transcriber(dev, sr, 24, 8, financial, pyin_cfg, rake)
    program = tile_program(rt)
    ts, ctx = rt._tile_samp, rt._ctx
    padded = np.concatenate([np.zeros(ctx, np.float32), y])
    ref = torch.zeros((), dtype=torch.float32, device=dev)
    out = []
    for k in range(len(tile_pieces(y, rt))):
        t0 = time.perf_counter()
        staged = ingest(padded[k * ts:k * ts + 2 * ctx + ts], "int16", dev)
        rows, ref = program.body(
            *staged.upload(dev),
            torch.tensor(rake, dtype=torch.float32, device=dev), ref)
        rows = rows.cpu().numpy()
        out.append((rows, ref.cpu().numpy().copy(),
                    1e3 * (time.perf_counter() - t0)))
    return out


def same_tiles(a: list, b: list) -> bool:
    """Rows and references bitwise equal, tile for tile (NaN f0 too)."""
    return len(a) == len(b) > 0 and all(
        ra.tobytes() == rb.tobytes() and fa.tobytes() == fb.tobytes()
        for (ra, fa, _), (rb, fb, _) in zip(a, b))


def interleaved_sessions(dev, ys, sr: int) -> list:
    """Sessions of one key, one on each of ``ys``, fed a tile each in turn:
    each session's tiles."""
    rts = [live_transcriber(dev, sr, 24, 8, False) for _ in ys]
    pieces = [tile_pieces(y, rt) for y, rt in zip(ys, rts)]
    got = [[] for _ in ys]
    for k in range(max(len(p) for p in pieces)):
        for rt, p, g in zip(rts, pieces, got):
            if k < len(p):
                g.append(feed_tile(rt, p[k]))
    return got


def threaded_sessions(dev, ys, sr: int, timeout_s: float = 300.0) -> list:
    """Sessions of one key, one on each of ``ys``, each fed by its own
    thread at once (the interpreter switching threads every 10 us): each
    session's tiles."""
    import threading

    got = [None] * len(ys)

    def run(i):
        got[i] = graph_session(dev, ys[i], sr)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(ys))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        if any(t.is_alive() for t in threads):
            raise AssertionError("live graph: a feeding thread hung")
    finally:
        sys.setswitchinterval(interval)
    return got


def tile_program(rt):
    """The live tile program a session runs (kept from its first tile)."""
    from aegis_tpu_torch.engine import realtime

    return rt._program or realtime._tile_program(
        rt.audio, rt.pyin_cfg, rt.turbo, rt.financial, rt.use_guitar_filters,
        rt.device)


def live_graph(dev, sr: int, financial: bool = False,
               pyin_cfg: PyinConfig = CFG):
    """The captured graph of one key's tile program (None before its first
    tile on the card)."""
    return tile_program(live_transcriber(dev, sr, 24, 8, financial,
                                         pyin_cfg))._graph


def rake_sessions(dev, y, sr: int, rakes=(0.3, 0.9)) -> dict:
    """Sessions of one key at two rake sensitivities: whether both
    replayed one graph, each bitwise the eager body at its rake, and their
    rake masks apart (the rake is read from the graph's input, not fixed
    in it)."""
    from aegis_tpu_torch.core.analyze import _V1_ROWS

    graphs, got = [], {}
    for rake in rakes:
        got[rake] = graph_session(dev, y, sr, rake=rake)
        graphs.append(live_graph(dev, sr))
        if not same_tiles(got[rake], eager_tiles(dev, y, sr, rake=rake)):
            return {"rakes": list(rakes), "bitwise_eager_at": rake}
    col = _V1_ROWS.index("rake_mask")
    masks = [np.concatenate([r for r, *_ in got[rake]])[:, col]
             for rake in rakes]
    return {"rakes": list(rakes), "bitwise_eager_at": "every rake",
            "one_graph": all(g is graphs[0] for g in graphs),
            "rake_masks_differ": bool((masks[0] != masks[1]).any())}


def capture_beside_work(dev, n_tiles: int = 12,
                        timeout_s: float = 300.0) -> dict:
    """A new tile program captured while another thread runs what a REST
    analyze runs (``AegisEngine.audio_to_midi`` and ``extract_events``,
    fused) and eager tiles of another program, as the server's handler
    threads do beside a live session's first tile.  Returns whether the
    other thread's work overlapped the capture and stayed equal to what
    it gives alone (events equal; eager rows bitwise), and whether the new
    graph's first ``n_tiles`` tiles are bitwise its own body's."""
    import threading

    from aegis_tpu_torch.core.analyze import ingest
    from aegis_tpu_torch.engine import realtime
    from aegis_tpu_torch.engine.engine import AegisEngine

    y = generate_bench_track(5.0, sr=22050)
    engine = AegisEngine(sample_rate=22050, device=dev)

    def rest():
        return [(e["note"], e["start"], e["end"])
                for e in engine.extract_events(engine.audio_to_midi(y))]

    want = (rest(), eager_tiles(dev, y, 22050, True))
    rt = live_transcriber(dev, 44100, 24, 8, False)
    fresh = realtime._TileProgram(rt.audio, rt.pyin_cfg, rt.turbo, False,
                                  True, dev)
    done, windows, equal = threading.Event(), [], []

    def work():
        while not done.is_set():
            t0 = time.perf_counter()
            got = (rest(), eager_tiles(dev, y, 22050, True))
            windows.append((t0, time.perf_counter()))
            equal.append(got[0] == want[0] and same_tiles(got[1], want[1]))

    ts, ctx = rt._tile_samp, rt._ctx
    padded = np.concatenate([np.zeros(ctx, np.float32),
                             generate_bench_track(10.0, sr=44100)])
    slabs = [ingest(padded[k * ts:k * ts + 2 * ctx + ts], "int16", dev)
             for k in range(n_tiles)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=work)
    thread.start()
    try:
        while not windows and thread.is_alive():
            time.sleep(0.01)
        ref = torch.zeros((), dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        replayed = [fresh(*staged, 0.6, ref) for staged in slabs[:1]]
        capture = (t0, time.perf_counter())
        replayed += [fresh(*staged, 0.6, ref) for staged in slabs[1:]]
        replayed = [rows.cpu().numpy() for rows, _ in replayed]
        n_before = len(windows)
        while len(windows) < n_before + 1 and thread.is_alive():
            time.sleep(0.01)
    finally:
        done.set()
        thread.join(timeout_s)
        sys.setswitchinterval(interval)
    if thread.is_alive():
        raise AssertionError("live graph: the working thread hung")
    ref = torch.zeros((), dtype=torch.float32, device=dev)
    eager = []
    for staged in slabs:
        rows, ref = fresh.body(*staged.upload(dev),
                               torch.tensor(0.6, device=dev), ref)
        eager.append(rows.cpu().numpy())
    return {"captured": fresh._graph is not None,
            "work_runs": len(windows),
            "work_overlapped_capture": any(s < capture[1] and e > capture[0]
                                           for s, e in windows),
            "work_equal_alone": len(equal) > 0 and all(equal),
            "capture_ms": 1e3 * (capture[1] - capture[0]),
            "replays_bitwise_body": all(a.tobytes() == b.tobytes()
                                        for a, b in zip(replayed, eager))}


def replay_ms(captured, n: int = 20) -> dict:
    """Medians over ``n`` replays of a captured graph alone (a live tile
    program's or a fused program's ``graphs.CapturedProgram``): the host
    ms of the launch call, and the device ms (CUDA events) from the
    graph's first node to its last.  A spin kernel queued first keeps
    the device busy until the whole graph has been launched."""
    host, device = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)      # ~0.1 s at the card's clock
        start.record()
        t0 = time.perf_counter()
        captured.graph.replay()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    return {"replay_launch_host_ms_median": float(np.median(host)),
            "replay_device_ms_median": float(np.median(device))}


def phase_live_graph(dev) -> None:
    """Every tile replays one captured graph: rows and reference bitwise
    the eager body's over a 20 s session at each LIVE_GRAPH_CASES key,
    each kernel counted once a replay; sessions interleaved tile by tile
    and fed from two threads at once give what they give alone; a second
    session of a key captures nothing.  Prints the tile wall ms of both."""
    for name, sr, financial, pyin_cfg in LIVE_GRAPH_CASES:
        y = generate_bench_track(20.0, sr=sr)
        reset_counts()
        graph = graph_session(dev, y, sr, financial, pyin_cfg)
        torch.cuda.synchronize()
        n = pyin_cfg.n_pitch_bins
        w = tables_from_numpy(AudioConfig(sample_rate=sr), pyin_cfg,
                              dev).half_width
        want = {"viterbi_fwd": {(1, 40, n, w): len(graph)},
                "viterbi_back": {(1, 40, n): len(graph)}}
        if pyin_cuda.SHAPES != want:
            raise AssertionError(f"live graph {name}: launches "
                                 f"{pyin_cuda.SHAPES}, want {want}")
        captured = live_graph(dev, sr, financial, pyin_cfg)
        eager = eager_tiles(dev, y, sr, financial, pyin_cfg)
        again = graph_session(dev, y, sr, financial, pyin_cfg)
        equal = same_tiles(graph, eager)
        row = {"phase": "live_graph", "case": name, "tiles": len(graph),
               "rows_and_ref_bitwise_eager": equal,
               "second_session_bitwise": same_tiles(again, graph),
               "captured": captured is not None,
               "second_session_captured_nothing":
                   live_graph(dev, sr, financial, pyin_cfg) is captured,
               "tile_wall_ms_first": graph[0][2],
               "graph_tile_wall_ms_median": float(np.median(
                   [ms for *_, ms in again])),
               "eager_tile_wall_ms_median": float(np.median(
                   [ms for *_, ms in eager[1:]])),
               "card": CARD["nvidia_smi"]}
        if name == "v1_44100":
            row.update(replay_ms(captured.program))
        emit(row)
        if not (equal and row["second_session_bitwise"] and row["captured"]
                and row["second_session_captured_nothing"]):
            raise AssertionError(f"live graph {name}: {row}")
    ys = [generate_bench_track(10.0, sr=44100, seed=s) for s in (42, 43)]
    alone = [graph_session(dev, y, 44100) for y in ys]
    inter = interleaved_sessions(dev, ys, 44100)
    threads = threaded_sessions(dev, ys, 44100)
    row = {"phase": "live_graph", "case": "two_sessions_44100",
           "interleaved_bitwise_alone": [same_tiles(a, b)
                                         for a, b in zip(inter, alone)],
           "threads_bitwise_alone": [same_tiles(a, b)
                                     for a, b in zip(threads, alone)]}
    emit(row)
    if not all(row["interleaved_bitwise_alone"] + row["threads_bitwise_alone"]):
        raise AssertionError(f"live graph: {row}")
    row = {"phase": "live_graph", "case": "two_rakes_22050",
           **rake_sessions(dev, generate_bench_track(10.0, sr=22050), 22050)}
    emit(row)
    if not (row.get("one_graph") and row["rake_masks_differ"]):
        raise AssertionError(f"live graph: {row}")
    row = {"phase": "live_graph", "case": "capture_beside_work",
           **capture_beside_work(dev)}
    emit(row)
    if not all(row[k] for k in ("captured", "work_overlapped_capture",
                                "work_equal_alone", "replays_bitwise_body")):
        raise AssertionError(f"live graph: {row}")


# --------------------------------------------------------------------------
# The fused program's graphs
# --------------------------------------------------------------------------

# the benchmark's take lengths (bench_torch/traffic/rest_mono.json): six
# length buckets at 44 100 Hz
FUSED_BUCKET_SECONDS = (15, 30, 45, 60, 90, 120)


def fused_args(sr: int = 44100, pyin_cfg: PyinConfig = CFG,
               transport: str = "int8", fetch_mel: bool = True,
               financial: bool = False) -> dict:
    """dispatch_analyze's arguments for one key (the REST v1 request's by
    default)."""
    return dict(audio=AudioConfig(sample_rate=sr), pyin_cfg=pyin_cfg,
                transport=transport, fetch_mel=fetch_mel,
                financial=financial)


def fused_key(dev, y, audio, pyin_cfg, transport="int8", fetch_mel=True,
              financial=False) -> tuple:
    """The graph cache's key of a dispatch of ``y``."""
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tanalyze.fused_graph_key(len(pad_to_bucket(y)), audio, pyin_cfg,
                                    transport, fetch_mel, financial, True,
                                    dev)


def fused_graph(dev, y, **kw):
    """The captured graph a dispatch of ``y`` replays (None before its
    first dispatch on the card, or once evicted)."""
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return tanalyze.fused_graphs(dev)._graphs.get(fused_key(dev, y, **kw))


def fused_replayed(dev, y, rake: float = 0.6, **kw) -> np.ndarray:
    """The whole packed buffer of one dispatch through the graph cache."""
    packed, *_ = dispatch_analyze(y, rake_sensitivity=rake, device=dev, **kw)
    return packed.cpu().numpy()


def fused_eager(dev, y, rake: float = 0.6, audio=None, pyin_cfg=CFG,
                transport="int8", fetch_mel=True, financial=False
                ) -> np.ndarray:
    """The same packed buffer from the program run eagerly on the card (no
    graph), on the same transported samples."""
    samples, scale = tanalyze.ingest(
        pad_to_bucket(np.asarray(y, np.float32)), transport, dev).upload(dev)
    program = tanalyze.packed_program(
        audio, pyin_cfg, tables_from_numpy(audio, pyin_cfg, dev), financial,
        True, fetch_mel)
    with pyin_cuda.recording_launches():
        return program(samples, scale, rake).cpu().numpy()


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Bitwise equal buffers (NaN f0 too)."""
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def fused_ahead(dev, ys, **kw) -> list:
    """``ys`` dispatched ahead, all queued before any is fetched, as the
    folder does: each track's fetched rows."""
    handles = [dispatch_analyze(y, device=dev, **kw) for y in ys]
    return [fetch_analyze(h) for h in handles]


def fused_profile(dev, y, kw: dict, n: int = 3) -> dict:
    """The decode kernels a replay of ``y``'s fused graph runs, from the
    profiler's own kernel events over ``n`` replays (a replay's launches
    are counted from its capture, not measured): {kernel name: launches a
    replay} over ``VITERBI_KERNELS``."""
    kernels, _ = profile_kernels(lambda: fused_replayed(dev, y, **kw), n)
    return {k: sum(c for name, (_, c) in kernels.items() if k in name) / n
            for k in VITERBI_KERNELS}


def phase_fused_graph(dev) -> None:
    """Every fused dispatch replays one captured graph a key: at each of
    the benchmark's six length buckets @ 44 100 Hz, at n = 450 and
    n = 900, the replay's packed buffer bitwise the eager program's, one
    launch of each kernel counted a replay at the bucket's shape and the
    captured decode naming its kernel; a second dispatch captures
    nothing.  Prints each capture's seconds (the first dispatch, its
    eager warm-up included), the eager and replayed wall ms, and the peak
    device memory with the buckets captured.  At 60 s the profiler's own
    kernel events must show one forward kernel, the one the launch rule
    picks, and one of each backtrace kernel a replay."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for res, kernel in ((0.1, "viterbi_fwd_kernel"),
                        (0.05, "viterbi_fwd_wide_kernel")):
        cfg = PyinConfig(resolution=res)
        kw = fused_args(44100, cfg)
        n = cfg.n_pitch_bins
        w = tables_from_numpy(kw["audio"], cfg, dev).half_width
        for i, sec in enumerate(FUSED_BUCKET_SECONDS):
            y = generate_bench_track(float(sec), sr=44100, seed=42 + i)
            T = kw["audio"].n_frames(len(pad_to_bucket(y)))
            eager = fused_eager(dev, y, **kw)
            torch.cuda.synchronize()
            fresh = fused_graph(dev, y, **kw) is None
            reset_counts()
            t0 = time.perf_counter()
            first = fused_replayed(dev, y, **kw)
            capture_s = time.perf_counter() - t0
            graph = fused_graph(dev, y, **kw)
            ms = {}
            for name, fn in (("eager", lambda: fused_eager(dev, y, **kw)),
                             ("replayed",
                              lambda: fused_replayed(dev, y, **kw))):
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = fn()
                    walls.append(1e3 * (time.perf_counter() - t0))
                ms[name] = float(np.median(walls))
            want = {"viterbi_fwd": {(1, T, n, w): 4},
                    "viterbi_back": {(1, T, n): 4}}
            row = {"phase": "fused_graph", "resolution": res, "seconds": sec,
                   "bucket": len(pad_to_bucket(y)), "T": T,
                   "captured_here": fresh, "capture_s": capture_s,
                   "replay_bitwise_eager": same_bytes(first, eager)
                   and same_bytes(got, eager),
                   "counted": pyin_cuda.SHAPES == want,
                   "decodes": [a["kernel"] for a in graph.captured.decodes],
                   "captured_nothing_again":
                       fused_graph(dev, y, **kw) is graph,
                   "eager_wall_ms_median": ms["eager"],
                   "replayed_wall_ms_median": ms["replayed"],
                   "card": CARD["nvidia_smi"]}
            if sec == 60:
                row.update(replay_ms(graph.captured, 10))
                row["decode_kernels_a_replay_traced"] = fused_profile(
                    dev, y, kw)
            emit(row)
            if not (row["replay_bitwise_eager"] and row["counted"]
                    and row["decodes"] == [kernel]
                    and row["captured_nothing_again"]):
                raise AssertionError(f"fused graph: {row}")
            traced = row.get("decode_kernels_a_replay_traced")
            if traced is not None and traced != {
                    k: int(k == kernel or "_back" in k)
                    for k in VITERBI_KERNELS}:
                raise AssertionError(f"fused graph {res} {sec} s: decode "
                                     f"kernels a replay {traced}")
        torch.cuda.synchronize()
        emit({"phase": "fused_graph", "resolution": res,
              "graphs_cached": len(tanalyze.fused_graphs(
                  fused_key(dev, y, **kw)[-1])),
              "peak_bytes_since_phase_start":
                  torch.cuda.max_memory_allocated(dev),
              "allocated_bytes_above_phase_start":
                  torch.cuda.memory_allocated(dev) - base,
              "reserved_bytes": torch.cuda.memory_reserved(dev),
              "card": CARD["nvidia_smi"]})


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



# ----------------------------------------------------------------- serve

# the server's Phase-2 defaults (serve/server.py::_extract) with no query
SERVE_EXTRACT = dict(confidence_threshold=0.70, min_note_duration_ms=100,
                     sustain_ms=200, midi_program=27, noise_gate_db=-40.0,
                     use_onsets=True)


class Client:
    """HTTP calls to one server, each held to the status it must answer
    (a 500, or any status but the expected one, raises)."""

    def __init__(self, base: str):
        self.base = base
        self.calls = 0

    def call(self, method: str, path: str, body: bytes | None = None,
             expect: int = 200, ctype: str | None = None):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        if ctype:
            req.add_header("Content-Type", ctype)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                status, got_ctype, data = (r.status,
                                           r.headers.get("Content-Type"),
                                           r.read())
        except urllib.error.HTTPError as e:
            status, got_ctype, data = e.code, e.headers.get(
                "Content-Type"), e.read()
        ms = 1e3 * (time.perf_counter() - t0)
        self.calls += 1
        if status != expect:
            raise AssertionError(f"{method} {path}: status {status}, "
                                 f"expected {expect}: {data[:500]!r}")
        if got_ctype == "application/json":
            data = json.loads(data)
        return data, ms

    def json(self, method: str, path: str, body: bytes | None = None,
             expect: int = 200, ctype: str | None = None):
        return self.call(method, path, body, expect, ctype)[0]


def wav_bytes(y: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, y, sr)
    return buf.getvalue()


def decoded(data: bytes, sr: int, folder: str) -> np.ndarray:
    """An upload's samples as the server decodes them at ``sr``."""
    from aegis_tpu_torch.io.audio import load_audio

    fd, path = tempfile.mkstemp(suffix=".wav", dir=folder)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return load_audio(path, sr=sr)[0]


def phase_serve(dev, tracks, y10, errs, total: dict, per_call: dict) -> dict:
    """The REST server on the card, as ``AegisServer()`` builds it (44 100
    Hz, hop 512, device cuda) behind ThreadingHTTPServer on 127.0.0.1:
    health unprobed and probed; the 60 s bench track uploaded and analysed
    fused (auto -> fused), its events and MIDI equal to the facade's on the
    same decoded samples, truth F1 >= 0.99, one launch of each kernel a
    request, both kernels identical to their plain versions on the
    request's observations; turbo=tiles; a 10-minute upload (22 050 Hz,
    decoded at 44 100 Hz) under turbo=auto, reported "stream"; the neural
    backend (no Viterbi launch); refilter, midi, tabs, spectrogram;
    analyze-poly on chord seed 3 and analyze-auto on mixed seed 1 against
    their facades; reverse-analysis and adsr-synth on the analysed session;
    a live v1 session fed 0.5 s int16 chunks and polled every 2 s of
    audio, against a StreamingTranscriber run directly; four concurrent
    clients against their sequential answers.  Every request's status is
    checked.  Prints one line of per-endpoint warm medians of 5 request wall
    times beside the facade's, their difference, and device busy ms and
    launches of one profiled request.  Returns the kernels' times at the
    server's new launch shapes."""
    import threading
    from http.server import ThreadingHTTPServer

    from aegis_tpu_torch.serve.http import make_handler
    from aegis_tpu_torch.serve.server import AegisServer
    from aegis_tpu_torch.synth.adsr import synthesize_midi_adsr
    from aegis_tpu_torch.verify.reverse import reverse_analysis

    sr = 44100
    srv = AegisServer()
    if (srv.device.type != "cuda" or srv.engine.sr != sr
            or srv.engine.hop_length != HOP):
        raise AssertionError(f"serve: default server on {srv.device} at "
                             f"{srv.engine.sr} Hz, hop {srv.engine.hop_length}")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv.router))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    api = Client(f"http://127.0.0.1:{httpd.server_address[1]}")
    eng = AegisEngine(sample_rate=sr, device=dev)   # the facade
    times: dict = {}
    shapes: dict = {}
    folder = tempfile.mkdtemp()
    try:
        # ---- health: CUDA is up in this process already, so the unprobed
        # ping reports the card too
        h = api.json("GET", "/api/health")
        hp = api.json("GET", "/api/health?probe_device=1")
        row = {"phase": "serve", "what": "health", "unprobed": h,
               "probed": hp}
        emit(row)
        if (h["status"] != "ok" or hp["platform"] != "gpu"
                or hp["n_devices"] != torch.cuda.device_count()
                or hp["engine_sr"] != sr):
            raise AssertionError(f"serve health: {row}")

        # ---- the 60 s bench track, fused (turbo auto -> off)
        y, truth = tracks[sr]
        data = wav_bytes(y, sr)
        boundary = "aegisboundary"
        form = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"bench60.wav\"\r\n"
                f"Content-Type: audio/wav\r\n\r\n").encode() + data + \
            f"\r\n--{boundary}--\r\n".encode()
        sid = api.json("POST", "/api/upload", form,
                       ctype=f"multipart/form-data; boundary={boundary}"
                       )["session_id"]
        yd = decoded(data, sr, folder)
        (j, ms), counts, batch = run_counted(
            lambda: api.call("POST", f"/api/analyze/{sid}"))
        expect_launches("serve analyze", counts, batch, 1, 1)
        add_counts(total, counts)
        per_call["serve_analyze_44100"] = counts
        served = srv.sessions.get(sid)["events"]
        served_midi = base64.b64decode(j["midi_base64"])

        def facade_fused():
            raw = eng.audio_to_midi(yd, None, turbo_mode="off",
                                    stream_threshold_s=240.0,
                                    rake_sensitivity=0.6, pitch_backend="pyin")
            buf = io.BytesIO()
            return raw, eng.extract_events(raw, buf, **SERVE_EXTRACT), \
                buf.getvalue()

        raw, fev, fmidi = facade_fused()
        row = {"phase": "serve", "what": "analyze", "sr": sr,
               "analysis_mode": j["analysis_mode"], "events": j["num_events"],
               "events_equal_facade": served == fev,
               "midi_equal_facade": served_midi == fmidi,
               "truth_notes": len(truth),
               "truth_f1": f1_of(truth, events_to_seconds(served, sr, HOP)),
               "launches": counts, "request_ms": ms}
        emit(row)
        if (row["analysis_mode"] != "fused" or not row["events_equal_facade"]
                or not row["midi_equal_facade"] or row["truth_f1"] < 0.99):
            raise AssertionError(f"serve analyze: {row}")
        obs, vprob, tables = real_obs(yd, sr, dev)
        compare_kernels("serve_analyze_44100",
                        *tpyin.decode_inputs(obs[None], vprob[None]),
                        tables.band, tables.band_tab, tables.half_width, 1.0,
                        errs)

        # ---- turbo=tiles on the same session
        turbo = TurboConfig()
        n_tiles = n_tiles_of(yd, sr, turbo)
        (j, _), counts, batch = run_counted(
            lambda: api.call("POST", f"/api/analyze/{sid}?turbo=tiles"))
        expect_launches("serve tiles", counts, batch, 1, n_tiles)
        add_counts(total, counts)
        per_call["serve_tiles_44100"] = counts
        raw_t = eng.audio_to_midi(yd, None, turbo_mode="tiles")
        buf = io.BytesIO()
        tev = eng.extract_events(raw_t, buf, **SERVE_EXTRACT)
        row = {"phase": "serve", "what": "analyze_tiles", "sr": sr,
               "analysis_mode": j["analysis_mode"], "n_tiles": n_tiles,
               "events_equal_facade":
                   srv.sessions.get(sid)["events"] == tev,
               "midi_equal_facade":
                   base64.b64decode(j["midi_base64"]) == buf.getvalue(),
               "launches": counts}
        emit(row)
        if (j["analysis_mode"] != "tiles" or not row["events_equal_facade"]
                or not row["midi_equal_facade"]):
            raise AssertionError(f"serve tiles: {row}")

        # ---- the neural backend: no Viterbi launch
        (j, _), counts, _ = run_counted(lambda: api.call(
            "POST", f"/api/analyze/{sid}?pitch_backend=neural"))
        raw_n = eng.audio_to_midi(yd, None, turbo_mode="off",
                                  pitch_backend="neural")
        buf = io.BytesIO()
        nev = eng.extract_events(raw_n, buf, **SERVE_EXTRACT)
        row = {"phase": "serve", "what": "analyze_neural",
               "analysis_mode": j["analysis_mode"],
               "events": j["num_events"],
               "events_equal_facade": srv.sessions.get(sid)["events"] == nev,
               "midi_equal_facade":
                   base64.b64decode(j["midi_base64"]) == buf.getvalue(),
               "launches": counts}
        emit(row)
        if (any(counts.values()) or j["pitch_backend"] != "neural"
                or not row["events_equal_facade"]
                or not row["midi_equal_facade"]):
            raise AssertionError(f"serve neural: {row}")

        # ---- back to the pYIN analysis; Phase 2 endpoints on it
        api.call("POST", f"/api/analyze/{sid}")
        refilter_q = ("confidence_threshold=0.5&min_note_duration_ms=80"
                      "&sustain_ms=150&bpm=120")
        rj, _ = api.call("POST", f"/api/refilter/{sid}?{refilter_q}")
        buf = io.BytesIO()
        rev = eng.extract_events(raw, buf, **{
            **SERVE_EXTRACT, "confidence_threshold": 0.5,
            "min_note_duration_ms": 80, "sustain_ms": 150, "bpm": 120.0})
        midi, _ = api.call("GET", f"/api/midi/{sid}")
        tabs, _ = api.call("GET", f"/api/tabs/{sid}")
        spec, _ = api.call("GET", f"/api/spectrogram/{sid}")
        grid = base64.b64decode(spec["grid_base64"])
        row = {"phase": "serve", "what": "phase_two",
               "refilter_events": rj["num_events"],
               "refilter_equal_facade": (srv.sessions.get(sid)["events"]
                                         == rev and midi == buf.getvalue()),
               "tabs_notes": tabs["total_notes"],
               "spectrogram": [spec["frames"], spec["n_mels"],
                               spec["frame_step"]],
               "db_range": spec["db_range"]}
        emit(row)
        if (not row["refilter_equal_facade"] or not midi.startswith(b"MThd")
                or tabs["total_notes"] != len(rev)
                or len(grid) != spec["frames"] * spec["n_mels"]):
            raise AssertionError(f"serve phase two: {row}")

        # ---- reverse analysis and the ADSR synth on the analysed session
        (rv, _), counts, batch = run_counted(
            lambda: api.call("POST", f"/api/reverse-analysis/{sid}"))
        expect_launches("serve reverse-analysis", counts, batch, 1, 1)
        add_counts(total, counts)
        per_call["serve_reverse_44100"] = counts
        ref = reverse_analysis(midi, eng, sample_rate=sr)
        adsr, _ = api.call("POST", f"/api/adsr-synth/{sid}")
        wav_ref = synthesize_midi_adsr(midi, preset="electric_clean",
                                       sample_rate=sr, device=dev)
        row = {"phase": "serve", "what": "reverse_and_adsr", **rv,
               "launches": counts,
               "reverse_equal_facade": all(
                   rv[k] == (round(ref[k], 3) if isinstance(ref[k], float)
                             else ref[k]) for k in rv),
               "adsr_wav_equal_facade":
                   base64.b64decode(adsr["wav_base64"]) == wav_ref}
        emit(row)
        if not (row["reverse_equal_facade"] and row["adsr_wav_equal_facade"]):
            raise AssertionError(f"serve reverse / adsr: {row}")

        # ---- chords and the router against their facades
        chord, _ = generate_chord_progression(3, sr=sr)
        mixed, _ = generate_mixed_clip(1, sr=sr)
        cdata, mdata = wav_bytes(chord, sr), wav_bytes(mixed, sr)
        psid = api.json("POST", "/api/upload?name=chord3.wav",
                        cdata)["session_id"]
        asid = api.json("POST", "/api/upload?name=mixed1.wav",
                        mdata)["session_id"]
        (pj, _), counts, _ = run_counted(
            lambda: api.call("POST", f"/api/analyze-poly/{psid}"))
        if any(counts.values()):
            raise AssertionError(f"serve analyze-poly: a poly path launched "
                                 f"a Viterbi kernel {counts}")
        peng = AegisPolyEngine(sample_rate=sr, device=dev)
        buf = io.BytesIO()
        pev = peng.extract_events(peng.analyze(decoded(cdata, sr, folder)),
                                  buf, confidence_threshold=0.5,
                                  use_onsets=True, midi_program=25, bpm=None)
        pequal = (srv.sessions.get(psid)["events"] == pev
                  and base64.b64decode(pj["midi_base64"]) == buf.getvalue())
        (aj, _), counts, batch = run_counted(
            lambda: api.call("POST", f"/api/analyze-auto/{asid}"))
        expect_launches("serve analyze-auto", counts, batch, 1, 1)
        add_counts(total, counts)
        per_call["serve_auto_mixed1_44100"] = counts
        aeng = AegisAutoEngine(sample_rate=sr, device=dev)
        ymixed = decoded(mdata, sr, folder)
        buf = io.BytesIO()
        aev = aeng.extract_events(aeng.analyze(ymixed), buf, midi_program=25,
                                  bpm=None)
        aequal = (srv.sessions.get(asid)["events"] == aev
                  and base64.b64decode(aj["midi_base64"]) == buf.getvalue())
        row = {"phase": "serve", "what": "poly_and_auto",
               "poly_events": pj["num_events"], "poly_equal_facade": pequal,
               "poly_hop": pj["hop_length"], "auto_events": aj["num_events"],
               "auto_equal_facade": aequal, "auto_hop": aj["hop_length"],
               "auto_launches": counts}
        emit(row)
        if not (pequal and aequal) or not pj["num_events"] \
                or not aj["num_events"]:
            raise AssertionError(f"serve poly / auto: {row}")
        obs_a, vprob_a, tables_a = real_obs(ymixed, sr, dev, aeng.hop_length)
        compare_kernels("serve_auto_mixed1_44100",
                        *tpyin.decode_inputs(obs_a[None], vprob_a[None]),
                        tables_a.band, tables_a.band_tab,
                        tables_a.half_width, 1.0, errs)
        shapes["auto_mixed1"] = time_kernels(obs_a[None], vprob_a[None],
                                             tables_a, False)

        # ---- ten minutes under turbo=auto: the streamed slabs
        data10 = wav_bytes(y10, 22050)
        sid10, up10_ms = api.call("POST", "/api/upload?name=bench600.wav",
                                  data10)
        sid10 = sid10["session_id"]
        y10d = decoded(data10, sr, folder)
        (j10, ms10), counts, batch = run_counted(
            lambda: api.call("POST", f"/api/analyze/{sid10}"))
        n10 = n_tiles_of(y10d, sr, turbo)
        slabs = -(-n10 // 16)
        expect_launches("serve stream", counts, batch, slabs)
        add_counts(total, counts)
        per_call["serve_stream_44100"] = counts
        t0 = time.perf_counter()
        raw10 = eng.audio_to_midi(y10d, None, turbo_mode="stream")
        ev10 = eng.extract_events(raw10, io.BytesIO(), **SERVE_EXTRACT)
        facade10_ms = 1e3 * (time.perf_counter() - t0)
        row = {"phase": "serve", "what": "analyze_10_minutes",
               "analysis_mode": j10["analysis_mode"], "n_tiles": n10,
               "slabs": slabs, "events": j10["num_events"],
               "events_equal_facade":
                   srv.sessions.get(sid10)["events"] == ev10,
               "launches": counts}
        emit(row)
        if j10["analysis_mode"] != "stream" or not row["events_equal_facade"]:
            raise AssertionError(f"serve 10 minutes: {row}")
        obs_s, vprob_s, tables_s = tile_obs(
            y10d[:(16 * turbo.tile_frames - 1) * HOP], sr, dev, turbo)
        compare_kernels("serve_stream_slab_44100",
                        *tpyin.decode_inputs(obs_s, vprob_s), tables_s.band,
                        tables_s.band_tab, tables_s.half_width, 1.0, errs)
        shapes["stream_slab_44100"] = time_kernels(obs_s, vprob_s, tables_s,
                                                   False)
        times["analyze_stream_10min"] = {
            "request_ms": ms10, "facade_ms": facade10_ms,
            "overhead_ms": ms10 - facade10_ms, "upload_ms": up10_ms,
            "runs": 1}
        del y10d, raw10

        # ---- a live v1 session against a StreamingTranscriber run directly
        start = api.json("POST", f"/api/stream-start?engine=v1&sr={sr}")
        lsid = start["session_id"]
        pcm = np.round(np.clip(y, -1, 1) * 32767).astype("<i2").tobytes()
        chunk = int(0.5 * sr) * 2
        feed_ms, poll_ms = [], []

        def serve_live():
            for k, i in enumerate(range(0, len(pcm), chunk)):
                feed_ms.append(api.call("POST", f"/api/stream-feed/{lsid}",
                                        pcm[i:i + chunk])[1])
                if k % 4 == 3:
                    poll_ms.append(api.call(
                        "GET", f"/api/stream-events/{lsid}")[1])
            return api.json("POST", f"/api/stream-finalize/{lsid}")

        fin, counts, batch = run_counted(serve_live)
        served_live = srv.sessions.get(lsid)["events"]
        tiles = counts["viterbi_fwd"]
        if batch["viterbi_fwd"] != 1 or counts["viterbi_back"] != tiles:
            raise AssertionError(f"serve live: launches {counts} {batch}")
        add_counts(total, counts)
        per_call["serve_live_44100"] = counts
        rt = StreamingTranscriber(audio=srv.engine.audio, tile_frames=24,
                                  halo_frames=8, rake_sensitivity=0.6,
                                  financial=False, confidence_threshold=0.5,
                                  device=dev)
        direct_feed_ms = []

        def direct_live():
            for k, i in enumerate(range(0, len(pcm), chunk)):
                x = np.frombuffer(pcm[i:i + chunk], dtype="<i2").astype(
                    np.float32) / 32768.0
                t0 = time.perf_counter()
                rt.feed(x)
                direct_feed_ms.append(1e3 * (time.perf_counter() - t0))
                if k % 4 == 3:
                    rt.poll_events()
            return rt.finalize()

        direct, dcounts, _ = run_counted(direct_live)
        row = {"phase": "serve", "what": "live_v1", "sr": sr,
               "lookahead_s": start["lookahead_s"],
               "hop_length": start["hop_length"], "feeds": len(feed_ms),
               "polls": len(poll_ms), "events": fin["num_events"],
               "events_equal_direct": served_live == direct,
               "launches": counts, "direct_launches": dcounts,
               "truth_f1": f1_of(truth, events_to_seconds(served_live, sr,
                                                          HOP))}
        emit(row)
        if (not row["events_equal_direct"] or counts != dcounts
                or not tiles or row["truth_f1"] < 0.99):
            raise AssertionError(f"serve live: {row}")
        times["stream_feed_0.5s"] = {
            "request_ms": float(np.median(feed_ms)),
            "facade_ms": float(np.median(direct_feed_ms)),
            "overhead_ms": float(np.median(feed_ms)
                                 - np.median(direct_feed_ms)),
            "runs": len(feed_ms)}
        times["stream_events_poll"] = {
            "request_ms": float(np.median(poll_ms)), "runs": len(poll_ms)}

        # ---- four clients at once, each against its sequential answer
        sids = [sid]
        for seed in (43, 44, 45):
            ys = generate_bench_track(60.0, sr=sr, seed=seed)
            sids.append(api.json("POST", f"/api/upload?name=s{seed}.wav",
                                 wav_bytes(ys, sr))["session_id"])
        sequential = [api.json("POST", f"/api/analyze/{s}") for s in sids]
        answers, failures = [None] * len(sids), []
        barrier = threading.Barrier(len(sids))

        def client(i):
            try:
                barrier.wait(timeout=60)
                answers[i] = api.json("POST", f"/api/analyze/{sids[i]}")
            except Exception as e:   # re-raised below, in this thread
                failures.append(e)

        def concurrent():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(sids))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if any(t.is_alive() for t in threads):
                raise AssertionError("serve concurrent: a client hangs")

        _, counts, _ = run_counted(concurrent)
        if failures:
            raise failures[0]
        add_counts(total, counts)
        row = {"phase": "serve", "what": "concurrent_clients",
               "clients": len(sids),
               "equal_sequential": [a == s for a, s in zip(answers,
                                                           sequential)],
               "events": [s["num_events"] for s in sequential],
               "launches": counts}
        emit(row)
        if not all(row["equal_sequential"]) or any(
                v != len(sids) for v in counts.values()):
            raise AssertionError(f"serve concurrent: {row}")

        # ---- per-endpoint times: request against the facade
        facade_poly = AegisPolyEngine(sample_rate=sr, device=dev)
        ychord = decoded(cdata, sr, folder)
        endpoints = {
            "analyze_tiles_60s": (
                lambda: api.call("POST", f"/api/analyze/{sid}?turbo=tiles"),
                lambda: eng.extract_events(eng.audio_to_midi(
                    yd, None, turbo_mode="tiles"), io.BytesIO(),
                    **SERVE_EXTRACT)),
            "analyze_neural_60s": (
                lambda: api.call(
                    "POST", f"/api/analyze/{sid}?pitch_backend=neural"),
                lambda: eng.extract_events(eng.audio_to_midi(
                    yd, None, turbo_mode="off", pitch_backend="neural"),
                    io.BytesIO(), **SERVE_EXTRACT)),
            "analyze_fused_60s": (
                lambda: api.call("POST", f"/api/analyze/{sid}"),
                facade_fused),
            "refilter": (
                lambda: api.call("POST", f"/api/refilter/{sid}?{refilter_q}"),
                lambda: eng.extract_events(raw, io.BytesIO(), **{
                    **SERVE_EXTRACT, "confidence_threshold": 0.5,
                    "min_note_duration_ms": 80, "sustain_ms": 150,
                    "bpm": 120.0})),
            "midi": (lambda: api.call("GET", f"/api/midi/{sid}"), None),
            "tabs": (lambda: api.call("GET", f"/api/tabs/{sid}"),
                     lambda: eng.generate_tabs(rev)),
            "spectrogram": (lambda: api.call("GET",
                                             f"/api/spectrogram/{sid}"),
                            None),
            "reverse_analysis": (
                lambda: api.call("POST", f"/api/reverse-analysis/{sid}"),
                lambda: reverse_analysis(midi, eng, sample_rate=sr)),
            "adsr_synth": (
                lambda: api.call("POST", f"/api/adsr-synth/{sid}"),
                lambda: synthesize_midi_adsr(midi, preset="electric_clean",
                                             sample_rate=sr, device=dev)),
            "analyze_poly_chord3": (
                lambda: api.call("POST", f"/api/analyze-poly/{psid}"),
                lambda: facade_poly.extract_events(
                    facade_poly.analyze(ychord), io.BytesIO(),
                    confidence_threshold=0.5, use_onsets=True,
                    midi_program=25, bpm=None)),
            "analyze_auto_mixed1": (
                lambda: api.call("POST", f"/api/analyze-auto/{asid}"),
                lambda: aeng.extract_events(aeng.analyze(ymixed),
                                            io.BytesIO(), midi_program=25,
                                            bpm=None)),
        }
        for name, (request, facade) in endpoints.items():
            req_ms = wall_ms(request)
            fac_ms = wall_ms(facade) if facade else None
            kernels, _ = profile_kernels(request)
            times[name] = {
                "request_ms": req_ms, "facade_ms": fac_ms,
                "overhead_ms": None if fac_ms is None else req_ms - fac_ms,
                "device_busy_ms": sum(us for us, _ in kernels.values()) / 1e3,
                "device_launches": sum(c for _, c in kernels.values()),
                "runs": 5}
        # parts of the overhead, timed alone: the facade in a fresh thread, the
        # upload's decode, the JSON of an analysis answer, base64 and JSON of
        # an ADSR answer
        from aegis_tpu_torch.io.audio import load_audio
        fd, path60 = tempfile.mkstemp(suffix=".wav", dir=folder)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        answer = api.json("POST", f"/api/analyze/{sid}")

        def in_a_new_thread(fn):
            # the server runs each request in a thread of its own
            t = threading.Thread(target=fn)
            t.start()
            t.join()

        host_parts = {
            "facade_fused_in_a_new_thread_ms": wall_ms(
                lambda: in_a_new_thread(facade_fused)),
            "wav_decode_60s_ms": wall_ms(lambda: load_audio(path60, sr=sr)),
            "json_analyze_answer_ms": wall_ms(lambda: json.dumps(answer)),
            "base64_json_adsr_answer_ms": wall_ms(lambda: json.dumps(
                {"wav_base64": base64.b64encode(wav_ref).decode()}))}
        emit({"phase": "times", "what": "serve_endpoints_ms", "sr": sr,
              "requests": api.calls, "host_parts_ms": host_parts,
              "note": "request_ms: warm median of 5 request wall times "
                      "(host clock; the answer ends every device wait); "
                      "facade_ms: the same work called directly on the "
                      "decoded samples; overhead_ms: their difference "
                      "(upload decode, JSON and base64, HTTP); "
                      "device_busy_ms / device_launches: torch.profiler "
                      "over one request",
              "endpoints": times, "card": CARD["nvidia_smi"]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        shutil.rmtree(folder, ignore_errors=True)
    return shapes


# The JAX trainer on the CPU at the train command's defaults (3000 steps,
# batch 256, 2048 clips x 16 384 samples, seed 0), run once as
#   JAX_PLATFORMS=cpu python -m aegis_tpu.models.train --steps 3000 \
#       --out <a temporary path>
# its final JSON line and its first logged loss (step 0).  The port's
# freshly trained net on the card is gated at these less TRAIN_SLACK.
JAX_CPU_TRAIN = {"loss": 1.6413973569869995, "steps": 3000,
                 "rpa_50c": 0.9274486094316807,
                 "voicing_acc": 0.9232851985559567,
                 "median_cents_err": 4.273811340332031, "n_eval_frames": 827}
JAX_CPU_TRAIN_FIRST_LOSS = 6.0545
TRAIN_SLACK = 0.03
# The JAX tools on the CPU: tools/validate_device.py::validate(
# include_bench=False) (every F1 of every clip is 1.0), and
# tools/inharmonic_sweep.py's --quick rows (sweep(b_values=(0.0, 1e-4),
# mono_duration=10.0)).  The port's tools on the card are held to these.
JAX_CPU_VALIDATE_CLIPS = ("synthetic_track", "scale_track",
                          "synthetic_track_44k")
JAX_CPU_VALIDATE_POLY = ("chord_progression_s1_22050",
                         "chord_progression_s3_22050",
                         "chord_progression_s7_22050",
                         "chord_progression_s7_44100",
                         "chord_progression_s8_44100",
                         "chord_progression_s10_44100")
JAX_CPU_SWEEP_QUICK = {"0": {"v1": 0.9818, "financial": 0.9818,
                             "neural": 0.9818, "poly_mean": 1.0,
                             "poly_min": 1.0},
                       "0.0001": {"v1": 0.9492, "financial": 0.9492,
                                  "neural": 0.9492, "poly_mean": 1.0,
                                  "poly_min": 1.0}}
PACKAGED_WEIGHTS = "aegis_tpu_torch/models/weights/pitchnet_v1.npz"


def tone(sr: int, f: float, dur: float = 1.0, decay: float = 2.0):
    """tests/test_pitchnet.py's clean tone: three harmonics, decaying."""
    t = np.arange(int(sr * dur)) / sr
    env = np.exp(-decay * t)
    y = env * sum(a * np.sin(2 * np.pi * f * (k + 1) * t)
                  for k, a in enumerate([1.0, 0.5, 0.25]))
    return (0.8 * y / np.max(np.abs(y))).astype(np.float32)


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def train_from_seed(dev, bank, batch: int, steps: int, seed: int, lr):
    """``steps`` training steps of a fresh net from ``seed``, its crops drawn
    on the card's generator: (net, optimizer, generator, step function)."""
    net, opt = tpn.init_train_state(seed, lr=lr, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    step = tpn.make_train_step(batch, lr=lr)
    for i in range(steps):
        step(net, opt, gen, i, *bank)
    return net, opt, gen, step


def card_vs_cpu_steps(dev, bank_cpu, batch: int, lr, steps: int = 8,
                      seed: int = 8):
    """``steps`` AdamW steps on the card and on the CPU from the same
    parameters and the same explicit crops of ``bank_cpu`` (tracks, scale,
    f0, voicing, label weights): (the largest parameter difference, the
    largest loss difference relative to the CPU's loss)."""
    bank = [t.to(dev) for t in bank_cpu]
    n_clips, clip_len = bank_cpu[0].shape
    cpu_net, cpu_opt = tpn.init_train_state(0, lr=lr, device="cpu")
    card_net, card_opt = tpn.init_train_state(0, lr=lr, device=dev)
    card_net.load_state_dict(cpu_net.state_dict())
    rng = np.random.default_rng(seed)
    loss_err = 0.0
    for i in range(steps):
        ci = torch.from_numpy(rng.integers(0, n_clips, batch))
        off = torch.from_numpy(rng.integers(0, clip_len - tpn.WIN + 1, batch))
        lc = float(tpn.train_on_batch(cpu_net, cpu_opt, lr(i), *tpn.crop_batch(
            *bank_cpu[:4], ci, off, bank_cpu[4])))
        lg = float(tpn.train_on_batch(card_net, card_opt, lr(i),
                                      *tpn.crop_batch(*bank[:4], ci.to(dev),
                                                      off.to(dev), bank[4])))
        loss_err = max(loss_err, abs(lc - lg) / lc)
    param_err = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(card_net.parameters(),
                                    cpu_net.parameters()))
    return param_err, loss_err


def phase_train(dev) -> dict:
    """The trainer at the train command's defaults on the card, then its
    parts: a warm step, its device work, determinism, the card against the
    CPU on the same crops, and the fresh net on clean tones."""
    before = sha256_of(PACKAGED_WEIGHTS)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "pitchnet.npz")
        (net, metrics), counts, _ = run_counted(
            lambda: ttrain.train(out=out, device=dev, log=records.append))
        tree = tpn.load_params(out)
    viterbi_launches_zero("train")
    data_s = records[0]["data_s"]
    logged = [r["loss"] for r in records[1:]]
    emit({"phase": "train", "metrics": metrics, "data_seconds": data_s,
          "first_loss": logged[0], "last_loss": logged[-1],
          "jax_cpu": JAX_CPU_TRAIN, "jax_cpu_first_loss":
          JAX_CPU_TRAIN_FIRST_LOSS, "nvidia_smi": CARD["nvidia_smi"]})
    if not (np.isfinite(logged).all() and logged[-1] < 0.5 * logged[0]):
        raise AssertionError(f"train: loss {logged[0]} -> {logged[-1]}")
    for k in ("rpa_50c", "voicing_acc"):
        if metrics[k] < JAX_CPU_TRAIN[k] - TRAIN_SLACK:
            raise AssertionError(f"train: {k} {metrics[k]} < the JAX "
                                 f"trainer's {JAX_CPU_TRAIN[k]} - "
                                 f"{TRAIN_SLACK}")

    # the fresh checkpoint through the neural program on the card
    fresh = tpn.pitchnet_from_numpy(tree, dev)
    for f in (110.0, 196.0, 440.0):
        res = tpn.run_analyze_neural(tone(tpn.SR_NATIVE, f), tpn.SR_NATIVE,
                                     512, fresh, fetch_mel=False, device=dev)
        v = res["voiced_flag"]
        cents = float(abs(1200 * np.log2(np.median(res["f0"][v]) / f))) \
            if v.any() else float("inf")
        emit({"phase": "train", "tone_hz": f, "voiced_share": float(v.mean()),
              "median_cents_err": cents})
        if v.mean() <= 0.5 or cents >= 50:
            raise AssertionError(f"train: the fresh net on {f} Hz: voiced "
                                 f"{v.mean()}, {cents} cents")

    # the step's parts on a bank of 256 clips (a step's work does not
    # depend on the bank's size)
    d = make_clips(256, 16384, seed=1)
    bank_cpu = [torch.from_numpy(d[k]) for k in ("tracks", "scale", "f0_hz",
                                                 "voiced", "label_w")]
    bank = [t.to(dev) for t in bank_cpu]
    lr = tpn.lr_schedule(3000)
    a, opt, gen, step = train_from_seed(dev, bank, 256, 50, 0, lr)
    b = train_from_seed(dev, bank, 256, 50, 0, lr)[0]
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters())):
        raise AssertionError("train: two 50-step runs from one seed differ")
    it = iter(range(50, 10 ** 6))
    step_ms = cuda_ms(lambda: [step(a, opt, gen, next(it), *bank)
                               for _ in range(20)]) / 20
    kernels, host_ms = profile_kernels(
        lambda: step(a, opt, gen, next(it), *bank), 20)
    if any(k.startswith("Optimizer.") for k in kernels):
        raise AssertionError("train: torch.optim's range counted as a kernel")
    busy = sum(us for us, _ in kernels.values()) / 20 / 1e3
    launches = sum(n for _, n in kernels.values()) / 20
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]

    # 8 steps on the card and on the CPU from the same parameters and crops
    param_err, loss_err = card_vs_cpu_steps(dev, bank_cpu, 256, lr)
    row = {"phase": "times", "what": "train_step", "batch": 256,
           "hidden": list(tpn.HIDDEN), "median_ms_a_step": step_ms,
           "steps_a_second": 1e3 / step_ms,
           "train_s_3000_steps": metrics["train_s"],
           "host_ms_a_step_profiled": host_ms,
           "device_busy_ms_a_step": busy, "launches_a_step": launches,
           "idle_share": 1.0 - busy / step_ms,
           "top_device_kernels": [[k[:70], us / 20 / 1e3, n // 20]
                                  for k, (us, n) in top],
           "eight_steps_card_vs_cpu_param_max_abs_err": param_err,
           "eight_steps_card_vs_cpu_loss_max_rel_err": loss_err,
           "nvidia_smi": CARD["nvidia_smi"]}
    emit(row)
    if param_err > 1e-5 or loss_err > 1e-5:
        raise AssertionError(f"train: 8 steps on the card vs the CPU differ "
                             f"by {param_err} (parameters), {loss_err} "
                             "(loss, relative)")
    if sha256_of(PACKAGED_WEIGHTS) != before:
        raise AssertionError("train: the packaged checkpoint changed")
    return row


def validate_clips() -> dict:
    """Every clip that validate(include_bench=False), run_benchmark(0.4) and
    sweep --quick run through a v1 and a financial call: name -> (rate,
    audio, what the kernels row calls it)."""
    return {
        "synthetic_track_22050": (
            22050, generate_test_track(sr=22050)[0],
            "validate_device: the Karplus-Strong gating clip at 22 050 Hz"),
        "scale_track_22050": (
            22050, generate_scale_benchmark(sr=22050)[0],
            "validate_device: the scale track (0.5 s a note) at 22 050 Hz"),
        "synthetic_track_44100": (
            44100, generate_test_track(sr=44100)[0],
            "validate_device: the Karplus-Strong gating clip at 44 100 Hz"),
        "benchmark_scale_22050": (
            22050, generate_scale_benchmark(sr=22050, note_duration=0.4)[0],
            "run_benchmark(0.4): the scale track (0.4 s a note) at "
            "22 050 Hz"),
        "sweep_melody_B0_22050": (
            22050, generate_bench_track(10.0, sr=22050, B=0.0),
            "inharmonic_sweep --quick: the 10 s melody, B = 0, at 22 050 Hz"),
        "sweep_melody_B1e-4_22050": (
            22050, generate_bench_track(10.0, sr=22050, B=1e-4),
            "inharmonic_sweep --quick: the 10 s melody, B = 1e-4, at "
            "22 050 Hz"),
    }


def launched_shapes() -> dict:
    """Each kernel's launches by shape since the counts were last reset."""
    return {k: dict(v) for k, v in pyin_cuda.SHAPES.items()}


def phase_validate(dev, errs: dict, total: dict) -> list:
    """The validation tools on the card: validate_device's quick gate, the
    benchmark, the quick inharmonicity sweep, each F1 against the JAX tools'
    on the CPU; then every clip they run: one launch of each kernel a v1
    call and a financial call, both kernels against their plain versions on
    its observations, timed.  Returns the kernels line's rows, one a clip."""
    tools = {}   # tool -> each kernel's launches by shape in its run
    t0 = time.perf_counter()
    res, counts, batch = run_counted(
        lambda: validate_device.validate(include_bench=False, device=dev))
    validate_s = time.perf_counter() - t0
    tools["validate"] = launched_shapes()
    # three clips, a v1 and a financial call each
    expect_launches("validate", counts, batch, 6, 1)
    add_counts(total, counts)
    emit({"phase": "validate", "seconds": validate_s, **res,
          "launches": counts})
    if not res["pass"]:
        raise AssertionError(f"validate: the gate failed {res}")
    for name in JAX_CPU_VALIDATE_CLIPS:
        row = res["clips"][name]
        if row["v1_f1"] != 1.0 or row["financial_f1"] != 1.0:
            raise AssertionError(f"validate {name}: {row} (the oracle F1 "
                                 "must be 1.0)")
        for k in ("pyin_truth_f1", "fin_truth_f1", "neural_truth_f1",
                  "neural_f1"):
            if abs(row[k] - 1.0) > TRUTH_SLACK:
                raise AssertionError(f"validate {name}: {k} {row[k]}, the "
                                     "JAX tool's is 1.0")
    for name in JAX_CPU_VALIDATE_POLY:
        pf1 = res["clips"][name]["poly_truth_f1"]
        if abs(pf1 - 1.0) > TRUTH_SLACK:
            raise AssertionError(f"validate {name}: poly truth F1 {pf1}, "
                                 "the JAX tool's is 1.0")

    bench, counts, batch = run_counted(
        lambda: benchmark.run_benchmark(duration_per_note=0.4, device=dev))
    tools["benchmark"] = launched_shapes()
    expect_launches("benchmark", counts, batch, 1, 1)
    add_counts(total, counts)
    emit({"phase": "validate", "what": "benchmark", **bench})
    if not bench["aegis"]["f1"] > bench["naive_baseline"]["f1"]:
        raise AssertionError(f"benchmark: the engine does not beat the "
                             f"naive baseline {bench}")

    t0 = time.perf_counter()
    swept, counts, batch = run_counted(
        lambda: inharmonic_sweep.sweep(b_values=(0.0, 1e-4),
                                       mono_duration=10.0, device=dev))
    sweep_s = time.perf_counter() - t0
    tools["sweep"] = launched_shapes()
    # two values of B, a v1 and a financial call each
    expect_launches("sweep", counts, batch, 4, 1)
    add_counts(total, counts)
    emit({"phase": "validate", "what": "inharmonic_sweep --quick",
          "seconds": sweep_s, **swept, "jax_cpu": JAX_CPU_SWEEP_QUICK})
    for b, ref in JAX_CPU_SWEEP_QUICK.items():
        for k, v in ref.items():
            got = swept["f1_by_B"][b][k]
            if abs(got - v) > TRUTH_SLACK:
                raise AssertionError(f"sweep B={b} {k}: F1 {got}, the JAX "
                                     f"tool's {v}")

    # every clip the tools ran: its launches a call, at its shape; both
    # kernels against their plain versions on its observations, timed
    rows, compared = [], set()
    for name, (sr, y, path) in validate_clips().items():
        obs, vprob, tables = real_obs(y, sr, dev)
        T, n = obs.shape
        w = tables.half_width
        shapes = {"viterbi_fwd": {(1, T, n, w): 1},
                  "viterbi_back": {(1, T, n): 1}}
        eng = AegisEngine(sample_rate=sr, device=dev)
        fin = AegisFinancialEngine(sample_rate=sr, device=dev)
        for what, fn in (("v1", lambda: eng.audio_to_midi(y, None)),
                         ("financial", lambda: fin.analyze(y,
                                                           fetch_mel=False))):
            _, counts, batch = run_counted(fn)
            expect_launches(f"validate {what} {name}", counts, batch, 1, 1)
            if launched_shapes() != shapes:
                raise AssertionError(f"validate {what} {name}: launched at "
                                     f"{launched_shapes()}, expected "
                                     f"{shapes}")
        lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
        compare_kernels(f"validate_{name}", lo_v, lo_u, tables.band,
                        tables.band_tab, w, 1.0, errs)
        row = time_kernels(obs[None], vprob[None], tables, False)
        emit({"phase": "times", "what": "viterbi_validate", "clip": name,
              "sr": sr, **row["shape"], "median_ms": row})
        rows.append((f"{path}; a v1 or a financial call", counts, row))
        compared |= {(k, s) for k, v in shapes.items() for s in v}

    # the tools' runs launched at no shape that was not held to the plain
    # versions above
    split = {tool: {k: {str(s): c for s, c in v.items()}
                    for k, v in got.items()} for tool, got in tools.items()}
    emit({"phase": "validate", "what": "launches_by_shape", **split})
    for tool, got in tools.items():
        for k, v in got.items():
            missed = [s for s in v if (k, s) not in compared]
            if missed:
                raise AssertionError(f"{tool}: {k} launched at {missed}, "
                                     "held to no plain version")
    return rows


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


# ----------------------------------------------------------- Streamlit apps
#
# Neither the GPU machine nor the CPU test box has streamlit, so the apps
# run headlessly through this recording stand-in: one home for phase 28 and
# tests/test_torch_apps.py.  It is test scaffolding, not a feature of the
# port.

class Upload:
    """What ``st.file_uploader`` returns: the bytes and a file name."""

    def __init__(self, data: bytes, name: str):
        self.name = name
        self._data = data

    def getvalue(self) -> bytes:
        return self._data


class Rerun(Exception):
    """``st.rerun()``: the script stops and runs again from the top."""


class _Box:
    """A container (sidebar, column, tab, status, expander, empty slot,
    progress bar): a context manager whose calls go to the stand-in."""

    def __init__(self, st):
        self._st = st

    def __getattr__(self, name):
        return getattr(self._st, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# the output calls of streamlit the apps make; each is recorded as
# (name, args, kwargs)
ST_OUTPUTS = ("set_page_config", "title", "header", "subheader", "caption",
              "markdown", "write", "info", "warning", "error", "success",
              "toast", "metric", "download_button", "code", "dataframe",
              "json", "audio", "line_chart", "bar_chart", "progress", "html")


class StreamlitStandIn(types.ModuleType):
    """A recording stand-in for ``streamlit``.  Input widgets answer from
    ``script`` (a label, or a widget's ``key``, -> value) or with their
    defaults; every output call is appended to ``log`` as (name, args,
    kwargs), file-like arguments as their bytes; ``session_state`` is a
    dict that lives across reruns, as Streamlit's does.  One ``run(main,
    **kw)`` is one rerun of an app."""

    def __init__(self, script: dict | None = None):
        super().__init__("streamlit")
        self.script = dict(script or {})
        self.session_state: dict = {}
        self.log: list = []
        self.sidebar = _Box(self)
        v1 = types.ModuleType("streamlit.components.v1")
        v1.html = lambda html, **kw: self._record("html", (html,), kw)
        self.components = types.ModuleType("streamlit.components")
        self.components.v1 = v1

    def __getattr__(self, name):
        if name not in ST_OUTPUTS:
            raise AttributeError(f"the streamlit stand-in has no {name!r}")
        return lambda *a, **kw: self._record(name, a, kw)

    def _record(self, name, args, kwargs):
        args = tuple(a.getvalue() if isinstance(a, io.BytesIO) else a
                     for a in args)
        self.log.append((name, args, kwargs))
        return _Box(self)

    def _answer(self, label, key, default):
        return self.script.get(key if key is not None else label, default)

    # ---- input widgets
    def radio(self, label, options, index=0, key=None, **kw):
        return self._answer(label, key, list(options)[index])

    def selectbox(self, label, options, index=0, key=None, **kw):
        return self._answer(label, key, list(options)[index])

    def checkbox(self, label, value=False, key=None, **kw):
        return self._answer(label, key, value)

    def slider(self, label, min_value=None, max_value=None, value=None,
               step=None, key=None, **kw):
        return self._answer(label, key,
                            min_value if value is None else value)

    def number_input(self, label, min_value=None, max_value=None, value=None,
                     step=None, key=None, **kw):
        return self._answer(label, key,
                            min_value if value is None else value)

    def text_input(self, label, value="", key=None, **kw):
        return self._answer(label, key, value)

    def text_area(self, label, value="", key=None, **kw):
        return self._answer(label, key, value)

    def button(self, label, key=None, **kw):
        return self._answer(label, key, False)

    def file_uploader(self, label, type=None, key=None, **kw):
        return self._answer(label, key, None)

    # ---- layout
    def columns(self, spec, **kw):
        return [_Box(self) for _ in range(spec if isinstance(spec, int)
                                          else len(spec))]

    def tabs(self, names):
        return [_Box(self) for _ in names]

    def status(self, *a, **kw):
        return _Box(self)

    def expander(self, *a, **kw):
        return _Box(self)

    def empty(self):
        return _Box(self)

    def rerun(self):
        raise Rerun()

    def run(self, main, **kw) -> list:
        """One rerun: ``main(**kw)`` with this stand-in imported as
        ``streamlit`` (and ``streamlit.components.v1``); returns the
        outputs it recorded.  An ``st.rerun()`` runs the script again, up
        to two times."""
        names = ("streamlit", "streamlit.components",
                 "streamlit.components.v1")
        saved = {k: sys.modules.get(k) for k in names}
        sys.modules.update(zip(names, (self, self.components,
                                       self.components.v1)))
        start = len(self.log)
        try:
            for _ in range(3):
                try:
                    main(**kw)
                    break
                except Rerun:
                    continue
            else:
                raise AssertionError(f"{main.__module__}: reran 3 times")
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
        return self.log[start:]


def outputs(log: list, name: str) -> list:
    """The argument tuples of every ``name`` call in a recorded log."""
    return [args for n, args, _ in log if n == name]


class DecodeInputs:
    """While entered, keeps the inputs of the first Viterbi decode at each
    forward shape (B, T, n, w) that any path launches: the app's own
    observations, for the comparison with the plain versions afterwards.
    Every launch of both kernels goes through
    ``pyin_cuda.viterbi_decode_cuda`` (``core/pyin.py::_decode_states``),
    but a live tile or a fused dispatch on the card replays a captured
    graph, which runs no Python: the first tile of each tile program, and
    the first replay of each fused graph, is also run through its eager
    program on the same inputs (launches recorded, not counted; 13a and
    13b hold the replays bitwise to those programs) to keep its decode's
    inputs."""

    def __init__(self):
        self.by_shape: dict = {}
        self._programs: set = set()

    def __enter__(self):
        from aegis_tpu_torch.engine.realtime import _TileProgram

        self._real = real = pyin_cuda.viterbi_decode_cuda
        self._tile = tile = _TileProgram.__call__
        self._fused = fused = tanalyze._FusedGraph.__call__

        def keep(lo_v, lo_u, band, n, w, log_stay, log_switch, tab=None):
            self.by_shape.setdefault((lo_v.shape[0], lo_v.shape[1], n, w),
                                     (lo_v, lo_u, band, tab))
            return real(lo_v, lo_u, band, n, w, log_stay, log_switch, tab)

        def keep_tile(program, slab16, scale, rake_sens, ref_power):
            ref_in = ref_power.clone()
            out = tile(program, slab16, scale, rake_sens, ref_power)
            if (program._graph is not None
                    and id(program) not in self._programs):
                self._programs.add(id(program))
                staged = tanalyze.Ingest(slab16, scale).upload(program.device)
                with pyin_cuda.recording_launches():
                    program.body(*staged,
                                 torch.tensor(rake_sens, dtype=torch.float32,
                                              device=program.device), ref_in)
            return out

        def keep_fused(graph, staged, rake):
            out = fused(graph, staged, rake)
            if id(graph) not in self._programs:
                self._programs.add(id(graph))
                with graph.replays.lock, pyin_cuda.recording_launches():
                    graph.program(graph.samples, graph.scale, graph.rake)
            return out

        pyin_cuda.viterbi_decode_cuda = keep
        _TileProgram.__call__ = keep_tile
        tanalyze._FusedGraph.__call__ = keep_fused
        return self

    def __exit__(self, *exc):
        from aegis_tpu_torch.engine.realtime import _TileProgram

        pyin_cuda.viterbi_decode_cuda = self._real
        _TileProgram.__call__ = self._tile
        tanalyze._FusedGraph.__call__ = self._fused
        return False


def app_rerun(name: str, st, main, expect=None, facade=None, prep=None,
              reps: int = 5, profile_st=None, **kw):
    """One app rerun on the card, through the entry point a user calls
    (``main``, once by the stand-in ``st``): counted first (each kernel's
    launches and their shapes; ``expect`` = (launches, batch) when given),
    then its wall ms as the warm median of ``reps`` CUDA-event timings
    (``prep`` before each undoes the session's Phase-1 cache where the
    rerun is a Phase-1 one; where ``reps`` is 0, the counted run's own wall
    time), the device busy ms and launches of one profiled rerun (of
    ``profile_st``'s session where it is given), and beside them the facade
    call's ms.  The facade's launches must equal the rerun's.  Returns (the
    counted rerun's log, its counts, its shapes, the facade's result)."""
    t_start = t0 = time.perf_counter()
    log, counts, batch = run_counted(lambda: st.run(main, **kw))
    first_ms = 1e3 * (time.perf_counter() - t0)
    shapes = launched_shapes()
    if expect is not None:
        expect_launches(f"apps {name}", counts, batch, *expect)
    row = {"phase": "apps", "rerun": name, "launches": counts,
           "shapes": {k: {str(s): c for s, c in v.items()}
                      for k, v in shapes.items()},
           "first_wall_ms": first_ms}
    mark = len(st.log)

    def once(session=st):
        if prep:
            prep()
        session.run(main, **kw)
        del session.log[mark if session is st else 0:]

    if reps:
        row["wall_ms"] = cuda_ms(once, reps)
    kernels, host_ms = profile_kernels(lambda: once(profile_st or st))
    row["device_busy_ms"] = sum(v[0] for v in kernels.values()) / 1e3
    row["device_launches"] = sum(v[1] for v in kernels.values())
    row["profiled_host_ms"] = host_ms
    if profile_st is not None:
        row["profiled"] = "the same session on a shorter upload"
    want = None
    if facade is not None:
        t0 = time.perf_counter()
        want, f_counts, _ = run_counted(facade)
        row["facade_first_ms"] = 1e3 * (time.perf_counter() - t0)
        f_shapes = launched_shapes()
        if (f_counts, f_shapes) != (counts, shapes):
            raise AssertionError(f"apps {name}: launched {counts} {shapes}, "
                                 f"its facade {f_counts} {f_shapes}")
        if reps:
            row["facade_ms"] = cuda_ms(facade, reps)
    row["card"] = CARD["nvidia_smi"]
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return log, counts, shapes, want


def midi_of(log) -> bytes:
    return outputs(log, "download_button")[0][1]


def tc_rows(events) -> list:
    return [{k: e[k] for k in ("note", "start", "end", "confidence",
                               "velocity", "track", "technique")}
            for e in events]


def expect_equal(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"apps {name}: the app's result differs from "
                             "the direct call's")


# the Tuning Center's and Tuner Pro's Phase-2 defaults, as their sliders
# give them; the Live Monitor's upload is the first APP_LIVE_S of the track
TC_EXTRACT = dict(confidence_threshold=0.30, noise_gate_db=-40,
                  min_note_duration_ms=60, sustain_ms=150, midi_program=27,
                  bpm=None)
TP_EXTRACT = dict(confidence_threshold=0.30, min_note_duration_ms=60,
                  sustain_ms=150)
APP_LIVE_S = 20.0
APP_PROFILE_LIVE_S = 2.0


def phase_apps(dev, tracks, errs: dict, total: dict, timed: dict) -> list:
    """The Streamlit apps on the card through the recording stand-in, one
    ``main(device=...)`` call a rerun, each against its facade on the same
    input: the Tuning Center (upload, a Phase-2 slider, turbo, stems,
    neural), Tuner Pro (the 30 s turbo analysis and one rerun a tab), the
    Live Monitor (v1, financial, poly), both financial apps, the stem lab,
    the MIDI sandbox, the collector studio and the dashboard.  Both kernels
    are held to their plain versions at B = 3, T = 1152, w = 51 on tile
    observations before Tuner Pro, and on the apps' own inputs at every
    shape the apps launch; timed at each shape ``timed`` lacks.  Returns the
    kernels line's rows, one an app path."""
    from aegis_tpu_torch.apps import (collector_studio, financial_batch,
                                      financial_realtime,
                                      intelligence_dashboard, live_monitor,
                                      midi_sandbox, stem_lab, tuner_pro,
                                      tuning_center)
    from aegis_tpu_torch.io.audio import load_audio
    from aegis_tpu_torch.midi import events_to_midi, events_to_midi_financial
    from aegis_tpu_torch.synth import fluidsynth
    from aegis_tpu_torch.synth.stems import separate_hpss
    from aegis_tpu_torch.verify.auto_match import auto_match_parameters
    from aegis_tpu_torch.verify.effect_loop import learning_loop
    from aegis_tpu_torch.verify.per_note import (generate_optimization_report,
                                                 optimize_all_notes)
    from aegis_tpu_torch.verify.reverse import reverse_analysis
    from aegis_tpu_torch.viz.piano_roll import render_piano_roll

    # no FluidSynth on the machine: the crossfade and the financial preview
    # render with the ADSR synth on the card
    os.environ["AEGIS_FLUIDSYNTH_BIN"] = os.path.join(
        tempfile.gettempdir(), "no-fluidsynth-here")
    fluidsynth._singleton = None
    y44, y22 = tracks[44100][0], tracks[22050][0]
    up44 = Upload(wav_bytes(y44, 44100), "bench60_44100.wav")
    up22 = Upload(wav_bytes(y22, 22050), "bench60_22050.wav")
    work = tempfile.mkdtemp()
    src = os.path.join(work, "bench60_44100.wav")
    with open(src, "wb") as f:
        f.write(up44.getvalue())
    paths = []   # (kernels-line path, counts, forward shape launched)

    def rerun(path, *a, **kw):
        log, counts, shapes, want = app_rerun(*a, **kw)
        add_counts(total, counts)
        for key in shapes["viterbi_fwd"]:
            paths.append((path, counts, key))
        return log, counts, shapes, want

    with DecodeInputs() as seen:
        # ------------------------------------------------ Tuning Center
        eng = AegisEngine(sample_rate=44100, device=dev)
        st = StreamlitStandIn({"Audio file": up44})
        state = st.session_state

        def tc_facade(data, turbo_mode=False, pitch_backend="pyin",
                      extract=TC_EXTRACT):
            def call():
                raw = eng.audio_to_midi(
                    data, None, start_time=0.0, end_time=None,
                    turbo_mode=turbo_mode, rake_sensitivity=0.6,
                    pitch_backend=pitch_backend)
                buf = io.BytesIO()
                events = eng.extract_events(raw, buf, **extract)
                return tc_rows(events), buf.getvalue()
            return call

        fused = tc_facade(up44.getvalue())
        log, _, _, want = rerun(
            "Tuning Center rerun 1 (upload): audio_to_midi fused, 60 s at "
            "44 100 Hz", "tuning_center: upload, defaults (Phase 1 + 2)", st,
            tuning_center.main, expect=(1, 1), facade=fused,
            prep=lambda: state.pop("p1_key"), device=dev)
        expect_equal("tuning_center upload", (outputs(log, "dataframe")[0][0],
                                              midi_of(log)), want)

        st.script["Confidence"] = 0.5
        raw = state["raw_data"]

        def phase2():
            buf = io.BytesIO()
            eng.extract_events(raw, buf, **dict(TC_EXTRACT,
                                                confidence_threshold=0.5))
            return buf.getvalue()

        log, _, _, want = rerun(
            None, "tuning_center: the confidence slider moved (Phase 2 only)",
            st, tuning_center.main, expect=(0,), facade=phase2, device=dev)
        expect_equal("tuning_center Phase 2", midi_of(log), want)

        st.script.update({"Confidence": 0.30,
                          "Turbo (sharded tiles)": True})
        turbo = tc_facade(up44.getvalue(), turbo_mode=True)
        log, _, _, want = rerun(
            "Tuning Center rerun 3: turbo tiles, 60 s at 44 100 Hz",
            "tuning_center: turbo", st, tuning_center.main,
            expect=(1, n_tiles_of(y44, 44100, TurboConfig())),
            facade=turbo, prep=lambda: state.pop("p1_key"), device=dev)
        expect_equal("tuning_center turbo", midi_of(log), want[1])

        st.script.update({"Turbo (sharded tiles)": False,
                          "Stem separation (Demucs, or on-device HPSS)": True})

        def stems_facade():
            with open(eng.separate_stems(src, work), "rb") as f:
                stem = f.read()
            return stem, tc_facade(stem)()[1]

        log, _, _, want = rerun(
            "Tuning Center rerun 4: the HPSS stem, then audio_to_midi fused, "
            "60 s at 44 100 Hz", "tuning_center: stems (HPSS, then Phase 1 "
            "on the stem)", st, tuning_center.main, expect=(1, 1),
            facade=stems_facade,
            prep=lambda: (state.pop("p1_key"), state.pop("stem_key")),
            device=dev)
        expect_equal("tuning_center stems", (state["stem_bytes"],
                                             midi_of(log)), want)

        st.script.update({"Stem separation (Demucs, or on-device HPSS)":
                          False, "Neural pitch tracker (PitchNet)": True})
        neural = tc_facade(up44.getvalue(), pitch_backend="neural")
        log, _, _, want = rerun(
            None, "tuning_center: neural", st, tuning_center.main,
            expect=(0,), facade=neural, prep=lambda: state.pop("p1_key"),
            device=dev)
        expect_equal("tuning_center neural", midi_of(log), want[1])

        # ---------------------- the new shape: B = 3, T = 1152, w = 51
        y30 = y44[:30 * 44100]
        tp_tiles = n_tiles_of(y30, 44100, TurboConfig())
        obs, vprob, tables = tile_obs(y30, 44100, dev, TurboConfig())
        key = (*obs.shape, tables.half_width)
        if key != (tp_tiles, 1152, CFG.n_pitch_bins, 51):
            raise AssertionError(f"Tuner Pro's tiles: {key}")
        lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
        compare_kernels("tuner_pro_tiles_44100", lo_v, lo_u, tables.band,
                        tables.band_tab, tables.half_width, 1.0, errs)
        timed[key] = time_kernels(obs, vprob, tables, False)
        emit({"phase": "times", "what": "viterbi_tuner_pro_tiles",
              **timed[key]["shape"], "median_ms": timed[key],
              "card": CARD["nvidia_smi"]})

        # ------------------------------------------------ Tuner Pro
        eng = AegisEngine(sample_rate=44100, device=dev)
        st = StreamlitStandIn({"Audio (first 30 s analyzed)": up44})
        state = st.session_state

        def tp_facade():
            raw = eng.audio_to_midi(up44.getvalue(), None, end_time=30.0,
                                    turbo_mode=True, pitch_backend="pyin")
            buf = io.BytesIO()
            events = eng.extract_events(raw, buf, **TP_EXTRACT)
            return raw, events, buf.getvalue()

        log, _, _, _ = rerun(
            "Tuner Pro: the first 30 s, turbo tiles at 44 100 Hz",
            "tuner_pro: the 30 s turbo analysis", st, tuner_pro.main,
            expect=(1, tp_tiles), facade=lambda: tp_facade()[2],
            prep=lambda: state.pop("pro_key"), device=dev)
        raw, events, midi = tp_facade()
        expect_equal("tuner_pro analysis", midi_of(log), midi)
        tabs = (
            ("auto-match", {"🔍 Auto-match parameters (54 combos)": True},
             None, lambda: auto_match_parameters(raw["y"], eng, raw,
                                                 sample_rate=44100)),
            ("crossfade", {"Render crossfade": True}, (0,), None),
            ("reverse", {"🔄 Reverse analysis": True}, (1, 1),
             lambda: reverse_analysis(midi, eng, sample_rate=44100)),
            ("ADSR", {"Synthesize (ADSR)": True}, (0,), None),
            # the learning loop cut to two iterations
            ("effect loop", {"▶ Run learning loop": True}, None,
             lambda: learning_loop(midi, eng, preset="clean",
                                   max_iterations=2, sample_rate=44100)),
            ("per-note", {"⚙ Optimize every note": True}, None,
             lambda: generate_optimization_report(optimize_all_notes(
                 raw["y"], events, 44100, HOP, mode="quick", device=dev))))
        st.script["Max iterations"] = 2
        for tab, button, expect, direct in tabs:
            st.script.update(button)
            log, _, _, want = rerun(f"Tuner Pro: the {tab} tab, on the 30 s "
                              "analysis at 44 100 Hz", f"tuner_pro: {tab}",
                              st, tuner_pro.main, expect=expect,
                              facade=direct, device=dev)
            st.script.update(dict.fromkeys(button, False))
            if tab == "reverse":
                expect_equal("tuner_pro reverse",
                             [a[1] for a in outputs(log, "metric")],
                             [f"{want[k]:.1%}" for k in (
                                 "note_accuracy", "pitch_accuracy",
                                 "timing_accuracy")])
            elif tab == "effect loop":
                expect_equal("tuner_pro effect loop", outputs(log, "json"),
                             [(want["best_params"],)])
            elif direct is not None:
                expect_equal(f"tuner_pro {tab}", outputs(log, "json"),
                             [(want,)])
            elif not outputs(log, "audio"):
                raise AssertionError(f"tuner_pro {tab}: no audio")

        # ------------------------------------------------ Live Monitor
        live = Upload(wav_bytes(y22[:int(APP_LIVE_S * 22050)], 22050),
                      "live.wav")
        prof = Upload(wav_bytes(y22[:int(APP_PROFILE_LIVE_S * 22050)],
                                22050), "live_profile.wav")
        y_live, _ = load_audio(live.getvalue(), sr=22050)
        for kind in ("v1", "financial", "poly"):
            done = []

            def direct(kind=kind):
                rt = live_monitor.make_transcriber(kind, 22050, None,
                                                   device=dev)
                for _ in live_monitor.stream_in_chunks(rt, y_live, 22050,
                                                       2.0):
                    pass
                final = rt.finalize()
                done.append(rt)
                hop = getattr(rt, "hop", None) or rt.audio.hop_length
                return events_to_midi(final, 22050, hop, output=None)

            log, counts, shapes, want = rerun(
                f"Live Monitor {kind}, tile 24 / halo 8 at 22 050 Hz, one "
                "tile a launch", f"live_monitor: {kind}, {APP_LIVE_S:.0f} s "
                "in 2 s chunks", StreamlitStandIn({"Engine": kind,
                                                   "Audio": live}),
                live_monitor.main, facade=direct, reps=0,
                profile_st=StreamlitStandIn({"Engine": kind, "Audio": prof}),
                device=dev)
            tiles = 0 if kind == "poly" else len(done[-1]._rows)
            if (counts != dict.fromkeys(counts, tiles)
                    or any(key[0] != 1 for v in shapes.values() for key in v)):
                raise AssertionError(f"live_monitor {kind}: {counts} "
                                     f"{shapes}, {tiles} tiles")
            expect_equal(f"live_monitor {kind}", midi_of(log), want)

        # ------------------------------------- financial apps, 22 050 Hz
        fin = AegisFinancialEngine(sample_rate=22050, device=dev)

        def fin_batch_facade():
            events, info = fin.extract_events(
                fin.analyze(up22.getvalue()), confidence_threshold=None,
                min_note_duration_ms=50.0)
            return events_to_midi_financial(events, 22050, HOP,
                                            bpm=info.get("bpm"), output=None)

        log, _, _, want = rerun(
            "Financial batch: analyze fused, 60 s at 22 050 Hz",
            "financial_batch: convert", StreamlitStandIn(
                {"Audio": up22, "🚀 Convert": True}),
            financial_batch.main, expect=(1, 1), facade=fin_batch_facade,
            device=dev)
        expect_equal("financial_batch", midi_of(log), want)

        st = StreamlitStandIn({"Audio": up22})
        state = st.session_state

        def fin_rt_facade(analysis=None, min_dur=50):
            analysis = analysis or fin.analyze(
                up22.getvalue(), rake_sensitivity=0.6, use_guitar_filters=True,
                turbo_mode=False, pitch_backend="pyin")
            events, _ = fin.extract_events(
                analysis, confidence_threshold=None, noise_gate_db=-40,
                min_note_duration_ms=min_dur, sustain_ms=50,
                use_harmonic_filter=True)
            return events_to_midi_financial(events, 22050, HOP, output=None)

        log, _, _, want = rerun(
            "Financial realtime: analyze fused, 60 s at 22 050 Hz",
            "financial_realtime: upload (Phase 1 + 2)", st,
            financial_realtime.main, expect=(1, 1), facade=fin_rt_facade,
            prep=lambda: state.pop("fin_key"), device=dev)
        expect_equal("financial_realtime", midi_of(log), want)
        st.script["Min duration (ms)"] = 100
        phase2 = (lambda a=state["fin_analysis"]:
                  fin_rt_facade(a, min_dur=100))
        log, _, _, want = rerun(
            None, "financial_realtime: a Phase-2 slider moved", st,
            financial_realtime.main, expect=(0,), facade=phase2, device=dev)
        expect_equal("financial_realtime Phase 2", midi_of(log), want)

        # ------------------------------------------------ stem lab
        def hpss_facade():
            with tempfile.TemporaryDirectory() as out:
                stem_dir = os.path.dirname(separate_hpss(src, out, device=dev))
                stems = []
                for n in ("other.wav", "drums.wav"):
                    with open(os.path.join(stem_dir, n), "rb") as f:
                        stems.append(f.read())
                return stems

        log, _, _, want = rerun(
            None, "stem_lab: HPSS, 60 s at 44 100 Hz",
            StreamlitStandIn({"Audio": up44, "Separate": True}),
            stem_lab.main, expect=(0,), facade=hpss_facade, device=dev)
        expect_equal("stem_lab", [a[1] for a in outputs(log,
                                                        "download_button")],
                     want)

        # ---------------------- MIDI sandbox, on Tuner Pro's 30 s MIDI
        for name in ("svg", "html_midi_player", "tonejs", "webaudiofont"):
            roll = (lambda e=name: render_piano_roll(midi, engine=e,
                                                     device=dev))
            log, _, _, want = rerun(
                None, f"midi_sandbox: {name}",
                StreamlitStandIn({"MIDI file": Upload(midi, "tp.mid"),
                                  "Engine": name}),
                midi_sandbox.main, expect=(0,), facade=roll, device=dev)
            expect_equal(f"midi_sandbox {name}",
                         outputs(log, "download_button")[0][1], want)

        # ------------------------- the collector apps: no device work
        for main_, script in (
                (collector_studio.main,
                 {"Mode": "Mega batch", "Output folder": work,
                  "Batch queries (one per line)": "a",
                  "🚀 Run mega batch": True}),
                (intelligence_dashboard.main, {"🔍 Scan trends": True})):
            rerun(None, main_.__module__.rsplit(".", 1)[1],
                  StreamlitStandIn(script), main_, expect=(0,))
    shutil.rmtree(work)

    # both kernels against their plain versions on the apps' own inputs at
    # every shape they launched, and timed at each shape no phase timed
    for key in sorted({key for _, _, key in paths}):
        if key not in seen.by_shape:
            raise AssertionError(f"apps: a launch at {key} held to no plain "
                                 "version")
        lo_v, lo_u, band, tab = seen.by_shape[key]
        compare_kernels(f"apps_B{key[0]}_T{key[1]}_w{key[3]}", lo_v, lo_u,
                        band, tab, key[3], 1.0, errs)
        if key not in timed:
            timed[key] = time_kernel_inputs(lo_v, lo_u, band, tab, key[3])
            emit({"phase": "times", "what": "viterbi_apps",
                  **timed[key]["shape"], "median_ms": timed[key],
                  "card": CARD["nvidia_smi"]})
    emit({"phase": "apps", "what": "launches_by_path",
          "paths": [[what, counts, list(key)] for what, counts, key in paths]})
    return [(what, counts, timed[key]) for what, counts, key in paths]


# ------------------------------------------------------------------- mesh

MESH_SEEDS = (42, 43, 44, 45)     # the four-track folder of phase 8
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH, MESH_TRAIN_CLIPS = 20, 256, 64


def mesh_train_batches() -> list:
    """The global crop batches of the mesh's training steps, as NumPy
    (windows, f0, voicing, label weights), from a seeded bank: the same
    crops for every world size."""
    d = make_clips(MESH_TRAIN_CLIPS, 16384, seed=3)
    bank = [torch.from_numpy(d[k]) for k in ("tracks", "scale", "f0_hz",
                                             "voiced", "label_w")]
    rng = np.random.default_rng(3)
    out = []
    for _ in range(MESH_TRAIN_STEPS):
        ci = torch.from_numpy(rng.integers(0, MESH_TRAIN_CLIPS,
                                           MESH_TRAIN_BATCH))
        off = torch.from_numpy(rng.integers(0, 16384 - tpn.WIN + 1,
                                            MESH_TRAIN_BATCH))
        out.append(tuple(t.numpy() for t in tpn.crop_batch(
            *bank[:4], ci, off, bank[4])))
    return out


def batch_events(out: dict, sr: int, financial: bool) -> list:
    """Each track's note events (seconds) of a batched analyze result, with
    the facades' extraction defaults (as transcribe_folder extracts)."""
    events = []
    for i in range(len(out["f0"])):
        r = {k: (v[i] if np.ndim(v) else v) for k, v in out.items()}
        if financial:
            ev, _ = AegisFinancialEngine(sample_rate=sr, device="cpu"
                                         ).extract_events(r)
        else:
            ev = AegisEngine(sample_rate=sr, device="cpu").extract_events(
                raw_of(r), None, confidence_threshold=0.3)
        events.append(secs(ev, sr))
    return events


def rows_close(got: dict, ref: dict) -> dict:
    """A mesh program's rows against the one-process program's: whether
    they are bit-equal, each discrete row's agreement, the largest float
    gap (f0 relative where both are voiced; mel_db in dB), and the gap of
    the distortion score, whose partial sums add in another order."""
    out = {"bit_equal": mesh_lib.results_equal(
        {k: v for k, v in got.items() if k != "distortion_score"},
        {k: v for k, v in ref.items() if k != "distortion_score"}),
        "discrete_agreement": 1.0, "float_max_gap": 0.0,
        "f0_max_rel_gap": 0.0, "mel_db_max_gap": 0.0,
        "distortion_score_max_gap": 0.0}
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.shape != b.shape:
            raise AssertionError(f"row {k}: shape {a.shape}, one process "
                                 f"{b.shape}")
        if b.dtype == bool or b.dtype.kind == "i":
            out["discrete_agreement"] = min(out["discrete_agreement"],
                                            float((a == b).mean()))
        elif k == "f0":
            m = ~np.isnan(a) & ~np.isnan(b)
            out["f0_max_rel_gap"] = float(np.max(
                np.abs(a[m] - b[m]) / b[m], initial=0.0))
        else:
            gap = float(np.nanmax(np.abs(a.astype(np.float64) - b),
                                  initial=0.0))
            key = {"mel_db": "mel_db_max_gap",
                   "distortion_score": "distortion_score_max_gap"}.get(
                       k, "float_max_gap")
            out[key] = max(out[key], gap)
    return out


def rows_close_enough(c: dict) -> bool:
    """Bit-equal, or the one-device parity tests' tolerances
    (tests/test_torch_turbo.py): discrete rows agree on more than 0.999,
    f0 within 1e-4 relative, other floats within 1e-4; mel_db within 1e-2
    dB: a rank's matmuls run on fewer rows than the one-process program's,
    and the dB of a bin far below the frame's energy keeps the cancellation
    of its DFT sums (3.5e-3 dB between blocks of 6 and 12 slabs in a CPU
    run of this phase at 1 s a track)."""
    return (c["bit_equal"] or (c["discrete_agreement"] > 0.999
                               and c["f0_max_rel_gap"] < 1e-4
                               and c["float_max_gap"] < 1e-4
                               and c["mel_db_max_gap"] < 1e-2)) \
        and c["distortion_score_max_gap"] < 1e-4


def rank_block_obs(ys: list, dev, rows: slice, tile_index, n_tiles: int):
    """The decode's observations (B, T, n) of one rank's block of the tiled
    batch program: its tracks ``rows``, its tiles ``tile_index``; the halos
    of the one-process slabs are the ones the mesh exchanges."""
    audio = AudioConfig(sample_rate=22050)
    turbo = TurboConfig()
    tables = tables_from_numpy(audio, CFG, dev)
    y16, scale = tturbo._tiled_inputs(
        np.stack(ys)[rows], n_tiles * turbo.tile_frames * HOP, "int16", dev)
    slabs = tturbo.tile_slabs(y16, scale, audio, CFG, turbo, n_tiles)
    slabs = slabs.reshape(y16.shape[0], n_tiles, -1)[:, tile_index]
    frames = tturbo._frame_slab(slabs.reshape(-1, slabs.shape[-1]),
                                turbo.tile_frames + 2 * turbo.halo_frames,
                                HOP, CFG.frame_length, 0)
    obs, vprob = tpyin.frame_observations(frames, 22050, CFG, tables)
    return obs, vprob, tables


def phase_mesh(dev, chord60, y10, errs: dict, total: dict,
               per_call: dict) -> dict:
    """The multi-device paths (utils/mesh.py) on the one card: a world of
    one NCCL rank in this process, each call on a (1, 1) mesh bit for bit
    equal to its one-process call with the same launches at the same
    shapes; two gloo ranks sharing the card at (2, 1) and (1, 2), equal to
    the one-process program on tile counts the time axis divides; the
    dryrun twin on both; each per-rank Viterbi shape held to the plain
    versions and timed.  Returns the kernels line's rows."""
    import torch.distributed as dist

    import graft_entry_torch

    audio = AudioConfig(sample_rate=22050)
    with_truth = [generate_bench_track(60.0, sr=22050, seed=s,
                                       return_truth=True) for s in MESH_SEEDS]
    ys = [y for y, _ in with_truth]
    batch = np.stack(ys)
    batches = mesh_train_batches()
    lrs = [tpn.lr_schedule(MESH_TRAIN_STEPS)(i)
           for i in range(MESH_TRAIN_STEPS)]
    tree = tpn.params_to_numpy(tpn.init_params(0, device="cpu"))
    calls = {
        "run_analyze_batch v1, 4 x 60 s": lambda **kw: tturbo.run_analyze_batch(
            batch, audio, CFG, device=dev, **kw),
        "run_analyze_batch financial, 4 x 60 s":
            lambda **kw: tturbo.run_analyze_batch(
                batch, audio, CFG, financial=True, device=dev, **kw),
        "run_analyze_poly_turbo, chord 60 s": lambda **kw:
            tturbo.run_analyze_poly_turbo(chord60, device=dev, **kw),
        "run_analyze_streamed, 10 minutes": lambda **kw:
            tturbo.run_analyze_streamed(y10, audio, CFG, device=dev, **kw),
        "run_analyze_neural_batch, 4 x 60 s": lambda **kw:
            tpn.run_analyze_neural_batch(batch, 22050, HOP, device=dev, **kw),
        f"train_on_batches, {MESH_TRAIN_STEPS} steps at batch "
        f"{MESH_TRAIN_BATCH}": lambda **kw: tpn.train_on_batches(
            tree, batches, lrs, device=dev, **kw),
    }
    # the one-process calls first, and their times: no process group yet
    refs = {name: run_counted(fn)[:2] + (launched_shapes(), cuda_ms(fn))
            for name, fn in calls.items()}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = mesh_lib.Mesh(1, 1, device="cuda")
            for name, fn in calls.items():
                out, counts, _ = run_counted(lambda: fn(mesh=mesh))
                shapes = launched_shapes()
                add_counts(total, counts)
                ref_out, ref_counts, ref_shapes, ref_ms = refs[name]
                row = {"phase": "mesh", "world": 1, "backend": mesh.backend,
                       "mesh": mesh.shape, "staging": mesh.staging,
                       "rank_devices": [str(mesh.device)], "call": name,
                       "bit_equal_to_one_process":
                           mesh_lib.results_equal(out, ref_out),
                       "launches": counts, "one_process_launches": ref_counts,
                       "shapes": {k: {str(s): c for s, c in v.items()}
                                  for k, v in shapes.items()},
                       "wall_ms": cuda_ms(lambda: fn(mesh=mesh)),
                       "one_process_wall_ms": ref_ms}
                emit(row)
                if not row["bit_equal_to_one_process"]:
                    raise AssertionError(f"mesh (1, 1) {name}: differs from "
                                         "the one-process call")
                if counts != ref_counts or shapes != ref_shapes:
                    raise AssertionError(f"mesh (1, 1) {name}: launches "
                                         f"{shapes}, one process {ref_shapes}")
                rows[name] = (counts, shapes)
        finally:
            dist.destroy_process_group()

    # two gloo ranks on the one card: tracks over data, tiles over time
    turbo = TurboConfig()
    cut = [y[:(2 * turbo.tile_frames - 1) * HOP] for y in ys]   # 2 tiles
    one = {"v1": tturbo.run_analyze_batch(batch, audio, CFG, device=dev),
           "financial": tturbo.run_analyze_batch(batch, audio, CFG,
                                                 financial=True, device=dev),
           "v1_cut": tturbo.run_analyze_batch(np.stack(cut), audio, CFG,
                                              device=dev),
           "financial_cut": tturbo.run_analyze_batch(
               np.stack(cut), audio, CFG, financial=True, device=dev),
           "neural": tpn.run_analyze_neural_batch(batch, 22050, HOP,
                                                  device=dev),
           "train": tpn.train_on_batches(tree, batches, lrs, device=dev)}
    C = mesh_lib.call
    gloo_calls = [
        ("v1", (2, 1), C(tturbo.run_analyze_batch, batch, audio, CFG,
                         mesh_shape=(2, 1), reps=5)),
        ("financial", (2, 1), C(tturbo.run_analyze_batch, batch, audio, CFG,
                                financial=True, mesh_shape=(2, 1), reps=5)),
        ("v1_cut", (1, 2), C(tturbo.run_analyze_batch, np.stack(cut), audio,
                             CFG, mesh_shape=(1, 2), reps=5)),
        ("financial_cut", (1, 2), C(tturbo.run_analyze_batch, np.stack(cut),
                                    audio, CFG, financial=True,
                                    mesh_shape=(1, 2), reps=5)),
        ("neural", (2, 1), C(tpn.run_analyze_neural_batch, batch, 22050, HOP,
                             mesh_shape=(2, 1), reps=5)),
        ("train", (2, 1), C(tpn.train_on_batches, tree, batches, lrs,
                            mesh_shape=(2, 1))),
        ("train_again", (2, 1), C(tpn.train_on_batches, tree, batches, lrs,
                                  mesh_shape=(2, 1))),
    ]
    t0 = time.perf_counter()
    records = mesh_lib.spmd(mesh_lib.run_calls, 2, 1,
                            [c for _, _, c in gloo_calls], device="cuda",
                            backend="gloo")
    spawn_s = time.perf_counter() - t0
    for rec in records[1:]:
        if not mesh_lib.results_equal(rec["result"], records[0]["result"]):
            raise AssertionError(f"gloo rank {rec['rank']} returned another "
                                 "result than rank 0")
    results = records[0]["result"]
    emit({"phase": "mesh", "world": 2, "backend": records[0]["backend"],
          "staging": records[0]["staging"], "spawn_and_run_s": spawn_s,
          "rank_devices": [r["device"] for r in records]})
    if records[0]["staging"] != "host":
        raise AssertionError("gloo on CUDA must stage through the host")

    at = {key: i for i, (key, _, _) in enumerate(gloo_calls)}
    checked = {}   # per-rank shape -> its kernels row
    for i, (key, shape, _) in enumerate(gloo_calls):
        got = results[i]
        per_rank = [r["calls"][i] for r in records]
        row = {"phase": "mesh", "world": 2, "backend": "gloo",
               "mesh": per_rank[0]["mesh"], "call": key,
               "wall_ms_per_rank": [statistics.median(c["ms"])
                                    for c in per_rank],
               "launches_per_rank": [c["launches"] for c in per_rank],
               "shapes_per_rank": [{k: {str(s): n for s, n in v.items()}
                                    for k, v in c["shapes"].items()}
                                   for c in per_rank]}
        for c in per_rank:
            add_counts(total, c["launches"])
        if key.startswith("train"):
            losses, ref_losses = got[1], one["train"][1]
            row["loss_max_rel_gap_vs_world_1"] = float(np.max(
                np.abs(np.array(losses) - ref_losses) / np.abs(ref_losses)))
            row["bitwise_equal_to_the_other_run"] = mesh_lib.results_equal(
                results[at["train"]], results[at["train_again"]])
            emit(row)
            if row["loss_max_rel_gap_vs_world_1"] > 1e-5:
                raise AssertionError(f"gloo train: loss {losses} against "
                                     f"world 1 {ref_losses}")
            if not row["bitwise_equal_to_the_other_run"]:
                raise AssertionError("gloo train: two runs differ")
            continue
        row["rows_vs_one_process"] = close = rows_close(got, one[key])
        if key != "neural":
            fin = key.startswith("financial")
            ev, ev1 = (batch_events(got, 22050, fin),
                       batch_events(one[key], 22050, fin))
            row["f1_vs_one_process"] = min(f1_of(a, b)
                                           for a, b in zip(ev1, ev))
            if not key.endswith("_cut"):
                tr = [truth for _, truth in with_truth]
                row["truth_f1"] = [f1_of(t, e) for t, e in zip(tr, ev)]
                row["one_process_truth_f1"] = [f1_of(t, e)
                                               for t, e in zip(tr, ev1)]
        emit(row)
        if not rows_close_enough(close):
            raise AssertionError(f"gloo {key}: rows differ from the "
                                 f"one-process program: {close}")
        if row.get("f1_vs_one_process", 1.0) < 0.99:
            raise AssertionError(f"gloo {key}: F1 {row['f1_vs_one_process']}")
        for a, b in zip(row.get("truth_f1", []),
                        row.get("one_process_truth_f1", [])):
            if a < b - TRUTH_SLACK:
                raise AssertionError(f"gloo {key}: truth F1 {a} under {b}")
        want = 0 if key == "neural" else 1
        for c in per_rank:
            if any(n != want for n in c["launches"].values()):
                raise AssertionError(f"gloo {key}: launches {c['launches']}")
        # every per-rank shape held to the plain versions on that rank's
        # own observations, and timed
        n_tiles = 2 if key.endswith("_cut") else n_tiles_of(
            ys[0], 22050, turbo)
        for r, c in enumerate(per_rank):
            for s in c["shapes"]["viterbi_fwd"]:
                if s in checked:
                    continue
                data_i, time_i = divmod(r, shape[1])
                b = len(ys) // shape[0]
                k = n_tiles // shape[1]
                obs, vprob, tables = rank_block_obs(
                    cut if key.endswith("_cut") else ys, dev,
                    slice(data_i * b, (data_i + 1) * b),
                    slice(time_i * k, (time_i + 1) * k), n_tiles)
                lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
                if tuple(lo_v.shape[:2]) + (CFG.n_pitch_bins,
                                            tables.half_width) != s:
                    raise AssertionError(f"gloo {key}: rank {r} launched "
                                         f"{s}, its block is {lo_v.shape}")
                compare_kernels(f"mesh_{key}_{shape}_rank{r}", lo_v, lo_u,
                                tables.band, tables.band_tab,
                                tables.half_width, 1.0, errs)
                trow = time_kernels(obs, vprob, tables, False)
                emit({"phase": "times", "what": "viterbi_mesh", "of": key,
                      "mesh": shape, "rank": r, **trow["shape"],
                      "median_ms": trow})
                checked[s] = (f"gloo mesh {shape} {key}: rank {r}'s block",
                              c["launches"], trow)

    # the world-1 NCCL shapes: the batch's B = 4 x 3 tiles (the stream's
    # slab shape is phase 7's)
    for name in ("run_analyze_batch v1, 4 x 60 s",
                 "run_analyze_batch financial, 4 x 60 s"):
        counts, shapes = rows[name]
        for s in shapes["viterbi_fwd"]:
            if s in checked:
                continue
            obs, vprob, tables = rank_block_obs(
                ys, dev, slice(0, len(ys)), slice(None),
                n_tiles_of(ys[0], 22050, turbo))
            lo_v, lo_u = tpyin.decode_inputs(obs, vprob)
            compare_kernels("mesh_nccl_world1_batch", lo_v, lo_u, tables.band,
                            tables.band_tab, tables.half_width, 1.0, errs)
            trow = time_kernels(obs, vprob, tables, False)
            emit({"phase": "times", "what": "viterbi_mesh", "of": name,
                  "mesh": (1, 1), **trow["shape"], "median_ms": trow})
            checked[s] = (f"NCCL mesh (1, 1) {name}", counts, trow)
    stream_counts, stream_shapes = rows["run_analyze_streamed, 10 minutes"]
    per_call["mesh_stream"] = stream_counts

    # the dryrun twin: one NCCL rank, two gloo ranks on the card
    for n, backend in ((1, None), (2, "gloo")):
        t0 = time.perf_counter()
        res = graft_entry_torch.dryrun_multichip(n, device="cuda",
                                                 backend=backend)
        emit({"phase": "mesh", "what": "dryrun_multichip", "n": n,
              "backend": backend or "nccl", "seconds":
              time.perf_counter() - t0, **res})
    return {"checked": list(checked.values()),
            "stream": stream_counts}


# --------------------------------------------------------------------------
# Finer pitch grids (phase 30) and the warm-up command (phase 31)
# --------------------------------------------------------------------------

# (PyinConfig.resolution, rate) at hop 512 and the (n, w) each gives:
# (900, 101), (1125, 126), (900, 201), (2250, 251), (2250, 501)
GRID_CASES = ((0.05, 44100), (0.04, 44100), (0.05, 22050), (0.02, 44100),
              (0.02, 22050))
GRID_BATCHES = (1, 6, 16)
# grids over this many states decode a GRID_CUT_S cut of the track: the
# plain dense version would take over ~10 s on the 60 s track
GRID_CUT_STATES = 2000
GRID_CUT_S = 10.0
# the live session of phase 30 runs on the track's first GRID_LIVE_S
GRID_LIVE_S = 20.0
# Truth F1 of the JAX package on the CPU (JAX_PLATFORMS=cpu) at
# PyinConfig(resolution=0.05), 44 100 Hz, hop 512: the v1 engine fused on
# the 60 s bench track (audio_to_midi + extract_events at confidence 0.3;
# 150 events, 150 truth notes) and a StreamingTranscriber (tile 24, halo
# 8, confidence 0.5) fed the track's first GRID_LIVE_S in 0.5 s chunks,
# then finalized, against the truth notes that start in the cut.
JAX_CPU_GRID_TRUTH_F1 = {"fused": 1.0,   # 150 events, 150 truth notes
                         "live": 1.0}    # 49 events, 49 truth notes
GRID_TRUTH_SLACK = 0.01


def grid_windows(lo_v, lo_u, B: int):
    """B consecutive windows of one sequence's decode inputs (1, T, n) ->
    (B, T // B, n) and (B, T // B)."""
    T = lo_v.shape[1] // B
    return (lo_v[0, :B * T].reshape(B, T, -1).contiguous(),
            lo_u[0, :B * T].reshape(B, T).contiguous())


def truth_gate(what: str, f1: float, jax_f1: float) -> None:
    if f1 < 0.99 and f1 < jax_f1 - GRID_TRUTH_SLACK:
        raise AssertionError(f"{what}: truth F1 {f1} < 0.99 and more than "
                             f"{GRID_TRUTH_SLACK} under the JAX engine's "
                             f"{jax_f1}")


def phase_grids(dev, tracks, errs: dict, total: dict, per_call: dict) -> list:
    """Both kernels at the finer pitch grids, then the v1 engine fused and a
    live session at PyinConfig(resolution=0.05), 44 100 Hz (n = 900,
    w = 101) on the card against the same calls on the CPU.  Returns the
    (path, launches a call, timed row) entries of the kernels line."""
    smem = pyin_cuda.max_shared_memory(dev)
    rows, timed = [], {}
    for res, sr in GRID_CASES:
        cfg = PyinConfig(resolution=res)
        n = cfg.n_pitch_bins
        y = tracks[sr][0]
        if n > GRID_CUT_STATES:
            y = y[:int(GRID_CUT_S * sr)]
        obs, vprob, tables = real_obs(y, sr, dev, cfg=cfg)
        w = tables.half_width
        lo_v, lo_u = tpyin.decode_inputs(obs[None], vprob[None])
        for B in GRID_BATCHES:
            b_v, b_u = grid_windows(lo_v, lo_u, B) if B > 1 else (lo_v, lo_u)
            launch = pyin_cuda.pick_forward_variant(B, N_SMS, n, w, smem)
            name = f"grid_res{res}_{sr}_B{B}"
            compare_kernels(name, b_v, b_u, tables.band, tables.band_tab, w,
                            1.0, errs)
            row = time_kernel_inputs(b_v, b_u, tables.band, tables.band_tab,
                                     w, plain_reps=1)
            timed[(B, b_v.shape[1], n, w)] = row
            emit({"phase": "times", "what": "viterbi_grid", "case": name,
                  "resolution": res, "sr": sr, **row["shape"],
                  "variant": [launch.tile, launch.cluster],
                  "wide": launch.wide,
                  "threads": launch.threads, "passes": launch.passes,
                  "table_in_smem": launch.table_in_smem, "median_ms": row,
                  "card": CARD["nvidia_smi"]})
            rows.append((f"finer grid: resolution {res} @ {sr} Hz "
                         f"(n = {n}, w = {w}), B = {B}; both kernels held "
                         "to their plain versions (no main-path launch)",
                         {k: 0 for k in pyin_cuda.LAUNCHES}, row))

    # the main path at n = 900: the fused engine and a live session
    sr, cfg = 44100, PyinConfig(resolution=0.05)
    y, truth = tracks[sr]
    eng = AegisEngine(sample_rate=sr, device=dev)
    eng.pyin_cfg = cfg
    raw, counts, batch = run_counted(lambda: eng.audio_to_midi(y))
    shapes = {k: dict(v) for k, v in pyin_cuda.SHAPES.items()}
    expect_launches("grid fused", counts, batch, 1, 1)
    per_call["grid_fused_44100"] = counts
    add_counts(total, counts)
    events = eng.extract_events(raw, None, confidence_threshold=0.3)
    cpu = AegisEngine(sample_rate=sr, device="cpu")
    cpu.pyin_cfg = cfg
    ev_cpu = cpu.extract_events(cpu.audio_to_midi(y), None,
                                confidence_threshold=0.3)
    fused_row = {"phase": "grid_fused", "sr": sr, "resolution": 0.05,
                 "shapes": {k: [list(s) for s in v] for k, v in shapes.items()},
                 "events": len(events), "cpu_events": len(ev_cpu),
                 "events_equal_cpu": note_tuples(events) == note_tuples(ev_cpu),
                 "f1_vs_cpu": f1_of(secs(ev_cpu, sr), secs(events, sr)),
                 "truth_f1": f1_of(truth, secs(events, sr)),
                 "jax_cpu_truth_f1": JAX_CPU_GRID_TRUTH_F1["fused"]}
    emit(fused_row)
    if not fused_row["events_equal_cpu"]:
        raise AssertionError("grid fused: events differ from the CPU's")
    truth_gate("grid fused", fused_row["truth_f1"],
               JAX_CPU_GRID_TRUTH_F1["fused"])
    (fwd_shape,) = shapes["viterbi_fwd"]
    if fwd_shape not in timed:
        raise AssertionError(f"grid fused: launched at {fwd_shape}, not at "
                             "a checked n = 900 shape")
    rows.append(("audio_to_midi fused at PyinConfig(resolution=0.05), 60 s "
                 "at 44 100 Hz", counts, timed[fwd_shape]))

    y20 = y[:int(GRID_LIVE_S * sr)]
    truth20 = [dict(e, end=min(e["end"], GRID_LIVE_S)) for e in truth
               if e["start"] < GRID_LIVE_S]
    final, stats = live_session(dev, y20, sr, 24, 8, False, pyin_cfg=cfg)
    counts = dict(pyin_cuda.LAUNCHES)
    add_counts(total, counts)
    per_call["grid_live_44100"] = {k: 1 for k in counts}
    live_shapes = {k: dict(v) for k, v in pyin_cuda.SHAPES.items()}
    cpu_rt = live_transcriber("cpu", sr, 24, 8, False, cfg)
    for i in range(0, len(y20), sr // 2):
        cpu_rt.feed(y20[i:i + sr // 2])
    final_cpu = cpu_rt.finalize()
    live_row = {"phase": "grid_live", **stats, "resolution": 0.05,
                "shapes": {k: [list(s) for s in v]
                           for k, v in live_shapes.items()},
                "events_equal_cpu": final == final_cpu,
                "notes_equal_cpu": note_tuples(final) == note_tuples(final_cpu),
                "f1_vs_cpu": f1_of(secs(final_cpu, sr), secs(final, sr)),
                "truth_f1": f1_of(truth20, secs(final, sr)),
                "jax_cpu_truth_f1": JAX_CPU_GRID_TRUTH_F1["live"]}
    emit(live_row)
    if not live_row["notes_equal_cpu"]:
        raise AssertionError("grid live: events differ from the CPU's")
    truth_gate("grid live", live_row["truth_f1"],
               JAX_CPU_GRID_TRUTH_F1["live"])
    (live_fwd,) = live_shapes["viterbi_fwd"]
    if live_fwd[2:] != (900, 101):
        raise AssertionError(f"grid live: launched at {live_fwd}")
    # both kernels on the real observations of the first, a middle and the
    # last tile, timed on the middle one
    obs, vprob, tables = tile_obs(y20, sr, dev, TurboConfig(tile_frames=24,
                                                            halo_frames=8),
                                  cfg)
    n_t = obs.shape[0]
    for k in sorted({0, n_t // 2, n_t - 1}):
        tile_v, tile_u = tpyin.decode_inputs(obs[k:k + 1], vprob[k:k + 1])
        if (1, *tile_v.shape[1:2], 900, tables.half_width) != live_fwd:
            raise AssertionError(f"grid live: tile inputs {tile_v.shape}, "
                                 f"launched at {live_fwd}")
        compare_kernels(f"grid_live_44100_tile{k}", tile_v, tile_u,
                        tables.band, tables.band_tab, tables.half_width, 1.0,
                        errs)
    live_timed = time_kernel_inputs(
        *tpyin.decode_inputs(obs[n_t // 2:n_t // 2 + 1],
                             vprob[n_t // 2:n_t // 2 + 1]),
        tables.band, tables.band_tab, tables.half_width)
    emit({"phase": "times", "what": "viterbi_grid_live", **live_timed["shape"],
          "median_ms": live_timed, "card": CARD["nvidia_smi"]})
    rows.append(("live v1 at PyinConfig(resolution=0.05), tile 24 / halo 8, "
                 f"{GRID_LIVE_S:.0f} s at 44 100 Hz, one tile a launch",
                 per_call["grid_live_44100"], live_timed))
    return rows


def phase_warmup(tracks) -> dict:
    """The warm-up command in a fresh copy of the package: a cold
    transcribe (the nvcc and g++ builds included), then, with both builds
    deleted, ``warmup`` (which must build them again), then the same
    transcribe, which must build nothing and write the cold run's MIDI."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "checkout")
        shutil.copytree(os.path.join(here, "aegis_tpu_torch"),
                        os.path.join(root, "aegis_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        home = os.path.join(tmp, "home")
        os.makedirs(home)
        build_dir = os.path.join(root, "build", "aegis_tpu_torch")
        native_dir = os.path.join(home, ".cache", "aegis_tpu_torch", "native")
        wav = os.path.join(tmp, "bench60.wav")
        write_wav(wav, tracks[22050][0], 22050)
        env = {k: v for k, v in os.environ.items()
               if k not in ("AEGIS_CACHE_DIR", "PYTHONPATH")}
        env.update(HOME=home, PYTHONPATH=root)

        def run(*args):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "aegis_tpu_torch",
                                   *args], cwd=tmp, env=env,
                                  capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"{args[0]}: exit {proc.returncode}\n"
                                     f"{proc.stderr[-4000:]}")
            return seconds, proc.stdout

        def built():
            return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                    for d in (build_dir, native_dir) if os.path.isdir(d)
                    for f in sorted(os.listdir(d))}

        cold_s, _ = run("transcribe", wav, os.path.join(tmp, "cold.mid"),
                        "--sr", "22050")
        cold_built = built()
        if not any(f.endswith(".ptxas.txt") for f in cold_built) or not any(
                f.startswith(native_dir) for f in cold_built):
            raise AssertionError(f"warmup: the cold run built {cold_built}")
        for d in (build_dir, native_dir):
            shutil.rmtree(d)
        warm_s, out = run("warmup", "--seconds", "60", "--sr", "22050",
                          "--pipelines", "v1,financial,poly,live-v1")
        warm_lines = [ln for ln in out.splitlines() if ln.startswith("warm ")]
        after_warmup = built()
        if set(after_warmup) != set(cold_built):
            raise AssertionError(f"warmup built {sorted(after_warmup)}, the "
                                 f"cold run {sorted(cold_built)}")
        again_s, _ = run("transcribe", wav, os.path.join(tmp, "warm.mid"),
                         "--sr", "22050")
        if built() != after_warmup:
            raise AssertionError("warmup: the transcribe after it built "
                                 "again")
        with open(os.path.join(tmp, "cold.mid"), "rb") as f:
            cold_midi = f.read()
        with open(os.path.join(tmp, "warm.mid"), "rb") as f:
            warm_midi = f.read()
        row = {"phase": "warmup", "cold_transcribe_s": cold_s,
               "warmup_s": warm_s, "warm_lines": warm_lines,
               "transcribe_after_warmup_s": again_s,
               "built": sorted(os.path.basename(f) for f in after_warmup),
               "midi_equal": cold_midi == warm_midi,
               "midi_bytes": len(cold_midi), "card": CARD["nvidia_smi"]}
        emit(row)
        if len(warm_lines) != 4 or not row["midi_equal"] or not cold_midi:
            raise AssertionError(f"warmup: {row}")
        return row


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
    timed("live_graph", phase_live_graph, dev)
    timed("fused_graph", phase_fused_graph, dev)

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

    # the REST server on the card: every request through its HTTP routes
    serve_ms = timed("serve", phase_serve, dev, tracks, y10, errs, total,
                     per_call)

    # the PitchNet trainer (no hand kernel: it launches neither) and the
    # validation tools (their v1 and financial calls launch both)
    timed("train", phase_train, dev)
    validate_rows = timed("validate", phase_validate, dev, errs, total)

    # the Streamlit apps through the recording stand-in: their v1 and
    # financial paths launch both kernels, held to the plain versions at
    # every shape they launch and timed where no phase above timed them
    timed_shapes = {(r["shape"]["B"], r["shape"]["T"], r["shape"]["n"],
                     r["shape"]["w"]): r
                    for r in (fused_ms[22050], fused_ms[44100],
                              *tiles_ms.values(), auto_ms, reverse_ms,
                              *serve_ms.values(), *live_ms.values(),
                              *(row for _, _, row in validate_rows))}
    apps_rows = timed("apps", phase_apps, dev, tracks, errs, total,
                      timed_shapes)

    # the multi-device paths on the one card: a world of one NCCL rank, two
    # gloo ranks sharing the card, the dryrun twin
    mesh_rows = timed("mesh", phase_mesh, dev,
                      chord_tracks[("chord60", 22050)][0], y10, errs, total,
                      per_call)

    # the finer pitch grids (the wide forward kernel) and the warm-up
    # command in a fresh copy of the package
    grid_rows = timed("grids", phase_grids, dev, tracks, errs, total,
                      per_call)
    timed("warmup", phase_warmup, tracks)
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
        ("server POST /api/analyze (auto -> fused), 60 s at 44 100 Hz; "
         "times at the facade's shape above", per_call["serve_analyze_44100"],
         fused_ms[44100]),
        ("server POST /api/analyze?turbo=tiles, 60 s at 44 100 Hz; times at "
         "the facade's shape above", per_call["serve_tiles_44100"],
         tiles_ms["tiles60_44100"]),
        ("server POST /api/analyze (auto -> stream), 10 minutes uploaded at "
         "22 050 Hz, run at 44 100 Hz in slabs of 16 tiles",
         per_call["serve_stream_44100"], serve_ms["stream_slab_44100"]),
        ("server POST /api/analyze-auto, mixed clip seed 1 at 44 100 Hz, "
         "hop 1024", per_call["serve_auto_mixed1_44100"],
         serve_ms["auto_mixed1"]),
        ("server POST /api/reverse-analysis, 60 s at 44 100 Hz; times at "
         "the shape above", per_call["serve_reverse_44100"], reverse_ms),
        ("server /api/stream-* live v1, tile 24 / halo 8, 60 s at 44 100 Hz, "
         "one tile a launch; times at the shape above",
         per_call["serve_live_44100"], live_ms[(44100, 24, 8)]),
    ] + validate_rows + [
        (f"live v1, tile {tile} / halo {halo}, 60 s at {sr} Hz, one tile a "
         "launch", per_call[("live", sr, tile, halo)],
         live_ms[(sr, tile, halo)])
        for sr in (22050, 44100) for tile, halo in LIVE_PRESETS] + apps_rows + [
        ("mesh (1, 1) on NCCL: run_analyze_streamed, 10 minutes at 22 050 Hz "
         "in slabs of 16 tiles; times at the stream's shape above",
         mesh_rows["stream"], tiles_ms["stream_slab_22050"])
    ] + mesh_rows["checked"] + grid_rows

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
