"""The benchmark's takes: seeded guitar audio for the traffic mixes.

The generators are copies, code unchanged but for the stiff-string option
they do not use, of the port's ``tools/signal_gen.py`` (the ideal
Karplus-Strong string of ``karplus_strong``, recast to run twenty times
faster with the same samples, ``rake_burst``,
``generate_bench_track``, ``generate_chord_progression``), so that no later
change to the program moves the inputs.  ``make_takes`` builds a mix's
takes from its ``takes`` entry: the lengths are fixed by the mix, the seed
draws only the notes (or the chords), so every seed gives the same work.
The loads keep the takes under ``CACHE``, so a run with a seed that an
earlier run in the checkout had reads its takes instead of making them.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# where runs keep the takes they made, inside the checkout
CACHE = Path(__file__).resolve().parents[1] / "build" / "bench_torch" / "takes"


def _sub_seed(seed: int, i: int) -> List[int]:
    """Entropy of take ``i`` of run ``seed`` (any integer, however large)."""
    return [int(seed) % (1 << 64), int(i)]


def karplus_strong(frequency: float, duration: float, sr: int = 44100,
                   decay_factor: float = 0.996,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Plucked string: y[n] = x[n] + decay*0.5*(y[n-N] + y[n-N-1]) with a
    white-noise burst of length N as excitation.

    The program's version runs the recursion as ``scipy.signal.lfilter``
    with an (N + 2)-tap denominator; this one runs it a block of N samples
    at a time, each sample from the block before.  The sums are the same
    float64 operations in the same order, so the samples are equal bit for
    bit (``bench_torch/tests/test_harness.py``), about twenty times faster."""
    rng = rng or np.random.default_rng(0)
    N = int(sr / frequency)
    n_samples = int(sr * duration)
    x = np.zeros(n_samples)
    x[:N] = rng.uniform(-1, 1, min(N, n_samples))
    c = -(-0.5 * decay_factor)
    n_blocks = -(-n_samples // N)
    xp = np.zeros(n_blocks * N)
    xp[:n_samples] = x
    off = N + 1                      # y[-N-1 .. -1] are the zero history
    y = np.zeros(off + n_blocks * N)
    for k in range(n_blocks):
        s = off + k * N
        y[s:s + N] = xp[k * N:(k + 1) * N] + (c * y[s - N - 1:s - 1]
                                              + c * y[s - N:s])
    return y[off:off + n_samples].astype(np.float32)


def rake_burst(duration: float, sr: int = 44100,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Percussive broadband noise burst (a 'rake')."""
    rng = rng or np.random.default_rng(1)
    n = int(sr * duration)
    envelope = np.linspace(1.0, 0.0, n) ** 2
    return (rng.normal(0, 0.8, n) * envelope).astype(np.float32)


def generate_bench_track(duration: float = 60.0, sr: int = 22050,
                         seed: int = 42,
                         return_truth: bool = False) -> np.ndarray:
    """The headline-benchmark melody: Karplus-Strong plucks over a pentatonic
    walk with periodic rake bursts — representative of the real workload.
    Shared by bench.py and tools.validate_device so the F1 gate runs on the
    exact track the throughput number is measured on.

    With ``return_truth`` returns ``(audio, truth)`` where truth lists the
    sampled {note, start, end} in seconds — the ground truth the generator
    always knew but previously discarded.  Timeline bookkeeping: each pluck
    starts where the previous piece (pluck or rake) ended, so truth onsets
    account for the 20 ms rake insertions, and notes past the duration cut
    are dropped."""
    rng = np.random.default_rng(seed)
    notes = [40, 43, 45, 47, 50, 52, 55, 57, 60]
    pieces = []
    truth = []
    pos = 0  # samples appended so far == next piece's start
    t = 0.0
    i = 0
    while t < duration:
        note = notes[int(rng.integers(0, len(notes)))]
        freq = 440.0 * 2 ** ((note - 69) / 12)
        dur = float(rng.uniform(0.2, 0.6))
        pluck = karplus_strong(freq, dur, sr, rng=rng)
        truth.append({"note": note, "start": pos / sr,
                      "end": (pos + len(pluck)) / sr})
        pieces.append(pluck)
        pos += len(pluck)
        if i % 7 == 6:
            rake = rake_burst(0.02, sr, rng=rng)
            pieces.append(rake)
            pos += len(rake)
        t += dur
        i += 1
    n_out = int(duration * sr)
    y = np.concatenate(pieces)[:n_out]
    if len(y) < n_out:
        y = np.pad(y, (0, n_out - len(y)))
    y = (y / np.max(np.abs(y)) * 0.9).astype(np.float32)
    if not return_truth:
        return y
    truth = [dict(e, end=min(e["end"], duration)) for e in truth
             if e["start"] < duration]
    return y, truth


_CHORD_PROG = [([48, 52, 55], 0.9), ([53, 57], 0.7), ([55, 59, 62], 0.8),
               ([57], 0.6), ([57, 60, 64], 0.9)]


def generate_chord_progression(seed: int = 7, sr: int = 22050,
                               prog=None) -> Tuple[np.ndarray, List[dict]]:
    """A plucked chord progression (Karplus-Strong voices summed per chord)
    with exact note-event ground truth — the polyphonic engine's truth
    clip family (bench config 4 has no reference implementation, so
    generator truth is its accuracy anchor; tests/test_poly_truth.py).

    Includes a repeated-pitch chord boundary (57 -> 57+60+64) that defeats
    pitch-only segmentation, a two-voice and three three-voice chords, and
    per-seed random string rolloff/detune from karplus_strong's rng."""
    rng = np.random.default_rng(seed)
    prog = prog or _CHORD_PROG
    gap = np.zeros(int(0.15 * sr), np.float32)
    pieces, truth, pos = [gap], [], len(gap)
    for midis, dur in prog:
        n = int(sr * dur)
        y = np.zeros(n, np.float32)
        for m in midis:
            f = 440.0 * 2 ** ((m - 69) / 12)
            y[:n] += karplus_strong(f, dur, sr, rng=rng)[:n]
            truth.append({"note": m, "start": pos / sr,
                          "end": (pos + n) / sr})
        pieces.append(y)
        pos += n
        pieces.append(gap)
        pos += len(gap)
    y = np.concatenate(pieces)
    return (y / np.max(np.abs(y)) * 0.85).astype(np.float32), truth


def chord_section_take(duration: float, sr: int, seed, pool: Sequence,
                       chords_a_section: int) -> np.ndarray:
    """``duration`` seconds of ``generate_chord_progression`` sections,
    each a progression of ``chords_a_section`` chords drawn from ``pool``
    ([[midi notes], seconds] entries) by the seed, concatenated and cut."""
    rng = np.random.default_rng(seed)
    n_out = int(round(duration * sr))
    pieces, n = [], 0
    while n < n_out:
        pick = rng.integers(0, len(pool), chords_a_section)
        prog = [(list(pool[j][0]), float(pool[j][1])) for j in pick]
        y, _ = generate_chord_progression(
            seed=int(rng.integers(0, 1 << 62)), sr=sr, prog=prog)
        pieces.append(y)
        n += len(y)
    return np.concatenate(pieces)[:n_out].astype(np.float32)


def _make_take(spec: Dict, length: float, sub: List[int],
               sr: int) -> np.ndarray:
    if spec["generator"] == "bench_track":
        y = generate_bench_track(float(length), sr, seed=sub)
    elif spec["generator"] == "chord_sections":
        y = chord_section_take(float(length), sr, sub, spec["chord_pool"],
                               int(spec["chords_a_section"]))
    else:
        raise ValueError(f"unknown take generator {spec['generator']!r}")
    return np.round(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)


def make_takes(spec: Dict, seed: int, sr: int,
               cache: Optional[Path] = None) -> List[Tuple[str, np.ndarray]]:
    """[(name, int16 samples)] of a mix's ``takes`` entry:
    {"generator": "bench_track" | "chord_sections", "lengths_s": [...],
    and for chord sections "chord_pool" and "chords_a_section"}.

    With ``cache`` (a directory), each take is kept there as a ``.npy``
    file named by its generator, length and a hash of the generator's
    parameters, the length, the take's seed and the rate, and read back
    by any later run that asks for the same take."""
    params = {k: v for k, v in spec.items() if k != "lengths_s"}
    out = []
    for i, length in enumerate(spec["lengths_s"]):
        sub = _sub_seed(seed, i)
        name = f"take{i:02d}_{int(length)}s"
        if cache is None:
            out.append((name, _make_take(spec, length, sub, sr)))
            continue
        key = hashlib.sha256(json.dumps(
            [params, float(length), sub, int(sr)],
            sort_keys=True).encode()).hexdigest()[:24]
        path = Path(cache) / f"{spec['generator']}_{length}s_{key}.npy"
        if path.exists():
            out.append((name, np.load(path)))
            continue
        pcm = _make_take(spec, length, sub, sr)
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_name(f"{path.stem}.{os.getpid()}.part.npy")
        np.save(part, pcm)
        os.replace(part, path)
        out.append((name, pcm))
    return out


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """A mono 16-bit PCM RIFF/WAVE file of ``pcm`` (int16)."""
    data = np.asarray(pcm, "<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def pcm_float(pcm: np.ndarray) -> np.ndarray:
    """The float32 samples a 16-bit WAV decodes to (x / 32768)."""
    return np.asarray(pcm, np.int16).astype(np.float32) / 32768.0
