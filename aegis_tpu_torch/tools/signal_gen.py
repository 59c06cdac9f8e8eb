"""Synthetic test-signal generation — the framework's ground-truth oracle.

Mirrors the reference's evaluation fixtures (SURVEY.md §4):
  * Karplus-Strong plucked-string notes (generate_test_signal.py:5-42) —
    implemented as an IIR filter (scipy.lfilter) over a noise-burst impulse
    instead of the reference's per-sample Python loop.
  * enveloped broadband rake bursts (generate_test_signal.py:44-53)
  * the three-note E2/A2/D3 + rakes test track (generate_test_signal.py:55-97)
  * the C-major-scale sine benchmark with injected rake + hiss
    (benchmark_aegis.py:16-53), with its MIDI ground truth.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import signal as _signal

from aegis_tpu_torch.config import midi_to_hz
from aegis_tpu_torch.midi.smf import MidiFile, MidiMessage, MidiTrack


def karplus_strong(frequency: float, duration: float, sr: int = 44100,
                   decay_factor: float = 0.996,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Plucked string: y[n] = x[n] + decay*0.5*(y[n-N] + y[n-N-1]) with a
    white-noise burst of length N as excitation."""
    rng = rng or np.random.default_rng(0)
    N = int(sr / frequency)
    n_samples = int(sr * duration)
    x = np.zeros(n_samples)
    x[:N] = rng.uniform(-1, 1, min(N, n_samples))
    a = np.zeros(N + 2)
    a[0] = 1.0
    a[N] = -0.5 * decay_factor
    a[N + 1] = -0.5 * decay_factor
    return _signal.lfilter([1.0], a, x).astype(np.float32)


def pluck_inharmonic(frequency: float, duration: float, sr: int = 44100,
                     B: float = 1e-4,
                     rng: Optional[np.random.Generator] = None,
                     pluck_pos: float = 0.28, body: bool = True,
                     pick_level: float = 0.05) -> np.ndarray:
    """A REAL-string pluck model — the honest stand-in for the bench
    "real guitar WAV" config in a zero-egress image (BASELINE config 2;
    VERDICT r2 missing #2).  Karplus-Strong (the reference's generator,
    generate_test_signal.py:5-42) is IDEALLY harmonic with one shared
    decay; real strings differ in exactly the ways the analysis chain
    assumes away:

      * stiffness-stretched partials  f_n = n·f0·√(1 + B·n²)  with the
        physical inharmonicity coefficient B (measured guitar strings:
        ~1e-5 wound low strings .. ~1e-3 plain high strings) — h2 of a
        B=1e-3 string is 6.9 cents sharp of 2·f0, h5 is 41 cents sharp;
      * pluck-position comb amplitudes  a_n ∝ sin(π·n·β)/n  (β = relative
        plucking point; nulls every 1/β-th partial) instead of KS's
        smooth noise-shaped rolloff;
      * frequency-dependent damping  τ_n = τ₀/(1 + c₁·n + c₃·n³)  (air +
        internal friction rise with frequency) with per-seed τ₀;
      * a pick transient: ~5 ms of high-passed noise at the attack;
      * body resonance: 2nd-order resonators near the Helmholtz (~100 Hz)
        and top-plate (~210/420 Hz) modes, per-seed detuned ±8%.

    Additive synthesis (partials × time outer product) rather than a
    dispersive-allpass KS loop: it gives EXACT control of B for the
    sweep, and the generator bank is host-side test fixture code, not a
    device path.  B=0, body=False, pick_level=0 degenerates to an
    ideally-harmonic additive pluck (the control row of the sweep)."""
    rng = rng or np.random.default_rng(0)
    n_samples = int(sr * duration)
    t = np.arange(n_samples, dtype=np.float64) / sr
    n = np.arange(1, max(2, int(0.45 * sr / frequency)) + 1, dtype=np.float64)
    f_n = n * frequency * np.sqrt(1.0 + B * n * n)
    keep = f_n < 0.45 * sr
    n, f_n = n[keep], f_n[keep]
    beta = pluck_pos * float(rng.uniform(0.9, 1.1))
    amp = np.abs(np.sin(np.pi * n * beta)) / n
    tau0 = float(rng.uniform(0.6, 1.2)) * max(duration, 0.4)
    tau_n = tau0 / (1.0 + 0.15 * (n - 1) + 2e-4 * n ** 3)
    phase = rng.uniform(0, 2 * np.pi, len(n))
    # (partials, time) outer product — one vectorized pass
    y = (amp[:, None] * np.exp(-t[None, :] / tau_n[:, None])
         * np.sin(2 * np.pi * f_n[:, None] * t[None, :] + phase[:, None])
         ).sum(axis=0)
    if pick_level > 0:
        m = min(int(0.005 * sr), n_samples)
        burst = rng.normal(0, 1.0, m) * np.exp(-np.arange(m) / (0.0015 * sr))
        sos = _signal.butter(2, min(2000.0, 0.4 * sr / 2), "high",
                             fs=sr, output="sos")
        y[:m] += pick_level * _signal.sosfilt(sos, burst) * np.abs(y).max()
    if body:
        for f_b, q, g in ((100.0, 12.0, 0.35), (210.0, 16.0, 0.25),
                          (420.0, 18.0, 0.15)):
            fb = f_b * float(rng.uniform(0.92, 1.08))
            if fb < 0.45 * sr:
                b, a = _signal.iirpeak(fb, q, fs=sr)
                y = y + g * _signal.lfilter(b, a, y)
    peak = np.abs(y).max()
    return (y / peak if peak > 0 else y).astype(np.float32)


def _pluck(frequency: float, duration: float, sr: int,
           rng: Optional[np.random.Generator], B: float) -> np.ndarray:
    """Generator-bank dispatch: the ideal Karplus-Strong string (B <= 0,
    the reference's fixture physics and every pre-round-3 gate) or the
    stiff inharmonic model (B > 0, the realism sweep)."""
    if B <= 0:
        return karplus_strong(frequency, duration, sr, rng=rng)
    return pluck_inharmonic(frequency, duration, sr, B=B, rng=rng)


def rake_burst(duration: float, sr: int = 44100,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Percussive broadband noise burst (a 'rake')."""
    rng = rng or np.random.default_rng(1)
    n = int(sr * duration)
    envelope = np.linspace(1.0, 0.0, n) ** 2
    return (rng.normal(0, 0.8, n) * envelope).astype(np.float32)


def generate_test_track(sr: int = 44100, seed: int = 0) -> Tuple[np.ndarray, List[dict]]:
    """The canonical fixture: silence, E2, silence, rake, A2, rake, D3.

    Returns (track, truth) where truth lists {note, start, end} in seconds.
    """
    rng = np.random.default_rng(seed)
    e2 = karplus_strong(82.41, 1.0, sr, rng=rng)
    a2 = karplus_strong(110.00, 1.0, sr, rng=rng)
    d3 = karplus_strong(146.83, 1.5, sr, rng=rng)
    rake = rake_burst(0.025, sr, rng=rng)
    silence = np.zeros(int(0.2 * sr), np.float32)
    gap = np.zeros(1000, np.float32)

    parts = [silence, e2, silence, rake, gap, a2, silence, rake, d3]
    track = np.concatenate(parts)
    track = track / np.max(np.abs(track)) * 0.9

    t = 0.0
    truth = []
    for arr, note in zip(parts, [None, 40, None, None, None, 45, None, None, 50]):
        if note is not None:
            truth.append({"note": note, "start": t, "end": t + len(arr) / sr})
        t += len(arr) / sr
    return track.astype(np.float32), truth


def generate_scale_benchmark(
    sr: int = 22050, seed: int = 0, note_duration: float = 0.5,
    with_rake: bool = True, hiss: float = 0.02,
) -> Tuple[np.ndarray, bytes, List[dict]]:
    """C-major-scale sine audio with an injected rake burst and hiss, plus its
    ground-truth MIDI.  Returns (audio, midi_bytes, truth_notes)."""
    rng = np.random.default_rng(seed)
    notes = [60, 62, 64, 65, 67, 69, 71, 72]

    mid = MidiFile()
    track = MidiTrack()
    mid.tracks.append(track)
    ticks = 480  # one note per beat at 120 BPM = 0.5 s
    for n in notes:
        track.append(MidiMessage("note_on", note=n, velocity=80, time=0))
        track.append(MidiMessage("note_off", note=n, velocity=0, time=ticks))

    n_per = int(sr * note_duration)
    t = np.arange(n_per) / sr
    y = np.concatenate(
        [0.5 * np.sin(2 * np.pi * midi_to_hz(n) * t) for n in notes]
    )
    if with_rake:
        rs, rd = int(sr * 1.0), int(sr * 0.05)
        y[rs : rs + rd] += rng.normal(0, 0.8, rd)
    if hiss:
        y = y + rng.normal(0, hiss, len(y))

    truth = [
        {"note": n, "start": i * note_duration, "end": (i + 1) * note_duration}
        for i, n in enumerate(notes)
    ]
    return y.astype(np.float32), mid.save(None), truth


def two_tone(sr: int = 22050, f1: float = 196.0, f2: float = 293.66,
             dur: float = 0.7) -> np.ndarray:
    """Two decaying tones with a 2nd harmonic — a minimal clean fixture."""
    t = np.arange(int(sr * dur)) / sr
    decay = np.exp(-2 * t)

    def note(f):
        return (0.4 * np.sin(2 * np.pi * f * t)
                + 0.15 * np.sin(2 * np.pi * 2 * f * t)) * decay

    return np.concatenate(
        [note(f1), note(f2), np.zeros(sr // 4)]
    ).astype(np.float32)


def generate_bench_track(duration: float = 60.0, sr: int = 22050,
                         seed: int = 42,
                         return_truth: bool = False,
                         B: float = 0.0) -> np.ndarray:
    """The headline-benchmark melody: Karplus-Strong plucks over a pentatonic
    walk with periodic rake bursts — representative of the real workload.
    Shared by bench.py and tools.validate_device so the F1 gate runs on the
    exact track the throughput number is measured on.

    With ``return_truth`` returns ``(audio, truth)`` where truth lists the
    sampled {note, start, end} in seconds — the ground truth the generator
    always knew but previously discarded.  Timeline bookkeeping: each pluck
    starts where the previous piece (pluck or rake) ended, so truth onsets
    account for the 20 ms rake insertions, and notes past the duration cut
    are dropped.  ``B`` > 0 swaps the ideal Karplus-Strong string for the
    stiff inharmonic pluck model (pluck_inharmonic) — the realism sweep's
    knob; 0 keeps the exact fixture every pre-round-3 gate was measured
    on."""
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
        pluck = _pluck(freq, dur, sr, rng, B)
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


def generate_mixed_clip(seed: int = 1, sr: int = 22050,
                        run_note_s: float = 0.085
                        ) -> Tuple[np.ndarray, List[dict]]:
    """Chords interleaved with fast single-note runs — the routing
    engine's truth clip (engine/auto.py): chords defeat the monophonic
    tracker, 85 ms/note runs defeat the CQT peel (measured F1 ≤ 0.18,
    VALIDATION.md), so only a polyphony-aware router scores both.

    Layout: chord, 8-note pentatonic run, chord, run (descending), chord.
    Returns (audio, truth) like generate_chord_progression."""
    rng = np.random.default_rng(seed)
    run_up = [52, 55, 57, 60, 62, 64, 67, 69]
    run_dn = list(reversed(run_up))
    sections = [("chord", [48, 52, 55], 0.8), ("run", run_up, run_note_s),
                ("chord", [45, 52, 57], 0.8), ("run", run_dn, run_note_s),
                ("chord", [50, 57, 62], 0.8)]
    gap = np.zeros(int(0.15 * sr), np.float32)
    pieces, truth, pos = [gap], [], len(gap)
    for kind, notes, dur in sections:
        if kind == "chord":
            n = int(sr * dur)
            y = np.zeros(n, np.float32)
            for m in notes:
                y[:n] += karplus_strong(midi_to_hz(m), dur, sr, rng=rng)[:n]
                truth.append({"note": m, "start": pos / sr,
                              "end": (pos + n) / sr})
            pieces.append(y)
            pos += n
        else:
            for m in notes:
                n = int(sr * dur)
                y = karplus_strong(midi_to_hz(m), dur, sr, rng=rng)[:n]
                truth.append({"note": m, "start": pos / sr,
                              "end": (pos + n) / sr})
                pieces.append(y)
                pos += n
        pieces.append(gap)
        pos += len(gap)
    y = np.concatenate(pieces)
    return (y / np.max(np.abs(y)) * 0.85).astype(np.float32), truth


def generate_chord_progression(seed: int = 7, sr: int = 22050,
                               prog=None,
                               B: float = 0.0) -> Tuple[np.ndarray,
                                                        List[dict]]:
    """A plucked chord progression (Karplus-Strong voices summed per chord)
    with exact note-event ground truth — the polyphonic engine's truth
    clip family (bench config 4 has no reference implementation, so
    generator truth is its accuracy anchor; tests/test_poly_truth.py).

    Includes a repeated-pitch chord boundary (57 -> 57+60+64) that defeats
    pitch-only segmentation, a two-voice and three three-voice chords, and
    per-seed random string rolloff/detune from karplus_strong's rng.
    ``B`` > 0 swaps in the stiff inharmonic pluck model (the realism
    sweep; pluck_inharmonic)."""
    rng = np.random.default_rng(seed)
    prog = prog or _CHORD_PROG
    gap = np.zeros(int(0.15 * sr), np.float32)
    pieces, truth, pos = [gap], [], len(gap)
    for midis, dur in prog:
        n = int(sr * dur)
        y = np.zeros(n, np.float32)
        for m in midis:
            f = 440.0 * 2 ** ((m - 69) / 12)
            y[:n] += _pluck(f, dur, sr, rng, B)[:n]
            truth.append({"note": m, "start": pos / sr,
                          "end": (pos + n) / sr})
        pieces.append(y)
        pos += n
        pieces.append(gap)
        pos += len(gap)
    y = np.concatenate(pieces)
    return (y / np.max(np.abs(y)) * 0.85).astype(np.float32), truth


def wandering_pitch_obs(T: int, n_bins: int, seed: int, center: int,
                        step: int, spread: Sequence[int], jumps: bool
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse pYIN observations (T, n_bins) and voiced probabilities (T,):
    trough mass on ``spread`` bins around a pitch that wanders by up to
    ``step`` bins a frame, plus, with ``jumps``, a strong far bin every 13
    frames that exercises the out-of-band transitions.  The observations
    of tests/test_pyin_parity.py, extended to any T."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((T, n_bins), np.float32)
    for t in range(T):
        center = int(np.clip(center + rng.integers(-step, step + 1),
                             5, n_bins - 6))
        for d in spread:
            obs[t, center + d] = rng.random() * (0.4 if jumps else 0.5)
        if jumps and t % 13 == 7:
            obs[t, (center + 230) % n_bins] = 0.9
    return obs, np.clip(obs.sum(axis=1), 0.0, 1.0).astype(np.float32)
