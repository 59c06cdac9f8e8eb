"""Polyphonic engine facade (PyTorch).

Counterpart of ``aegis_tpu/engine/poly.py``: `AegisPolyEngine` is the
chord-capable sibling of the monophonic engines: CQT salience peeling on the
device (core.poly), host note segmentation, onset-based re-attack splitting,
the raw-CQT recovery chain, chord-aware tab fingering, and the same two-phase
analyze / extract surface and MIDI export as AegisEngine.

The fused program returns ONE packed buffer a track (raw voices, RMS, onset
envelope, the f16 CQT plane) in one device->host copy; the planes are rebuilt
on the host through the NumPy oracle (core.poly.unpack_poly_voices).  The JAX
package fetches the CQT plane in a background thread, which exists for its
tunnelled transfers and is not ported.  The folder sweep lives in
``engine/folder.py``; ``transcribe_folder`` is also importable from here,
where the JAX package defines it (a lazy re-export: ``engine/folder.py``
imports this module).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.core import poly as P
from aegis_tpu_torch.core.analyze import (pad_to_bucket, quantize_pcm8,
                                          quantize_pcm16, upload)
from aegis_tpu_torch.core.cqt import pick_onsets, split_events_at_onsets
from aegis_tpu_torch.core.events import velocity_from_db
from aegis_tpu_torch.core.tables import poly_tables
from aegis_tpu_torch.io.audio import load_audio
from aegis_tpu_torch.midi.encode import events_to_midi
from aegis_tpu_torch.midi.tabs import generate_tabs_chords
from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("PolyEngine")

N_MELS = 128  # mel bands of the onset envelope's spectrogram


def dispatch_analyze_poly(y: np.ndarray, sr: int, n_fft: int = 2048,
                          hop_length: int = 512, n_bins: int = 84,
                          bins_per_octave: int = 12, max_voices: int = 6,
                          transport: str = "int8", device="cuda"):
    """Async half of the fused polyphonic analyze (mirrors
    core.analyze.dispatch_analyze): bucket-pad, upload quantized PCM, queue
    the packed raw-voice program on ``device`` and return a handle WITHOUT
    waiting for the device (no ``.item()``, no ``.cpu()``), so a folder
    sweep can put every track in flight before fetching any.  Resolve with
    fetch_analyze_poly(handle).

    ``transport``: "int8" (default: block-float,
    core.analyze.quantize_pcm8) or "int16" (per-track scale)."""
    device = resolve_device(device)
    true_frames = 1 + len(y) // hop_length
    y_pad = pad_to_bucket(np.asarray(y, np.float32))
    if transport == "int8":
        yq, s = quantize_pcm8(y_pad)
        y_dev, scale = upload(yq, device), upload(s, device)
    elif transport == "int16":
        yq, s = quantize_pcm16(y_pad)
        y_dev = upload(yq, device)
        scale = torch.full((), s, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown transport {transport!r} (int8 | int16)")
    tables = poly_tables(sr, n_fft, n_bins, bins_per_octave, N_MELS, device)
    with torch.profiler.record_function("aegis.poly_program"):
        buf = P.analyze_poly_program_packed(y_dev, scale, hop_length, tables,
                                            max_voices)
    return buf, true_frames, max_voices, bins_per_octave


def fetch_analyze_poly(handle) -> Dict[str, np.ndarray]:
    """Blocking half: copy the packed raw-voice buffer to the host (one
    copy, the CQT plane with the core columns) and reconstruct the {roll,
    confidence, salience, rms, onset_env, cqt_mag} planes through the NumPy
    oracle (the bucket-padding tail carries ~zero salience, so the global
    acceptance peak over true frames equals the padded device max)."""
    buf, true_frames, max_voices, bins_per_octave = handle
    return P.unpack_poly_voices(buf[:true_frames].cpu().numpy(),
                                max_voices, bins_per_octave)


class AegisPolyEngine:
    """Two-phase polyphonic transcription (CQT salience peeling).

    ``n_fft``/``hop_length`` default to sr-proportional values (2048/512
    at 22.05 kHz, 4096/1024 at 44.1 kHz) so the analysis window covers the
    same PHYSICAL duration at every rate: with a fixed 2048 window at
    44.1 kHz the FFT bin spacing (21.5 Hz) exceeds a low-string semitone
    and chord-progression truth F1 falls to 0.5-0.79.

    Runs on the card unless the caller names ``device="cpu"``; without a
    card the default raises."""

    def __init__(self, sample_rate: int = 22050,
                 hop_length: Optional[int] = None,
                 n_fft: Optional[int] = None, n_bins: int = 84,
                 bins_per_octave: int = 12, max_voices: int = 6,
                 transport: str = "int8", device="cuda"):
        scale = max(1, round(sample_rate / 22050))
        self.sr = sample_rate
        self.transport = transport
        self.hop_length = hop_length if hop_length is not None \
            else 512 * scale
        self.n_fft = n_fft if n_fft is not None else 2048 * scale
        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave
        self.max_voices = max_voices
        self.device = resolve_device(device)

    # ------------------------------------------------------------- phase one

    def analyze(self, input_wav: Union[str, bytes, np.ndarray],
                **kwargs) -> Optional[Dict[str, np.ndarray]]:
        if isinstance(input_wav, np.ndarray):
            y = input_wav.astype(np.float32)
        else:
            start = kwargs.get("start_time", 0)
            end = kwargs.get("end_time", None)
            y, _ = load_audio(input_wav, sr=self.sr, offset=start,
                              duration=(end - start) if end else None)
        if len(y) == 0:
            return None

        from aegis_tpu_torch.engine.engine import normalize_turbo_mode

        # no slab-streamed poly mode exists; stream/auto requests map to the
        # tiled path (bounded per-tile compute; the packed poly output is
        # ~100 KB/min, so the output buffer is not the constraint)
        mode = normalize_turbo_mode(
            kwargs.get("turbo_mode", False), len(y), self.sr,
            kwargs.get("stream_threshold_s", 240.0), allow_stream=False)
        with torch.profiler.record_function("aegis.poly_perception"):
            if mode == "tiles":
                from aegis_tpu_torch.engine.turbo import run_analyze_poly_turbo

                log.info(f"Polyphonic Perception Phase [tiles, {self.device}]"
                         f" ({len(y)/self.sr:.1f}s)")
                out = run_analyze_poly_turbo(
                    y, sr=self.sr, n_fft=self.n_fft,
                    hop_length=self.hop_length, n_bins=self.n_bins,
                    bins_per_octave=self.bins_per_octave,
                    max_voices=self.max_voices,
                    turbo=kwargs.get("turbo_config"), device=self.device)
            else:
                log.info(f"Polyphonic Perception Phase ({self.device}, "
                         f"{len(y)/self.sr:.1f}s, <= {self.max_voices} "
                         f"voices)")
                out = fetch_analyze_poly(dispatch_analyze_poly(
                    y, self.sr, self.n_fft, self.hop_length, self.n_bins,
                    self.bins_per_octave, self.max_voices,
                    transport=kwargs.get("transport", self.transport),
                    device=self.device))
        out["y"] = y
        return out

    # ------------------------------------------------------------- phase two

    def extract_events(self, analysis: Dict[str, np.ndarray],
                       output_mid=None, **kwargs) -> List[dict]:
        """Segment the piano roll into note events.

        ``use_onsets=True`` (library default) runs the full polyphonic
        refinement: silence gate, onset re-attack split, chord-aware
        start snap, decay prune, onset birth + attack-rise gates,
        absolute-salience harmonic dedup, the raw-CQT recovery chain
        (core.poly.refine_poly_events).  ``use_onsets=False`` is the plain
        pitch-only segmentation."""
        from aegis_tpu_torch.ref.dsp_ref import amplitude_to_db

        use_onsets = kwargs.get("use_onsets", True)
        # refinement replaces duration/gap micro-filtering with explicit
        # attack physics, so it prefers a longer sustain merge (splits are
        # put back by the onset pass); min-duration stays 60 ms in both
        # modes: 100 ms made sub-4-frame notes (fast arpeggios)
        # undetectable by construction
        mindur = kwargs.get("min_note_duration_ms", 60.0)
        sustain = kwargs.get("sustain_ms", 120.0 if use_onsets else 40.0)
        roll = analysis["roll"]
        # rms_ref / rms_floor_db: a windowed caller (the live horizon
        # cache) pins the dB reference and the top_db clamp floor to the
        # TRACK-GLOBAL values, so slice dB planes match the full track's
        rms_ref = kwargs.get("rms_ref")
        rms_db = amplitude_to_db(np.asarray(analysis["rms"]), ref=rms_ref)
        if rms_ref is not None and kwargs.get("rms_floor_db") is not None:
            rms_db = np.maximum(rms_db, np.float32(kwargs["rms_floor_db"]))
        if use_onsets:
            # rms_peak_db: a windowed caller (the live horizon cache)
            # passes the TRACK-GLOBAL rms peak so the silence gate matches
            # the full-track extraction on a slice
            roll = P.silence_gate(
                roll, rms_db, kwargs.get("silence_db", 45.0),
                peak_db=kwargs.get("rms_peak_db"))
        events = P.roll_to_events(
            roll, analysis["confidence"], analysis["rms"],
            self.sr, self.hop_length,
            min_note_duration_ms=mindur,
            sustain_ms=sustain,
            confidence_threshold=kwargs.get("confidence_threshold", 0.5),
            rms_db=rms_db,
        )
        if use_onsets:
            # onsets override: pick_onsets normalizes by the track env max
            # and runs a sequential refractory, so a windowed caller must
            # supply globally-picked onsets (already slice-shifted)
            onsets = kwargs.get("onsets")
            if onsets is None:
                onsets = pick_onsets(analysis["onset_env"], self.sr,
                                     self.hop_length)
            fps = self.sr / self.hop_length
            events = split_events_at_onsets(
                events, onsets,
                min_frames=max(int(mindur / 1000.0 * fps), 1))
            # re-read attack dynamics at each split point, the v1 path's
            # convention (core/events.py apply_onset_refinement): a chord
            # re-plucked at a different dynamic must not inherit the first
            # pluck's velocity.  Deliberately NOT re-read after the snap
            # below, also matching v1.
            velocity = velocity_from_db(rms_db)
            T_rms = len(rms_db)
            for e in events:
                e["velocity"] = int(velocity[min(e["start"], T_rms - 1)])
                e["rms_energy"] = float(rms_db[min(e["start"], T_rms - 1)])
            if "salience" in analysis:
                events = P.refine_poly_events(
                    events, onsets, rms_db, analysis["salience"],
                    self.sr, self.hop_length,
                    total_frames=roll.shape[0],
                    snap_back_ms=kwargs.get("snap_back_ms", 200.0),
                    birth_tol_ms=kwargs.get("birth_tol_ms", 80.0),
                    rise_db=kwargs.get("rise_db", 2.0),
                    sal_ratio=kwargs.get("sal_ratio", 0.55),
                    decay_frac=kwargs.get("decay_frac", 0.5),
                    # octave-doubling recovery off the raw CQT plane
                    # (absent on analyses cached without it: skip)
                    cqt_mag=analysis.get("cqt_mag"),
                    # the leakage-physics passes need the FFT bin width
                    n_fft=self.n_fft,
                    # track-global CQT peak override (live horizon cache)
                    track_peak_db=kwargs.get("track_peak_db"))
        if output_mid is not None:
            bpm = kwargs.get("bpm")
            if bpm == "auto":
                from aegis_tpu_torch.core.tempo import estimate_bpm

                bpm = estimate_bpm(analysis, self.sr, self.hop_length)
            events_to_midi(events, self.sr, self.hop_length,
                           midi_program=kwargs.get("midi_program", 25),
                           bpm=bpm, output=output_mid)
        return events

    def audio_to_midi(self, input_wav, output_mid=None, **kwargs):
        analysis = self.analyze(input_wav, **kwargs)
        if analysis is None:
            return None
        self.extract_events(analysis, output_mid, **kwargs)
        return analysis

    def generate_tabs(self, events: List[dict]) -> List[dict]:
        return generate_tabs_chords(events, self.sr, self.hop_length)

    def label_chords(self, events: List[dict],
                     window_ms: float = 50.0) -> List[dict]:
        return label_chords(events, self.sr, self.hop_length, window_ms)


def label_chords(events: List[dict], sr: int, hop_length: int,
                 window_ms: float = 50.0) -> List[dict]:
    """Name each simultaneous note group as a chord symbol.
    Returns [{time_sec, name, notes}] in onset order."""
    from aegis_tpu_torch.harmony.key import name_chord

    spf = hop_length / sr
    out = []
    for chord in P.group_chords(events, sr, hop_length, window_ms):
        notes = sorted(e["note"] for e in chord["events"])
        start = min(e["start"] for e in chord["events"])
        name = name_chord(notes)
        if any(e.get("octave_uncertain") for e in chord["events"]):
            # an unprovable octave doubling may hide in this voicing
            # (core.poly.recover_octave_doublings)
            name += " (oct?)"
        out.append({"time_sec": round(start * spf, 4),
                    "name": name, "notes": notes})
    return out


def __getattr__(name):
    if name == "transcribe_folder":
        from aegis_tpu_torch.engine.folder import transcribe_folder

        return transcribe_folder
    raise AttributeError(
        f"module 'aegis_tpu_torch.engine.poly' has no attribute {name!r}")
