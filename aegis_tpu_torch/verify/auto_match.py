"""Auto parameter matcher: coarse-to-fine grid search over extraction
parameters, scored by synthesized-audio similarity (PyTorch).

Counterpart of ``aegis_tpu/verify/auto_match.py``.  Grid structure mirrors
the reference (auto_matcher.py:92-269): 3x3x3 coarse over (confidence,
min-duration, sustain), then 3x3x3 fine around the winner.  Phase-2
extraction is host code; every combo of a sweep is rendered by the batched
ADSR synth and scored against the reference feature rows on the engine's
device, in chunks of combos under a 256 MB note-buffer budget (the JAX
program's ``lax.map`` over chunks).
"""

from __future__ import annotations

import io
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from aegis_tpu_torch.io.audio import to_mono
from aegis_tpu_torch.io.wav import read_wav
from aegis_tpu_torch.synth.adsr import render_notes
from aegis_tpu_torch.synth.fluidsynth import synthesize_midi
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.verify.similarity import (audio_similarity, features,
                                               similarity_scores,
                                               similarity_tables)

log = get_logger("AutoMatcher")

COARSE_GRID = {
    "confidence_threshold": [0.2, 0.4, 0.6],
    "min_note_duration_ms": [50, 150, 250],
    "sustain_ms": [100, 300, 500],
}


def _fine_grid(best: Dict) -> Dict[str, List]:
    return {
        "confidence_threshold": [
            max(0.1, best["confidence_threshold"] - 0.1),
            best["confidence_threshold"],
            min(0.9, best["confidence_threshold"] + 0.1),
        ],
        "min_note_duration_ms": [
            max(10, best["min_note_duration_ms"] - 50),
            best["min_note_duration_ms"],
            min(500, best["min_note_duration_ms"] + 50),
        ],
        "sustain_ms": [
            max(0, best["sustain_ms"] - 100),
            best["sustain_ms"],
            min(1000, best["sustain_ms"] + 100),
        ],
    }


def _combos(grid: Dict[str, List]) -> list:
    return [(c, d, s)
            for c in grid["confidence_threshold"]
            for d in grid["min_note_duration_ms"]
            for s in grid["sustain_ms"]]


def _evaluate(engine, raw_data, y_orig: np.ndarray, sample_rate: int,
              conf: float, min_dur: int, sustain: int) -> float:
    buf = io.BytesIO()
    engine.extract_events(
        raw_data, buf,
        confidence_threshold=conf,
        min_note_duration_ms=int(min_dur),
        sustain_ms=int(sustain),
        midi_program=27,
    )
    midi_data = buf.getvalue()
    if len(midi_data) < 60:  # effectively empty output
        return -1.0
    wav_data = synthesize_midi(midi_data, sample_rate=sample_rate,
                               device=engine.device)
    if wav_data is None:
        return -1.0
    y_synth, sr = read_wav(wav_data)
    y_synth = to_mono(y_synth)
    if sr != sample_rate:
        from aegis_tpu_torch.io.audio import resample

        y_synth = resample(y_synth, sr, sample_rate)
    return audio_similarity(y_orig, y_synth, sample_rate, device=engine.device)


def _combo_events(engine, raw_data, conf, min_dur, sustain):
    return engine.extract_events(
        raw_data, None,
        confidence_threshold=conf,
        min_note_duration_ms=int(min_dur),
        sustain_ms=int(sustain),
    )


def _ref_feats(y_ref: torch.Tensor, sample_rate: int):
    """Reference-audio mel/chroma feature rows on the device, computed once
    per auto-match call; both sweep phases reuse them."""
    mel, ch = features(y_ref[None],
                       similarity_tables(sample_rate, y_ref.device))
    return mel[0], ch[0]


def _score_sweep(mel_r, ch_r, freqs, starts, lengths, vels, sample_rate: int,
                 mb: int, total: int, n_chunks: int) -> torch.Tensor:
    """(B,) similarity scores for B padded note-array combos: each chunk of
    combos is rendered by the batched ADSR synth (default envelope,
    sawtooth) and scored against the reference feature rows."""
    tables = similarity_tables(sample_rate, freqs.device)
    b = freqs.shape[0]
    chunk = b // n_chunks
    scores = []
    for lo in range(0, b, chunk):
        f, st, ln, v = (a[lo:lo + chunk] for a in (freqs, starts, lengths,
                                                   vels))

        def const(val):
            return torch.full(f.shape, val, dtype=torch.float32,
                              device=f.device)

        synths = render_notes(f, st, ln, v, const(10.0), const(50.0),
                              const(0.7), const(100.0),
                              torch.zeros(f.shape, dtype=torch.int32,
                                          device=f.device),
                              sample_rate, mb, total)          # (chunk, total)
        mel, ch = features(synths, tables)
        scores.append(similarity_scores(mel_r, ch_r, mel, ch))
    return torch.cat(scores)


def _sweep_batched(engine, raw_data, mel_r, ch_r, total, sample_rate, grid,
                   phase, progress_callback):
    """All grid combos scored on the device: per-combo event lists (host,
    phase-2 re-extraction) are padded into (B, Nmax) note arrays, rendered
    with the batched ADSR synth and scored against the precomputed
    reference feature rows.  ``total`` is the render length in samples (the
    reference features were computed over the same padded window)."""
    combos = _combos(grid)
    hop = engine.hop_length
    spf = hop / sample_rate
    release_s = 0.1

    event_lists = []
    for i, (conf, min_dur, sustain) in enumerate(combos):
        if progress_callback:
            progress_callback((i + 1) / len(combos),
                              f"{phase} extract {i + 1}/{len(combos)}")
        try:
            event_lists.append(_combo_events(engine, raw_data, conf,
                                             min_dur, sustain))
        except Exception as e:
            log.warning(f"combo failed ({conf},{min_dur},{sustain}): {e}")
            event_lists.append([])

    B = len(combos)
    n_max = max(1, max(len(e) for e in event_lists))
    nb = 1
    while nb < n_max:
        nb <<= 1

    freqs = np.full((B, nb), 440.0, np.float32)
    starts = np.zeros((B, nb), np.int32)
    lengths = np.ones((B, nb), np.int32)
    vels = np.zeros((B, nb), np.float32)  # zero velocity = silent padding
    max_note = 1
    for b, evs in enumerate(event_lists):
        for j, e in enumerate(evs):
            freqs[b, j] = 440.0 * 2.0 ** ((e["note"] - 69) / 12.0)
            s = min(int(e["start"] * spf * sample_rate), total - 1)
            dur = int(((e["end"] - e["start"] + 1) * spf + release_s)
                      * sample_rate)
            dur = max(min(dur, total - s), 1)
            starts[b, j] = s
            lengths[b, j] = dur
            vels[b, j] = e["velocity"]
            max_note = max(max_note, dur)
    mb = 1 << 10
    while mb < max_note:
        mb <<= 1

    # the render materializes (chunk, nb, mb) f32 note buffers; cap the live
    # footprint (long clips with permissive grids can reach hundreds of
    # notes x multi-second sustains)
    budget = 256 << 20
    chunk = max(1, min(B, budget // max(nb * mb * 4, 1)))
    n_chunks = -(-B // chunk)
    b_pad = n_chunks * chunk
    if b_pad > B:  # pad with silent combos (velocity 0)
        pad = b_pad - B
        freqs = np.concatenate([freqs, np.full((pad, nb), 440.0, np.float32)])
        starts = np.concatenate([starts, np.zeros((pad, nb), np.int32)])
        lengths = np.concatenate([lengths, np.ones((pad, nb), np.int32)])
        vels = np.concatenate([vels, np.zeros((pad, nb), np.float32)])
    dev = mel_r.device
    scores = _score_sweep(
        mel_r, ch_r, *(torch.from_numpy(a).to(dev)
                       for a in (freqs, starts, lengths, vels)),
        sample_rate, mb, total, n_chunks).cpu().numpy()[:B]
    scores = np.where([len(e) > 0 for e in event_lists], scores, -1.0)
    best = int(np.argmax(scores))
    if scores[best] < 0:
        return None, -1.0
    conf, min_dur, sustain = combos[best]
    return ({"confidence_threshold": conf,
             "min_note_duration_ms": int(min_dur),
             "sustain_ms": int(sustain)}, float(scores[best]))


def auto_match_parameters(
    original_audio, engine, raw_data,
    sample_rate: Optional[int] = None,
    progress_callback: Optional[Callable] = None,
    batched: Optional[bool] = None,
) -> Optional[Dict]:
    """Returns {confidence_threshold, min_note_duration_ms, sustain_ms,
    score} or None when no combination produced usable output; runs on
    ``engine.device``.

    ``original_audio`` may be a path or a mono float array at engine.sr.
    ``sample_rate`` defaults to engine.sr and must match it: raw_data's
    events are frame-indexed on the engine's grid.
    batched=None (default) uses the batched sweep unless FluidSynth is
    available (whose soundfont rendering can't be batched on the device;
    the sequential loop keeps the reference's objective there).  Unlike
    the JAX package's sequential loop, a failing combo raises.
    """
    if sample_rate is None:
        sample_rate = engine.sr
    elif sample_rate != engine.sr:
        raise ValueError(
            f"sample_rate={sample_rate} != engine.sr={engine.sr}: the "
            f"comparison must run on the engine's rate (resample the "
            f"audio or build the engine at the audio's rate)")
    if isinstance(original_audio, np.ndarray):
        y_orig = original_audio[: int(sample_rate * 30)]
    else:
        from aegis_tpu_torch.io.audio import load_audio

        y_orig, _ = load_audio(original_audio, sr=sample_rate, duration=30)

    if batched is None:
        from aegis_tpu_torch.synth.fluidsynth import get_synthesizer

        batched = not get_synthesizer().is_available()
    if batched:
        from aegis_tpu_torch.core.analyze import bucket_length

        # reference features once, reused by both phases
        total = bucket_length(len(y_orig))
        y_ref = np.zeros(total, np.float32)
        y_ref[: len(y_orig)] = y_orig
        mel_r, ch_r = _ref_feats(torch.from_numpy(y_ref).to(engine.device),
                                 sample_rate)

        coarse, score = _sweep_batched(engine, raw_data, mel_r, ch_r, total,
                                       sample_rate, COARSE_GRID, "coarse",
                                       progress_callback)
        if coarse is None:
            log.warning("no valid combination found")
            return None
        log.info(f"coarse best: {coarse} score={score:.3f}")
        fine, fine_score = _sweep_batched(engine, raw_data, mel_r, ch_r,
                                          total, sample_rate,
                                          _fine_grid(coarse), "fine",
                                          progress_callback)
        if fine is not None and fine_score >= score:
            coarse, score = fine, fine_score
        log.info(f"final best: {coarse} score={score:.3f}")
        return {**coarse, "score": score}

    log.info("coarse grid search (27 combos)")
    best_score, best_params = -1.0, None

    def sweep(grid, phase):
        nonlocal best_score, best_params
        combos = _combos(grid)
        for i, (conf, min_dur, sustain) in enumerate(combos):
            if progress_callback:
                progress_callback((i + 1) / len(combos),
                                  f"{phase} {i + 1}/{len(combos)}")
            score = _evaluate(engine, raw_data, y_orig, sample_rate,
                              conf, min_dur, sustain)
            if score > best_score:
                best_score = score
                best_params = {
                    "confidence_threshold": conf,
                    "min_note_duration_ms": int(min_dur),
                    "sustain_ms": int(sustain),
                }

    sweep(COARSE_GRID, "coarse")
    if best_params is None:
        log.warning("no valid combination found")
        return None
    log.info(f"coarse best: {best_params} score={best_score:.3f}")

    sweep(_fine_grid(best_params), "fine")
    log.info(f"final best: {best_params} score={best_score:.3f}")
    return {**best_params, "score": best_score}
