"""Per-note ADSR optimization — one batched device sweep (PyTorch).

Counterpart of ``aegis_tpu/verify/per_note.py``.  The reference optimizes
each note in its own process (per_note_optimizer.py:452-542) by grid-
searching 27 combos of (waveform, attack, decay) against the original audio
slice.  Here all (note, combo) pairs render and score as batched device work
(synth.adsr.render_note_buffers + verify.similarity.note_slice_similarity),
chunked only to bound device memory.

Modes mirror the reference: 'quick' = envelope analysis passthrough
(:221-252), 'precise' = the 27-combo grid (:255-327).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from aegis_tpu_torch import resolve_device
from aegis_tpu_torch.synth.adsr import (analyze_envelope, render_note_buffers,
                                        synthesize_note_arrays)
from aegis_tpu_torch.synth.presets import WAVEFORM_CODES, WAVEFORM_NAMES
from aegis_tpu_torch.utils.logging import get_logger
from aegis_tpu_torch.verify.similarity import note_slice_similarity

log = get_logger("PerNoteOptimizer")

_GRID_WAVEFORMS = ("sawtooth", "triangle", "square")


def extract_note_audio(y: np.ndarray, event: Dict, sr: int, hop_length: int,
                       pad_ms: float = 50.0) -> np.ndarray:
    """Original-audio slice for an event, padded by 50 ms on each side
    (reference per_note_optimizer.py:35-65)."""
    pad = int(sr * pad_ms / 1000.0)
    start = max(0, event["start"] * hop_length - pad)
    end = min(len(y), event["end"] * hop_length + pad)
    return y[start:end]


def _pow2(n: int, floor: int = 2048) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def optimize_single_note(y, event, sr, hop_length, mode: str = "precise",
                         device="cuda") -> Dict:
    """The optimal ADSR params of one event: ``optimize_all_notes`` on
    ``[event]``, swept on ``device``."""
    res = optimize_all_notes(y, [event], sr, hop_length, mode=mode,
                             device=device)
    return res[0]


def optimize_all_notes(
    y: np.ndarray,
    events: List[Dict],
    sr: int,
    hop_length: int,
    mode: str = "precise",
    progress_callback: Optional[Callable] = None,
    chunk_elems: int = 1 << 23,
    device="cuda",
) -> List[Dict]:
    """Per-note optimal ADSR params, swept on ``device``.

    Returns one dict per event: {attack_ms, decay_ms, sustain_level,
    release_ms, waveform, similarity_score}.
    """
    dev = resolve_device(device)
    if not events:
        return []

    slices = [extract_note_audio(y, e, sr, hop_length) for e in events]
    analyzed = [analyze_envelope(s, sr) for s in slices]

    if mode == "quick":
        return [
            {**p, "waveform": "sawtooth", "similarity_score": 1.0}
            for p in analyzed
        ]

    N = len(events)
    spf = hop_length / sr
    max_len = _pow2(max(len(s) for s in slices))

    # build the (N, 27) parameter grid
    combos = []  # (note_idx, wf_code, attack, decay)
    for i, p in enumerate(analyzed):
        for wf in _GRID_WAVEFORMS:
            for atk in (max(1.0, p["attack_ms"] * 0.5), p["attack_ms"],
                        min(500.0, p["attack_ms"] * 2.0)):
                for dcy in (max(1.0, p["decay_ms"] * 0.5), p["decay_ms"],
                            min(1000.0, p["decay_ms"] * 2.0)):
                    combos.append((i, WAVEFORM_CODES[wf], atk, dcy))

    idxs = np.array([c[0] for c in combos], np.int32)
    codes = np.array([c[1] for c in combos], np.int32)
    attacks = np.array([c[2] for c in combos], np.float32)
    decays = np.array([c[3] for c in combos], np.float32)
    sustains = np.array([analyzed[i]["sustain_level"] for i in idxs], np.float32)
    releases = np.array([analyzed[i]["release_ms"] for i in idxs], np.float32)
    freqs = np.array(
        [440.0 * 2 ** ((events[i]["note"] - 69) / 12.0) for i in idxs],
        np.float32,
    )
    durs = np.array(
        [
            max(0.01, (events[i]["end"] - events[i]["start"]) * spf)
            + analyzed[i]["release_ms"] / 1000.0
            for i in idxs
        ],
        np.float32,
    )
    lengths = np.minimum((durs * sr), max_len).astype(np.float32)
    velocities = np.array([events[i].get("velocity", 100) for i in idxs],
                          np.float32)

    orig_pad = np.zeros((N, max_len), np.float32)
    for i, s in enumerate(slices):
        orig_pad[i, : len(s)] = s
    orig_dev = torch.from_numpy(orig_pad).to(dev)

    def t(a):
        return torch.from_numpy(a).to(dev)

    params = [t(a) for a in (freqs, lengths, velocities, attacks, decays,
                             sustains, releases, codes)]
    idxs_dev = t(idxs.astype(np.int64))

    B = len(combos)
    chunk = max(1, min(B, chunk_elems // max_len))
    scores = []
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        rendered = render_note_buffers(*(p[lo:hi] for p in params), sr,
                                       max_len)
        scores.append(note_slice_similarity(orig_dev[idxs_dev[lo:hi]],
                                            rendered, sr, device=dev))
        if progress_callback:
            progress_callback(hi / B, f"optimizing {hi}/{B}")
    scores = torch.cat(scores).cpu().numpy()

    results: List[Dict] = []
    per_note = scores.reshape(N, 27)
    params_per_note = np.arange(B).reshape(N, 27)
    for i in range(N):
        j = int(params_per_note[i, int(np.argmax(per_note[i]))])
        results.append(
            {
                "attack_ms": round(float(attacks[j]), 1),
                "decay_ms": round(float(decays[j]), 1),
                "sustain_level": round(float(sustains[j]), 3),
                "release_ms": round(float(releases[j]), 1),
                "waveform": WAVEFORM_NAMES[int(codes[j])],
                "similarity_score": round(float(per_note[i].max()), 4),
            }
        )
    return results


# The reference exposes a parallel variant (process pool); here the batched
# sweep IS the parallel form — kept as an alias for API parity.
optimize_all_notes_parallel = optimize_all_notes


def synthesize_with_per_note_params(
    events: List[Dict], params: List[Dict], sr: int, hop_length: int,
    device="cuda",
) -> np.ndarray:
    """Mixdown with per-note ADSR parameters (reference
    per_note_optimizer.py:549-659) — one batched render on ``device``."""
    spf = hop_length / sr
    notes = [
        {
            "note": e["note"],
            "start": e["start"] * spf,
            "end": e["end"] * spf,
            "velocity": e.get("velocity", 100),
        }
        for e in events
    ]
    per_note = {
        "attack_ms": np.array([p["attack_ms"] for p in params], np.float32),
        "decay_ms": np.array([p["decay_ms"] for p in params], np.float32),
        "sustain_level": np.array([p["sustain_level"] for p in params], np.float32),
        "release_ms": np.array([p["release_ms"] for p in params], np.float32),
        "waveform_code": np.array(
            [WAVEFORM_CODES.get(p.get("waveform", "sawtooth"), 1) for p in params],
            np.int32,
        ),
    }
    return synthesize_note_arrays(notes, sr, per_note=per_note, device=device)


def generate_optimization_report(results: List[Dict]) -> Dict:
    """Aggregate stats incl. the 5 worst notes (reference
    per_note_optimizer.py:686-781)."""
    if not results:
        return {"count": 0}
    scores = np.array([r["similarity_score"] for r in results])
    order = np.argsort(scores)
    waveform_counts: Dict[str, int] = {}
    for r in results:
        waveform_counts[r["waveform"]] = waveform_counts.get(r["waveform"], 0) + 1
    return {
        "count": len(results),
        "mean_similarity": round(float(scores.mean()), 4),
        "min_similarity": round(float(scores.min()), 4),
        "max_similarity": round(float(scores.max()), 4),
        "waveform_distribution": waveform_counts,
        "worst_notes": [
            {"index": int(i), **results[int(i)]} for i in order[:5]
        ],
    }
