"""Frame data → note events (host side), the v1 and financial extractors.

``extract_events_v1``, ``apply_onset_refinement`` and
``extract_events_financial`` are copies of ``aegis_tpu/core/events.py``'s,
with one change: the onset helpers come from this package's
``core/cqt.py`` (NumPy copies), because the original pulls ``pick_onsets``
from ``aegis_tpu/core/cqt.py``, which imports jax.  Every other helper is
imported from ``aegis_tpu.core.events`` as it is.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import medfilt

from aegis_tpu.core.events import (
    PYIN_LAG_MS,
    SPLIT_MIN_RISE_DB,
    _TECHNIQUE_CODES,
    _build_events,
    _hammer_pull_pairs,
    _segment,
    _sustain_merge,
    apply_harmonic_context,
    detect_articulations_v1,
    drop_harmonic_tail_ghosts,
    filter_ghost_notes_rsi,
    snap_starts_to_onsets,
    velocity_from_db,
)
from aegis_tpu.ref import trend_ref
from aegis_tpu.ref.dsp_ref import amplitude_to_db, hz_to_midi
from aegis_tpu_torch.core.cqt import pick_onsets, split_events_at_onsets


def extract_events_v1(
    rake_mask: np.ndarray,
    f0: np.ndarray,
    voiced_flag: np.ndarray,
    active_probs: np.ndarray,
    rms: np.ndarray,
    sr: int,
    hop_length: int,
    confidence_threshold: float = 0.70,
    noise_gate_db: float = -40.0,
    sustain_ms: float = 50.0,
    min_note_duration_ms: float = 50.0,
    smooth: bool = True,
    onset_env: Optional[np.ndarray] = None,
    onset_snap_ms: float = 140.0,
    onset_fwd_snap_ms: float = 0.0,
    onsets: Optional[np.ndarray] = None,
    rms_ref: Optional[float] = None,
    rms_floor_db: Optional[float] = None,
    hammer_pairs: bool = True,
) -> List[dict]:
    """v1 note-event extraction.  f0 convention here: 0 on unvoiced frames
    (the engine nan_to_nums pYIN output, reference aegis_engine.py:69).

    onset_env (optional): device onset-strength envelope; when given,
    same-pitch re-attacks are split at picked onsets (BASELINE.json
    config 2), each split re-reads its velocity from RMS at the new attack frame, and
    event starts snap back to the attack transient (snap_starts_to_onsets;
    window onset_snap_ms, 0 disables) to undo pYIN's pitch-lock delay.
    onset_fwd_snap_ms enables the FORWARD snap for early-firing backends
    (the engines pass it for pitch_backend="neural"; see
    snap_starts_to_onsets)."""
    T = min(len(rake_mask), len(f0), len(rms), len(voiced_flag), len(active_probs))
    rake_mask, f0, voiced_flag, active_probs, rms = (
        a[:T] for a in (rake_mask, f0, voiced_flag, active_probs, rms)
    )

    f0_smooth = (medfilt(np.nan_to_num(f0), kernel_size=3)
                 if smooth and T >= 3 else np.nan_to_num(f0))
    # rms_ref / rms_floor_db: a windowed caller (the live horizon cache)
    # pins the dB reference and the top_db clamp floor to TRACK-GLOBAL
    # values — the noise gate and every rms read are track-referenced
    rms_db = amplitude_to_db(rms, ref=rms_ref)
    if rms_ref is not None and rms_floor_db is not None:
        rms_db = np.maximum(rms_db, np.float32(rms_floor_db))

    min_frames = int((min_note_duration_ms / 1000.0) * sr / hop_length)
    sustain_frames = int((sustain_ms / 1000.0) * sr / hop_length)
    ms_per_frame = 1000.0 * hop_length / sr

    active = (
        voiced_flag.astype(bool)
        & (rms_db >= noise_gate_db)
        & (f0_smooth > 0)
        & ~rake_mask.astype(bool)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        notes = np.where(active, np.round(hz_to_midi(np.maximum(f0_smooth, 1e-6))), -1)
    velocity = velocity_from_db(rms_db)

    # native (C++) fast path for the per-frame scan + per-segment passes;
    # exact parity with the NumPy path below (tests/test_native_events.py),
    # graceful fallback when no compiler is available or AEGIS_NATIVE=0
    from aegis_tpu.native import segment_events_v1_native

    events = segment_events_v1_native(
        f0_smooth, voiced_flag, active_probs, rms_db, rake_mask,
        confidence_threshold, noise_gate_db, min_frames, sustain_frames)
    if events is None:
        starts, ends = _segment(active, notes)
        events = _build_events(
            starts, ends, notes, active_probs, velocity, rms_db,
            confidence_threshold
        )
        for evt in events:
            technique, slope = detect_articulations_v1(
                f0_smooth, evt["start"], evt["end"])
            evt["technique"], evt["slope"] = technique, slope

        events = [e for e in events if (e["end"] - e["start"]) >= min_frames]
        events = _sustain_merge(events, sustain_frames)

    if onset_env is not None:
        events = apply_onset_refinement(events, onset_env[:T], velocity,
                                        rms_db, sr, hop_length, min_frames,
                                        onset_snap_ms,
                                        snap_fwd_ms=onset_fwd_snap_ms,
                                        onsets=onsets)

    # hammer_pairs=False defers the pair-walk to the caller: the live
    # horizon cache re-runs it over the spliced list (a windowed pass
    # would tag the first tail event against a possibly-truncated
    # predecessor)
    if hammer_pairs:
        _hammer_pull_pairs(events, ms_per_frame)
    return events


def apply_onset_refinement(
    events: List[dict],
    onset_env: np.ndarray,
    velocity: np.ndarray,
    rms_db: np.ndarray,
    sr: int,
    hop_length: int,
    min_frames: int,
    onset_snap_ms: float = 140.0,
    split_min_rise_db: float = SPLIT_MIN_RISE_DB,
    snap_fwd_ms: float = 0.0,
    onsets: Optional[np.ndarray] = None,
) -> List[dict]:
    """The two onset-envelope passes shared by the v1 and financial
    extractors: re-attack splitting with the pYIN-lag tail guard, then
    attack-rise start snapping (see snap_starts_to_onsets).
    ``snap_fwd_ms`` additionally enables the FORWARD snap for early-firing
    pitch backends (PitchNet's magnitude features are phase-blind, so its
    voicing fires when a window merely CONTAINS the upcoming attack — up
    to ~a window early in start-indexed time; see snap_starts_to_onsets).

    ``split_min_rise_db`` is the echo guard on the SPLIT pass (0 disables):
    an interior onset only cuts an event if the local RMS rise at the
    onset reaches this many dB.  A true same-pitch re-attack re-excites
    the string to near its attack level (measured rise 3.6-11.8 dB over
    37 true cuts on the clean/wet bench tracks); a delay/reverb echo
    arrives ~10 dB below its source over a still-sustaining tail
    (measured rise -1.3..+2.0 dB over 172 echo cuts, plus one 3.6 dB
    outlier under reverb wash).  Without the guard the 400 ms "ambient"
    preset mints an event per echo: truth precision 0.27.  At 2.5 dB the
    guard rejects 170/172 echoes and keeps 35/37 true cuts (both misses
    wet-only — clean-track true cuts all rise >= 3.6 dB, so the F1-gated
    clips are untouched).  The snap pass deliberately keeps the FULL
    onset list: a rejected echo onset is still a valid attack-time
    anchor for the note whose tail it rides on.

    ``onsets`` overrides the internal pick_onsets — a windowed caller (the
    live horizon cache, engine/realtime.py) must supply GLOBALLY-picked
    onsets: pick_onsets normalizes by the track env max and its ``wait``
    refractory runs sequentially from frame 0, so picking over a slice
    diverges from the full-track pick."""
    T = len(onset_env)
    if onsets is None:
        onsets = pick_onsets(onset_env, sr, hop_length)
    else:
        onsets = np.asarray(onsets, np.int64)
    # tail guard = pYIN's lock lag (measured up to ~91 ms): an onset
    # closer than this to the event end is the NEXT note's attack under
    # this event's overhanging voicing tail, handled by the snap below,
    # not a same-pitch re-attack
    lag_frames = int((PYIN_LAG_MS / 1000.0) * sr / hop_length)
    split_onsets = onsets
    if split_min_rise_db > 0 and len(onsets):
        rms_db = np.asarray(rms_db, np.float64)
        keep = []
        # negative onsets are a windowed caller's pre-window history
        # (shifted global picks): they can never split an interior frame
        for o in (int(o) for o in onsets if o >= 0):
            post = rms_db[o:min(o + 3, T)].max() if o < T else -np.inf
            pre = rms_db[max(o - 4, 0):max(o, 1)].min()
            if post - pre >= split_min_rise_db:
                keep.append(o)
        split_onsets = np.asarray(keep, np.int64)
    events = split_events_at_onsets(
        events, split_onsets, min_frames=max(min_frames, 2),
        tail_frames=max(min_frames, lag_frames))
    for e in events:  # re-read attack dynamics at the split point
        e["velocity"] = int(velocity[min(e["start"], T - 1)])
        e["rms_energy"] = float(rms_db[min(e["start"], T - 1)])
    if onset_snap_ms > 0:
        events = snap_starts_to_onsets(
            events, onsets, rms_db,
            int((onset_snap_ms / 1000.0) * sr / hop_length),
            fwd_frames=int((snap_fwd_ms / 1000.0) * sr / hop_length))
    if snap_fwd_ms > 0:
        # the second phase-blind-backend compensation (neural only, like
        # the forward snap): see drop_harmonic_tail_ghosts
        events = drop_harmonic_tail_ghosts(events, onsets, rms_db, sr,
                                           hop_length,
                                           min_rise_db=split_min_rise_db)
    return events


def extract_events_financial(
    rake_mask: np.ndarray,
    f0: np.ndarray,  # NaN on unvoiced
    voiced_flag: np.ndarray,
    active_probs: np.ndarray,
    rms: np.ndarray,
    sr: int,
    hop_length: int,
    *,
    trend: np.ndarray,
    artic_codes: np.ndarray,
    slide_codes: np.ndarray,
    financial_confidence: np.ndarray,
    confidence_threshold: Optional[float] = None,
    noise_gate_db: float = -40.0,
    sustain_ms: float = 50.0,
    min_note_duration_ms: float = 50.0,
    use_harmonic_filter: bool = True,
    harmonic_tolerance: int = 1,
    rsi_threshold: float = 70.0,
    onset_env: Optional[np.ndarray] = None,
    onset_snap_ms: float = 140.0,
    onset_fwd_snap_ms: float = 0.0,
    pitch_source: str = "pyin",
    onsets: Optional[np.ndarray] = None,
    ghost_rsi: bool = True,
    rms_ref: Optional[float] = None,
    rms_floor_db: Optional[float] = None,
) -> Tuple[List[dict], dict]:
    """v2 event extraction from the financial analysis rows.

    Returns (events, info) where info carries {threshold, key_info}.
    onset_env enables the same onset refinement as the v1 path
    (apply_onset_refinement), applied after the sustain merge so the RSI
    ghost and harmonic filters see the refined events.

    pitch_source selects the series note pitches quantize from: "pyin"
    (default), the median-smoothed pYIN f0 as in the v1 extractor, or
    "trend", the consensus-filtered trend (the reference's v2 semantics,
    which smooths across note boundaries; see aegis_tpu/core/events.py).
    """
    T = min(len(rake_mask), len(f0), len(rms), len(voiced_flag), len(active_probs))
    arrays = [rake_mask, f0, voiced_flag, active_probs, rms, trend, artic_codes,
              slide_codes, financial_confidence]
    (rake_mask, f0, voiced_flag, active_probs, rms, trend, artic_codes,
     slide_codes, financial_confidence) = (a[:T] for a in arrays)

    # track-referenced dB plane (see extract_events_v1's note)
    rms_db = amplitude_to_db(rms, ref=rms_ref)
    if rms_ref is not None and rms_floor_db is not None:
        rms_db = np.maximum(rms_db, np.float32(rms_floor_db))
    combined_conf = active_probs * 0.5 + financial_confidence * 0.5

    if confidence_threshold is None:
        confidence_threshold = trend_ref.adaptive_confidence_threshold(combined_conf)

    min_frames = int((min_note_duration_ms / 1000.0) * sr / hop_length)
    sustain_frames = int((sustain_ms / 1000.0) * sr / hop_length)

    if pitch_source == "pyin":
        freq = np.asarray(
            medfilt(np.nan_to_num(f0), kernel_size=3) if T >= 3
            else np.nan_to_num(f0), dtype=np.float64)
    else:
        freq = np.asarray(trend, dtype=np.float64)
    finite = np.isfinite(freq)
    active = (
        voiced_flag.astype(bool)
        & finite
        & (np.nan_to_num(freq) > 0)
        & (rms_db >= noise_gate_db)
        & ~rake_mask.astype(bool)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        notes = np.where(active, np.round(hz_to_midi(np.where(finite, freq, 1.0))), -1)
    velocity = velocity_from_db(rms_db)

    starts, ends = _segment(active, notes)
    events = _build_events(
        starts, ends, notes, combined_conf, velocity, rms_db, confidence_threshold
    )

    # per-segment articulation: last non-normal code; else first-frame code
    codes = np.asarray(artic_codes)
    for evt, s, e in zip(events, starts, ends):
        seg = codes[s : e + 1]
        special = np.where((seg >= 2) & (seg <= 4))[0]
        code = int(seg[special[-1]]) if len(special) else int(seg[0])
        evt["financial_artic"] = trend_ref.ARTIC_NAMES.get(code)
        evt["financial_slide"] = trend_ref.SLIDE_NAMES.get(int(slide_codes[s]))
        evt["technique"] = _TECHNIQUE_CODES.get(code)

    events = [e for e in events if (e["end"] - e["start"]) >= min_frames]
    events = _sustain_merge(events, sustain_frames)

    if onset_env is not None:
        events = apply_onset_refinement(events, onset_env[:T], velocity,
                                        rms_db, sr, hop_length, min_frames,
                                        onset_snap_ms,
                                        snap_fwd_ms=onset_fwd_snap_ms,
                                        onsets=onsets)

    # ghost_rsi=False defers the density-RSI pass to the caller: the RSI
    # recurrence runs from bin 0 over the WHOLE track's note density, so a
    # windowed caller must apply it globally over the spliced event list
    if ghost_rsi and len(events) > 10:
        events = filter_ghost_notes_rsi(events, sr, hop_length, rsi_threshold)

    key_info = None
    if use_harmonic_filter and len(events) > 5:
        events, key_info = apply_harmonic_context(
            events, sr, hop_length, confidence_threshold,
            harmonic_tolerance)

    info = {"threshold": float(confidence_threshold), "key_info": key_info}
    return events, info
