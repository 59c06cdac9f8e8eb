"""The host half of the v1 reference: note events and the MIDI encoder.

A frozen copy, code unchanged but for the C++ fast path (its NumPy twin is
kept), of the port's NumPy event extractor (``core/events.py``'s v1 path,
``core/cqt.py``'s onset picking and splitting, ``ref/dsp_ref.py``'s dB
helpers) and its Standard MIDI File writer (``midi/encode.py``,
``midi/smf.py``) at the commit the benchmark was defined on.  The
benchmark imports nothing of the program, so a change to the program's
event semantics shows as a gap against this file.
"""

from __future__ import annotations

import dataclasses
import io
import math
import struct
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.signal import medfilt


def power_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(max(amin, abs(ref)))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec.astype(np.float32)


def amplitude_to_db(S: np.ndarray, ref: float | None = None, amin: float = 1e-5,
                    top_db: float = 80.0) -> np.ndarray:
    if ref is None:
        ref = float(np.max(S))
    return power_to_db(S**2, ref=ref**2, amin=amin**2, top_db=top_db)


def hz_to_midi(hz):
    return 12.0 * np.log2(np.asanyarray(hz) / 440.0) + 69.0


def pick_onsets(envelope: np.ndarray, sr: int, hop_length: int,
                pre_max_ms: float = 30.0, post_max_ms: float = 0.0,
                pre_avg_ms: float = 100.0, post_avg_ms: float = 100.0,
                delta: float = 0.07, wait_ms: float = 30.0,
                ) -> np.ndarray:
    """Peak-pick onset frames from the envelope (host, librosa-style).

    A frame is an onset iff it is the max of [t-pre_max, t+post_max], at
    least `delta` above the mean of [t-pre_avg, t+post_avg], and at least
    `wait` frames after the previous onset.  Returns frame indices.

    Note: every window size is floored at 1 frame, so the default
    post_max_ms=0.0 still requires env[t] >= env[t+1] — onsets land on
    the local flux PEAK, one frame later than a pure rising-edge pick.
    This inclusive-window convention is what every downstream snap/birth
    gate was truth-measured against (VALIDATION.md); do not "fix" it to
    the exclusive-slice reading without re-running those sweeps.
    """
    env = np.asarray(envelope, np.float64)
    T = len(env)
    if T == 0:
        return np.zeros(0, np.int64)
    spf = hop_length / sr * 1000.0
    pre_max = max(int(round(pre_max_ms / spf)), 1)
    post_max = max(int(round(post_max_ms / spf)), 1)
    pre_avg = max(int(round(pre_avg_ms / spf)), 1)
    post_avg = max(int(round(post_avg_ms / spf)), 1)
    wait = max(int(round(wait_ms / spf)), 1)

    env_n = env / max(env.max(), 1e-10)

    def _window(arr, pre, post, pad, reducer):
        """Sliding [t-pre, t+post] reduction via a strided window view."""
        w = pre + post + 1
        padded = np.concatenate([np.full(pre, pad), arr, np.full(post, pad)])
        view = np.lib.stride_tricks.sliding_window_view(padded, w)
        return reducer(view, axis=1)

    # edge windows are CLIPPED in the sequential formulation, so the mean
    # pad must not bias it: use NaN + nanmean (max pads with -inf)
    win_max = _window(env_n, pre_max, post_max, -np.inf, np.max)
    win_mean = _window(env_n, pre_avg, post_avg, np.nan, np.nanmean)
    candidate = (env_n >= win_max) & (env_n >= win_mean + delta) & (env_n > 0)

    # the `wait` debounce is inherently sequential, but only over the few
    # candidate frames
    onsets = []
    last = -wait - 1
    for t in np.where(candidate)[0]:
        if t - last >= wait:
            onsets.append(t)
            last = t
    return np.asarray(onsets, np.int64)


def split_events_at_onsets(events: list, onsets: np.ndarray,
                           min_frames: int = 2,
                           tail_frames: int | None = None) -> list:
    """Split note events whose span contains an interior onset — re-attacks
    of the same pitch that pitch-only segmentation merges (BASELINE.json
    config 2: onset detection + RMS dynamic-velocity mapping).

    ``tail_frames`` (default: min_frames) is the minimum length of the
    piece AFTER a cut.  Pass the pitch tracker's lock-lag there (~100 ms
    for pYIN) to reject cuts near the event END: an onset that close to
    the end is the NEXT note's attack bleeding into this event's
    overhanging voicing tail, not a re-attack — splitting there mints a
    phantom stub of the old pitch covering the new note's attack frames
    (measured on the scale track: a 3-frame note-62 stub at the note-64
    boundary) and the stub then blocks snap_starts_to_onsets from
    claiming the onset for the real next note."""
    if len(onsets) == 0:
        return events
    if tail_frames is None:
        tail_frames = min_frames
    # onsets arrive ascending (pick_onsets emits peak indices in order);
    # searchsorted restricts each event to its own onset window — the old
    # full scan per event was O(events x onsets) and dominated the LIVE
    # poll cost on long live runs (profiled round 3: 0.52 s of a 0.65 s
    # poll at 5 min was this loop's 1.45M generator steps)
    ons = np.asarray(onsets, np.int64)
    out = []
    # keep each cut at least min_frames from BOTH the event bounds and
    # the previous accepted cut, so no sub-minimum segment is created.
    # Strict lower bound: a segment [prev, o-1] has duration
    # (end - start) == o - prev - 1, so o == prev + min_frames would
    # emit a segment one frame below the caller's minimum.  Both window
    # bounds are ONE vectorized searchsorted over all events (identical
    # indices to the per-event calls they replace).
    starts_a = np.fromiter((e["start"] for e in events), np.int64,
                           len(events))
    ends_a = np.fromiter((e["end"] for e in events), np.int64, len(events))
    los = np.searchsorted(ons, starts_a + min_frames, side="right")
    his = np.searchsorted(ons, ends_a - tail_frames, side="right")
    for e, lo, hi in zip(events, los.tolist(), his.tolist()):
        cuts = []
        prev = e["start"]
        for o in ons[lo:hi].tolist():
            if prev + min_frames < o:
                cuts.append(o)
                prev = o
        if not cuts:
            out.append(e)
            continue
        bounds = [e["start"]] + cuts + [e["end"] + 1]
        for i in range(len(bounds) - 1):
            seg = dict(e)
            seg["start"], seg["end"] = bounds[i], bounds[i + 1] - 1
            out.append(seg)
    return out


def detect_articulations_v1(
    f0: np.ndarray, start: int, end: int
) -> Tuple[Optional[str], float]:
    if end <= start:
        return None, 0.0
    seg = f0[start : end + 1]
    seg = seg[np.isfinite(seg) & (seg > 0)]
    if len(seg) < 3:
        return None, 0.0
    notes = hz_to_midi(seg)
    x = np.arange(len(notes))
    coeffs = np.polyfit(x, notes, 1)
    slope = float(coeffs[0])
    detrended = notes - np.polyval(coeffs, x)
    vibrato_amp = float(np.max(detrended) - np.min(detrended))
    if vibrato_amp > 0.3:
        return "vibrato", slope
    if slope > 0.05:
        return "bend", slope
    if abs(slope) > 0.02:
        return "slide", slope
    return None, 0.0


# pYIN's worst measured pitch-lock lag after a physical attack (91 ms on
# the scale track's post-rake note); sets the onset-split tail guard
PYIN_LAG_MS = 100.0


# Echo guard for onset re-attack splitting: minimum local RMS rise (dB) at
# an interior onset for it to cut an event.  See apply_onset_refinement's
# docstring for the measurement behind the default.
SPLIT_MIN_RISE_DB = 2.5


def velocity_from_db(rms_db: np.ndarray) -> np.ndarray:
    """dB -> MIDI velocity, clip((dB+80)*1.5, 0..127) — the reference curve
    (midi_logic.py:71).  Single definition shared by every engine."""
    return np.clip((np.asarray(rms_db) + 80.0) * 1.5, 0, 127).astype(np.int64)


def _segment(active: np.ndarray, notes: np.ndarray):
    """Split the active mask into constant-note segments.

    Returns (starts, ends) frame indices (inclusive) per segment.
    """
    T = len(active)
    if T == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    prev_active = np.concatenate([[False], active[:-1]])
    prev_notes = np.concatenate([[-1], notes[:-1]])
    new_seg = active & (~prev_active | (notes != prev_notes))
    nxt_active = np.concatenate([active[1:], [False]])
    nxt_notes = np.concatenate([notes[1:], [-1]])
    end_seg = active & (~nxt_active | (notes != nxt_notes))
    return np.where(new_seg)[0], np.where(end_seg)[0]


def _build_events(
    starts: np.ndarray,
    ends: np.ndarray,
    notes: np.ndarray,
    confidence: np.ndarray,
    velocity: np.ndarray,
    rms_db: np.ndarray,
    confidence_threshold: float,
) -> List[dict]:
    events = []
    for s, e in zip(starts, ends):
        conf = float(confidence[s])
        events.append(
            {
                "note": int(notes[s]),
                "start": int(s),
                "end": int(e),
                "confidence": conf,
                "velocity": int(velocity[s]),
                "track": "main" if conf >= confidence_threshold else "safe",
                "rms_energy": float(rms_db[s]),
                "technique": None,
                "slope": 0.0,
            }
        )
    return events


def _sustain_merge(events: List[dict], sustain_frames: int) -> List[dict]:
    """Merge same-note events separated by short gaps (no merge across a
    technique; reference midi_logic.py:112-124)."""
    if len(events) < 2:
        return events
    merged = []
    curr = events[0]
    for nxt in events[1:]:
        gap = nxt["start"] - curr["end"]
        if nxt["note"] == curr["note"] and gap <= sustain_frames and not curr.get("technique"):
            curr["end"] = nxt["end"]
        else:
            merged.append(curr)
            curr = nxt
    merged.append(curr)
    return merged


def snap_starts_to_onsets(events: List[dict], onsets: np.ndarray,
                          rms_db: np.ndarray, back_frames: int,
                          fwd_frames: int = 0) -> List[dict]:
    """Move each event's start back to the physical attack time.

    pYIN needs several pitch periods to lock after an attack (the pluck
    transient is unpitched), so its first voiced frame lags the physical
    pluck — measured 91 ms on the scale track's post-rake note, outside
    the 50 ms onset tolerance of standard transcription scoring.  Worse,
    the PREVIOUS note's voicing tail often overhangs the true boundary,
    so the lag cannot be fixed by moving the start to the raw onset peak
    alone.

    Rule: anchor on the latest picked onset within ``back_frames`` of the
    segment start, then snap the start to the steepest RMS RISE between
    that onset and the current start — the rise is the attack itself.
    Candidate rules rejected by measurement (all four truth clips):
      * the onset peak itself — overshoots when the peak belongs to an
        earlier transient (a rake burst decaying into the pluck: 100 ms
        early on the Karplus-Strong track, a miss at 50 ms tolerance);
      * the RMS trough (librosa onset_backtrack-style) — the burst can
        run straight into the pluck with no dip, so the "trough" is the
        flat plateau's FIRST frame, same miss.
    On a flat segment (argmax of an all-zero diff = 0) this degrades to
    onset+1, correct for butted notes at equal level.  If the previous
    event's voicing tail overhangs the new start it is truncated — the
    attack belongs to the new note (pYIN holds the old pitch ~20 ms past
    a boundary, so the overhang is systematic).  Attack dynamics
    (velocity / rms_energy) are deliberately NOT re-read at the snapped
    frame: the pre-attack frames are the quietest instant, not the
    note's loudness.

    The reference has no equivalent (its events inherit pyin's late lock);
    this is a documented deliberate divergence (VALIDATION.md).
    """
    if (len(onsets) == 0 or back_frames <= 0) and fwd_frames <= 0:
        return events
    onsets = np.asarray(onsets, np.int64)
    rms_db = np.asarray(rms_db, np.float64)
    out = [dict(e) for e in events]
    if len(onsets) and back_frames > 0:
        for i, e in enumerate(out):
            lo = e["start"] - back_frames
            if i:  # never swallow the previous note's own attack
                lo = max(lo, out[i - 1]["start"] + 1)
            cand = onsets[(onsets >= max(lo, 0)) & (onsets <= e["start"])]
            if not len(cand):
                continue
            o = int(cand[-1])
            seg = rms_db[o : e["start"] + 1]
            if len(seg) < 2:
                continue
            new_start = o + int(np.argmax(np.diff(seg))) + 1
            if new_start >= e["start"]:
                continue
            if i and out[i - 1]["end"] >= new_start:
                out[i - 1]["end"] = new_start - 1
            e["start"] = new_start

    if fwd_frames > 0:
        # FORWARD snap — the mirror rule for EARLY-firing backends.
        # PitchNet standardizes magnitude spectra (phase-blind), so its
        # voicing fires as soon as a window CONTAINS the upcoming attack:
        # in start-indexed frame time that is up to ~one analysis window
        # BEFORE the physical pluck (measured 53-77 ms on the KS truth
        # clips — outside the 50 ms tolerance).  When the RMS still RISES
        # substantially after an event's start (the SPLIT_MIN_RISE_DB
        # echo-guard bound — at a true attack-aligned start the first
        # frame already sits at the peak, so the guard no-ops), the
        # event's first frames precede its own attack: move the start to
        # the steepest RMS rise, the same attack-time definition the
        # backward rule uses.  No picked-onset anchor here: a rake decaying
        # straight into the pluck merges both transients into ONE pick at
        # the rake (measured on the KS clip: attack flux 11.4 at frame 63
        # eclipsed by rake flux 46.9 at 59), so the rise itself is the only
        # reliable attack marker.  pYIN never fires early (CMNDF needs
        # periods IN the window), so this pass is enabled only for the
        # neural backend (the engines plumb snap_fwd_ms).
        for i, e in enumerate(out):
            hi = min(e["start"] + fwd_frames, e["end"])
            seg = rms_db[e["start"]: hi + 1]
            if len(seg) < 2:
                continue
            # rise measured from the pre-peak TROUGH, not seg[0]: a rake
            # decaying into the pluck leaves the start frame loud, so the
            # peak clears it by less than the true attack rise (measured
            # 2.4 dB vs the 4.4 dB trough rise on the 44.1 kHz KS clip —
            # the guard missed by 0.1 dB anchored at seg[0])
            peak = int(np.argmax(seg))
            if seg[peak] - seg[: peak + 1].min() < SPLIT_MIN_RISE_DB:
                continue
            new_start = e["start"] + int(np.argmax(np.diff(seg))) + 1
            if new_start <= e["start"] or new_start >= e["end"]:
                continue
            e["start"] = new_start
            # unlike the backward snap (whose target frames are the quiet
            # pre-attack instant, docstring above), the forward snap LEAVES
            # the quiet pre-attack frames: re-read attack dynamics at the
            # snapped frame, the same convention as the split pass
            e["velocity"] = int(velocity_from_db(rms_db[new_start]))
            e["rms_energy"] = float(rms_db[new_start])
    return out


def _hammer_pull_pairs(events: List[dict], ms_per_frame: float) -> None:
    """Tag hammer-on / pull-off on near-adjacent pairs with a weak attack
    (reference midi_logic.py:127-146; see module docstring for the fixed
    weak-attack test)."""
    for i in range(len(events) - 1):
        curr, nxt = events[i], events[i + 1]
        gap_ms = (nxt["start"] - curr["end"]) * ms_per_frame
        if gap_ms >= 30:
            continue
        pitch_diff = nxt["note"] - curr["note"]
        velocity_ratio = nxt["velocity"] / max(curr["velocity"], 1)
        energy_drop = nxt.get("rms_energy", 0.0) - curr.get("rms_energy", 0.0)
        weak_attack = velocity_ratio < 0.7 or energy_drop < -1.0
        if 0 < pitch_diff <= 2 and weak_attack:
            nxt["technique"] = "hammer_on"
            nxt["slope"] = 0.0
        elif -2 <= pitch_diff < 0 and weak_attack:
            nxt["technique"] = "pull_off"
            nxt["slope"] = 0.0


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


#: semitone intervals at which a decaying string's harmonic can be decoded
#: as a phantom note by a phase-blind pitch backend (h2..h8)
_HARMONIC_INTERVALS = frozenset((12, 19, 24, 28, 31, 34, 36))


def drop_harmonic_tail_ghosts(events: List[dict], onsets: np.ndarray,
                              rms_db: np.ndarray, sr: int, hop_length: int,
                              min_rise_db: float = SPLIT_MIN_RISE_DB,
                              max_ms: float = 220.0) -> List[dict]:
    """Neural-backend tail guard: merge a brief harmonic-interval phantom
    back into the note whose decay tail it rides on.

    PitchNet has no HMM transition prior, so once a pluck's fundamental
    decays below a strong partial the net can flip to that partial for a
    few frames — measured on the 60 s bench track (2026-08-19): the tail
    of a 220 Hz note decodes as 664.6 Hz (its 3rd harmonic, MIDI 76,
    confidence 0.998!) for 6 frames right before the next attack, the
    single event keeping `neural_truth_f1` at 0.9967.  pYIN's Viterbi
    prior makes such 19-semitone excursions impossible, so this pass runs
    only for the neural backend (alongside the forward snap).

    An event is a tail phantom — merged into its predecessor (the string
    IS still sounding; only the decoded octave/partial is wrong) — iff:
      * its pitch sits a harmonic interval ABOVE the immediately preceding
        event's (h2..h8 — a real melody can land there too, but only via
        a new attack, which the next two conditions require);
      * it continues that event contiguously (gap <= 2 frames) and briefly
        (<= ``max_ms`` — the flip lives in the fundamental's last audible
        span, bounded well under a real note's duration);
      * no picked onset falls near its start (+-2 frames), and the RMS
        over all but its final 2 frames (where the NEXT note's attack
        already bleeds in) never rises ``min_rise_db`` above its running
        minimum — i.e. it sits strictly inside a decay."""
    if not events:
        return events
    onsets = np.asarray(onsets, np.int64)
    rms_db = np.asarray(rms_db, np.float64)
    max_frames = int((max_ms / 1000.0) * sr / hop_length)
    out: List[dict] = []
    for e in sorted(events, key=lambda ev: (ev["start"], ev["note"])):
        prev = out[-1] if out else None
        if prev is not None:
            seg = rms_db[e["start"]: max(e["end"] - 1, e["start"] + 1)]
            rise = (float(np.max(seg - np.minimum.accumulate(seg)))
                    if len(seg) >= 2 else 0.0)
            born_at_onset = bool(len(onsets)) and bool(
                np.min(np.abs(onsets - e["start"])) <= 2)
            if ((e["note"] - prev["note"]) in _HARMONIC_INTERVALS
                    and 0 <= e["start"] - prev["end"] <= 2
                    and (e["end"] - e["start"] + 1) <= max_frames
                    and not born_at_onset
                    and rise < min_rise_db):
                prev["end"] = max(prev["end"], e["end"])
                continue
        out.append(e)
    return out


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


DEFAULT_TICKS_PER_BEAT = 480


DEFAULT_TEMPO_US = 500000  # 120 BPM


def second2tick(seconds: float, ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT,
                tempo: int = DEFAULT_TEMPO_US) -> float:
    return seconds * 1e6 / tempo * ticks_per_beat


def _encode_varlen(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _decode_varlen(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


@dataclasses.dataclass
class MidiMessage:
    """One MIDI event with a delta ``time`` in ticks.

    ``type`` is one of: note_on, note_off, program_change, pitchwheel,
    control_change, track_name, set_tempo, end_of_track, unknown_meta,
    sysex.
    """

    type: str
    time: int = 0
    note: int = 0
    velocity: int = 0
    program: int = 0
    pitch: int = 0  # pitchwheel: -8192..8191
    control: int = 0
    value: int = 0
    channel: int = 0
    name: str = ""  # track_name
    tempo: int = DEFAULT_TEMPO_US  # set_tempo
    data: bytes = b""  # unknown meta / sysex payload

    @property
    def is_meta(self) -> bool:
        return self.type in (
            "track_name",
            "set_tempo",
            "end_of_track",
            "unknown_meta",
        )


class MidiTrack(list):
    """A list of MidiMessage with delta times."""

    def append_msg(self, **kw) -> "MidiTrack":
        self.append(MidiMessage(**kw))
        return self


class MidiFile:
    def __init__(self, ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT):
        self.ticks_per_beat = ticks_per_beat
        self.tracks: List[MidiTrack] = []

    # ------------------------------------------------------------------ write

    def _encode_message(self, msg: MidiMessage) -> bytes:
        t = msg.type
        ch = msg.channel & 0x0F
        if t == "note_on":
            return bytes([0x90 | ch, msg.note & 0x7F, msg.velocity & 0x7F])
        if t == "note_off":
            return bytes([0x80 | ch, msg.note & 0x7F, msg.velocity & 0x7F])
        if t == "program_change":
            return bytes([0xC0 | ch, msg.program & 0x7F])
        if t == "control_change":
            return bytes([0xB0 | ch, msg.control & 0x7F, msg.value & 0x7F])
        if t == "pitchwheel":
            v = int(msg.pitch) + 8192
            v = max(0, min(16383, v))
            return bytes([0xE0 | ch, v & 0x7F, (v >> 7) & 0x7F])
        if t == "track_name":
            payload = msg.name.encode("utf-8")
            return bytes([0xFF, 0x03]) + _encode_varlen(len(payload)) + payload
        if t == "set_tempo":
            return bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", msg.tempo)[1:]
        if t == "end_of_track":
            return bytes([0xFF, 0x2F, 0x00])
        raise ValueError(f"cannot encode message type {t!r}")

    def save(self, file: Union[str, io.BytesIO, None] = None) -> Optional[bytes]:
        """Serialize.  With a path/stream, writes there; with None, returns
        bytes."""
        out = io.BytesIO()
        out.write(b"MThd")
        out.write(struct.pack(">IHHH", 6, 1, len(self.tracks), self.ticks_per_beat))
        for track in self.tracks:
            body = io.BytesIO()
            has_eot = False
            for msg in track:
                body.write(_encode_varlen(int(msg.time)))
                body.write(self._encode_message(msg))
                if msg.type == "end_of_track":
                    has_eot = True
            if not has_eot:
                body.write(_encode_varlen(0))
                body.write(bytes([0xFF, 0x2F, 0x00]))
            payload = body.getvalue()
            out.write(b"MTrk")
            out.write(struct.pack(">I", len(payload)))
            out.write(payload)
        blob = out.getvalue()

        if file is None:
            return blob
        if hasattr(file, "write"):
            file.write(blob)
            return None
        with open(file, "wb") as f:
            f.write(blob)
        return None

    # ------------------------------------------------------------------- read

    @classmethod
    def load(cls, path_or_bytes: Union[str, bytes, io.BytesIO]) -> "MidiFile":
        if isinstance(path_or_bytes, bytes):
            data = path_or_bytes
        elif hasattr(path_or_bytes, "read"):
            data = path_or_bytes.read()
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()

        if data[:4] != b"MThd":
            raise ValueError("not an SMF file")
        # truncated/garbage input surfaces as ValueError, not struct.error /
        # IndexError — the server maps ValueError to a 400
        try:
            (hlen, _fmt, n_tracks, division) = struct.unpack_from(
                ">IHHH", data, 4)
            mid = cls(ticks_per_beat=division)
            pos = 8 + hlen
            for _ in range(n_tracks):
                if data[pos : pos + 4] != b"MTrk":
                    raise ValueError("bad track chunk")
                (tlen,) = struct.unpack_from(">I", data, pos + 4)
                body = data[pos + 8 : pos + 8 + tlen]
                mid.tracks.append(cls._parse_track(body))
                pos += 8 + tlen
        except (struct.error, IndexError) as e:
            raise ValueError(f"corrupt SMF: {e}") from e
        return mid

    @staticmethod
    def _parse_track(body: bytes) -> MidiTrack:
        track = MidiTrack()
        pos = 0
        running_status = 0
        while pos < len(body):
            delta, pos = _decode_varlen(body, pos)
            status = body[pos]
            if status & 0x80:
                pos += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status

            if status == 0xFF:  # meta
                meta_type = body[pos]
                pos += 1
                length, pos = _decode_varlen(body, pos)
                payload = body[pos : pos + length]
                pos += length
                if meta_type == 0x03:
                    track.append(
                        MidiMessage("track_name", time=delta,
                                    name=payload.decode("utf-8", "replace"))
                    )
                elif meta_type == 0x51:
                    tempo = struct.unpack(">I", b"\x00" + payload)[0]
                    track.append(MidiMessage("set_tempo", time=delta, tempo=tempo))
                elif meta_type == 0x2F:
                    track.append(MidiMessage("end_of_track", time=delta))
                else:
                    track.append(
                        MidiMessage("unknown_meta", time=delta, data=payload,
                                    value=meta_type)
                    )
            elif status in (0xF0, 0xF7):  # sysex
                length, pos = _decode_varlen(body, pos)
                payload = body[pos : pos + length]
                pos += length
                track.append(MidiMessage("sysex", time=delta, data=payload))
            else:
                kind = status & 0xF0
                ch = status & 0x0F
                if kind == 0x90:
                    note, vel = body[pos], body[pos + 1]
                    pos += 2
                    # note_on velocity 0 is a note_off by convention
                    mtype = "note_on" if vel > 0 else "note_off"
                    track.append(
                        MidiMessage(mtype, time=delta, note=note, velocity=vel,
                                    channel=ch)
                    )
                elif kind == 0x80:
                    note, vel = body[pos], body[pos + 1]
                    pos += 2
                    track.append(
                        MidiMessage("note_off", time=delta, note=note,
                                    velocity=vel, channel=ch)
                    )
                elif kind == 0xC0:
                    track.append(
                        MidiMessage("program_change", time=delta,
                                    program=body[pos], channel=ch)
                    )
                    pos += 1
                elif kind == 0xD0:  # channel pressure (skip payload)
                    pos += 1
                elif kind == 0xE0:
                    lsb, msb = body[pos], body[pos + 1]
                    pos += 2
                    track.append(
                        MidiMessage("pitchwheel", time=delta,
                                    pitch=((msb << 7) | lsb) - 8192, channel=ch)
                    )
                elif kind in (0xA0, 0xB0):
                    a, b = body[pos], body[pos + 1]
                    pos += 2
                    if kind == 0xB0:
                        track.append(
                            MidiMessage("control_change", time=delta, control=a,
                                        value=b, channel=ch)
                        )
                else:
                    raise ValueError(f"unhandled status byte 0x{status:02x}")
        return track


def _tempo_us(bpm) -> int:
    """set_tempo microseconds per beat; rejects bpm values the tick math
    cannot survive (0 -> ZeroDivisionError, nan -> int(nan))."""
    import math

    bpm = float(bpm)
    if not math.isfinite(bpm) or bpm <= 0:
        raise ValueError(f"bpm must be a positive finite number, got {bpm}")
    return max(1, int(round(60e6 / bpm)))


def events_to_midi(
    events: List[dict],
    sr: int,
    hop_length: int,
    *,
    midi_program: int = 27,
    vibrato_rate: float = 5.0,
    vibrato_depth: float = 0.3,
    bpm: Optional[float] = None,
    output: Union[str, io.BytesIO, None] = None,
) -> Optional[bytes]:
    """v1 encoder: dual main/safe tracks with bend & vibrato pitchwheel curves.

    ``bpm`` (beyond-reference, core.tempo): write a set_tempo meta event and
    use that tempo in the tick math, so note WALL-CLOCK times are unchanged
    but the musical grid aligns with the track (the reference always encodes
    at an implicit 120 BPM).  None keeps the reference behavior.

    Returns the SMF bytes when ``output`` is None, otherwise writes to the
    path / stream.
    """
    tempo_us = DEFAULT_TEMPO_US if bpm is None else _tempo_us(bpm)
    mid = MidiFile(ticks_per_beat=DEFAULT_TICKS_PER_BEAT)
    track_main, track_safe = MidiTrack(), MidiTrack()
    mid.tracks.extend([track_main, track_safe])
    if bpm is not None:
        track_main.append(MidiMessage("set_tempo", tempo=tempo_us, time=0))
    for t in (track_main, track_safe):
        t.append(MidiMessage("program_change", program=midi_program, time=0))

    secs_per_frame = hop_length / sr
    ticks_per_sec = second2tick(1.0, DEFAULT_TICKS_PER_BEAT, tempo_us)

    timeline = []  # absolute-tick event list, sorted later
    for evt in events:
        st = int(evt["start"] * secs_per_frame * ticks_per_sec)
        et = int(evt["end"] * secs_per_frame * ticks_per_sec)
        technique = evt.get("technique")
        velocity = int(evt["velocity"])
        if technique == "hammer_on":
            velocity = int(velocity * 0.6)  # softened attack
        elif technique == "pull_off":
            velocity = int(velocity * 0.5)
        # velocity 0 is a legal EVENT (velocity_from_db clips -80 dB frames
        # to 0, and the technique scaling above can floor 1 to 0) but a
        # note_on with velocity 0 means note_off in SMF — clamp on encode.
        # The high side matters too: smf.py masks with & 0x7F, so an
        # unclamped 128 would WRAP to 0 (= note_off) instead of fortissimo
        velocity = min(127, max(1, velocity))

        tr = evt["track"]
        timeline.append({"t": st, "o": "on", "n": evt["note"], "tr": tr, "v": velocity})
        timeline.append({"t": et, "o": "off", "n": evt["note"], "tr": tr, "v": 0})

        if technique == "bend":
            duration_ticks = et - st
            slope = float(evt.get("slope", 0.0))
            bend_semitones = min(2.0, abs(slope) * 10)
            direction = 1 if slope > 0 else -1
            max_bend = int(direction * (bend_semitones / 2.0) * 8191)
            n_pts = 15
            for i in range(n_pts):
                progress = i / n_pts
                curve = 1 - (1 - progress) ** 2  # fast start, slow finish
                timeline.append(
                    {
                        "t": st + int(progress * duration_ticks),
                        "o": "pw",
                        "tr": tr,
                        "pitch": int(max_bend * curve),
                    }
                )
            timeline.append({"t": et, "o": "pw", "tr": tr, "pitch": 0})
        elif technique == "vibrato":
            duration_ticks = et - st
            duration_secs = duration_ticks / ticks_per_sec
            n_pts = max(10, min(20, int(duration_secs * vibrato_rate * 4)))
            for i in range(n_pts):
                phase = (i / n_pts) * duration_secs * vibrato_rate * 2 * math.pi
                timeline.append(
                    {
                        "t": st + int((i / n_pts) * duration_ticks),
                        "o": "pw",
                        "tr": tr,
                        "pitch": int(math.sin(phase) * 8191 * vibrato_depth),
                    }
                )
            timeline.append({"t": et, "o": "pw", "tr": tr, "pitch": 0})

    timeline.sort(key=lambda x: x["t"])

    last = {"main": 0, "safe": 0}
    for e in timeline:
        track = track_main if e["tr"] == "main" else track_safe
        delta = e["t"] - last[e["tr"]]
        if e["o"] == "pw":
            track.append(MidiMessage("pitchwheel", pitch=e["pitch"], time=delta))
        else:
            track.append(
                MidiMessage(
                    "note_on" if e["o"] == "on" else "note_off",
                    note=int(e["n"]),
                    velocity=int(e["v"]),
                    time=delta,
                )
            )
        last[e["tr"]] = e["t"]

    return mid.save(output)
