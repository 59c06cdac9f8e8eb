"""Frame data → note events (host side).

A copy of ``aegis_tpu/core/events.py`` (NumPy only), pointed at this
package's own helpers; ``tests/test_torch_engine.py`` holds its events equal
to the original's.

The device pipeline emits fixed-shape per-frame arrays (f0, voiced, probs,
rms, rake, trend, articulation codes...).  This module segments them into the
ragged event-dict list that is the framework's inter-layer currency
(schema from reference midi_logic.py:74-79):

  {note, start, end, confidence, velocity, track, technique, slope,
   rms_energy}

Segmentation is vectorized NumPy (boundary detection via diffs + per-segment
gathers); only the post-processing passes that are inherently sequential over
*events* (sustain merge, hammer-on pairing) are loops — event counts are tiny.

Behavioral notes vs the reference (deliberate fixes, in the spirit of
SURVEY.md Appendix A):
  * v1 trend smoothing: the reference's softmask call raises at runtime
    (midi_logic.py:41-44 passes a kwarg librosa doesn't accept) so raw f0 was
    silently used; we apply the *intended* 3-point median trend filter.
  * hammer-on/pull-off "weak attack": the reference divides negative dB values
    (midi_logic.py:133-135), inverting the test for louder attacks; we use
    velocity ratio < 0.7 OR an energy *drop* > 1 dB.
  * RSI ghost filter: the reference bins event times in frame units while
    documenting 100 ms bins (financial_analysis.py:339-344); we bin in
    seconds.
  * technique field: only real techniques (bend/vibrato/slide/hammer_on/
    pull_off) are stored; the reference sometimes stored 'normal'/'noise'.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import medfilt

from aegis_tpu_torch.ref import trend_ref
from aegis_tpu_torch.ref.dsp_ref import amplitude_to_db, hz_to_midi
from aegis_tpu_torch.utils.prof import phase


# --------------------------------------------------------------------------
# Articulation detection (v1): slope + detrended oscillation
# (reference midi_logic.py:6-30)
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# Vectorized segmentation
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# v1 extraction (reference midi_logic.get_midi_events)
# --------------------------------------------------------------------------

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
    from aegis_tpu_torch.native import segment_events_v1_native

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
    from aegis_tpu_torch.core.cqt import pick_onsets, split_events_at_onsets

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


# --------------------------------------------------------------------------
# v2 "financial" extraction (reference midi_logic_financial.py)
# --------------------------------------------------------------------------

def filter_ghost_notes_rsi(
    events: List[dict], sr: int, hop_length: int, rsi_threshold: float = 70.0
) -> List[dict]:
    """RSI over 100 ms note-density bins removes notes in overdense regions
    (reference financial_analysis.py:322-362, with time in real seconds)."""
    if not events:
        return events
    spf = hop_length / sr
    max_time = max(e["end"] * spf for e in events)
    n_bins = max(int(max_time * 10), 1)
    density = np.zeros(n_bins)
    for e in events:
        s = int(e["start"] * spf * 10)
        t = int(e["end"] * spf * 10)
        if s < n_bins:
            density[s : min(max(t, s + 1), n_bins)] += 1
    from aegis_tpu_torch.core import trend_fast

    rsi_values = trend_fast.rsi(density, period=14)
    out = []
    for e in events:
        idx = int(e["start"] * spf * 10)
        if idx >= len(rsi_values) or rsi_values[idx] < rsi_threshold:
            out.append(e)
    return out


_TECHNIQUE_CODES = {2: "bend", 3: "vibrato"}  # from trend ARTIC codes


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
    """v2 event extraction from device-side financial analysis outputs.

    Returns (events, info) where info carries {threshold, key_info}.
    Mirrors reference midi_logic_financial.py:117-386 (vectorized; see module
    docstring for deliberate fixes).  onset_env enables the same onset
    refinement as the v1 path (apply_onset_refinement), applied after the
    sustain merge so the RSI ghost and harmonic filters see the refined
    events.

    pitch_source selects the series note pitches quantize from:
      * "pyin" (default) — the median-smoothed pYIN f0, exactly as the v1
        extractor.  The consensus trend still drives articulations,
        slides, combined confidence and the adaptive threshold — the
        financial stack's actual value.
      * "trend" — the consensus-filtered trend, the reference's v2
        semantics (midi_logic_financial.py:152-177).  Measured (truth
        clips, 22.05 kHz): the trend smooths ACROSS note boundaries,
        minting one-semitone transition notes (61 between a 60 and a 62,
        sustained for ~200 ms) and delaying pitch locks past 100 ms —
        ground-truth F1 0.11 (scale) / 0.33 (Karplus-Strong) vs 1.00 for
        "pyin" with identical device analysis.  Kept as an opt-in spec
        mirror; VALIDATION.md documents the divergence.
    """
    T = min(len(rake_mask), len(f0), len(rms), len(voiced_flag), len(active_probs))
    with phase("aegis.fin_extract", frames=T) as span:
        with phase("aegis.fin_segment"):
            arrays = [rake_mask, f0, voiced_flag, active_probs, rms, trend,
                      artic_codes, slide_codes, financial_confidence]
            (rake_mask, f0, voiced_flag, active_probs, rms, trend, artic_codes,
             slide_codes, financial_confidence) = (a[:T] for a in arrays)

            # track-referenced dB plane (see extract_events_v1's note)
            rms_db = amplitude_to_db(rms, ref=rms_ref)
            if rms_ref is not None and rms_floor_db is not None:
                rms_db = np.maximum(rms_db, np.float32(rms_floor_db))
            combined_conf = active_probs * 0.5 + financial_confidence * 0.5

            if confidence_threshold is None:
                confidence_threshold = (
                    trend_ref.adaptive_confidence_threshold(combined_conf))

            min_frames = int((min_note_duration_ms / 1000.0) * sr
                             / hop_length)
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
                notes = np.where(active, np.round(hz_to_midi(
                    np.where(finite, freq, 1.0))), -1)
            velocity = velocity_from_db(rms_db)

            starts, ends = _segment(active, notes)
            events = _build_events(starts, ends, notes, combined_conf,
                                   velocity, rms_db, confidence_threshold)

            # per-segment articulation: last non-normal code; else
            # first-frame code
            codes = np.asarray(artic_codes)
            for evt, s, e in zip(events, starts, ends):
                seg = codes[s : e + 1]
                special = np.where((seg >= 2) & (seg <= 4))[0]
                code = int(seg[special[-1]]) if len(special) else int(seg[0])
                evt["financial_artic"] = trend_ref.ARTIC_NAMES.get(code)
                evt["financial_slide"] = trend_ref.SLIDE_NAMES.get(
                    int(slide_codes[s]))
                evt["technique"] = _TECHNIQUE_CODES.get(code)

            events = [e for e in events
                      if (e["end"] - e["start"]) >= min_frames]
            events = _sustain_merge(events, sustain_frames)

            if onset_env is not None:
                events = apply_onset_refinement(
                    events, onset_env[:T], velocity, rms_db, sr, hop_length,
                    min_frames, onset_snap_ms, snap_fwd_ms=onset_fwd_snap_ms,
                    onsets=onsets)

        # ghost_rsi=False defers the density-RSI pass to the caller: the
        # RSI recurrence runs from bin 0 over the WHOLE track's note
        # density, so a windowed caller (the live horizon cache) must apply
        # it globally over the spliced event list, not inside a tail window
        if ghost_rsi and len(events) > 10:
            with phase("aegis.fin_ghost"):
                events = filter_ghost_notes_rsi(events, sr, hop_length,
                                                rsi_threshold)

        key_info = None
        if use_harmonic_filter and len(events) > 5:
            with phase("aegis.fin_harmonic"):
                events, key_info = apply_harmonic_context(
                    events, sr, hop_length, confidence_threshold,
                    harmonic_tolerance)
        if span is not None:
            main = sum(e["track"] == "main" for e in events)
            span.attrs.update(events_main=main,
                              events_safe=len(events) - main)

    info = {"threshold": float(confidence_threshold), "key_info": key_info}
    return events, info


def apply_harmonic_context(
    events: List[dict], sr: int, hop_length: int,
    confidence_threshold: float, harmonic_tolerance: int = 1,
) -> Tuple[List[dict], Optional[dict]]:
    """The financial extractor's harmonic section as a standalone pass:
    key detection over the event list, the out-of-scale mask, the
    chord-context confidence adjustment and the threshold track split.
    GLOBAL by construction (the key is detected from every event), which
    is why the live horizon cache re-runs it per poll over the full
    spliced list instead of freezing its outputs."""
    from aegis_tpu_torch.harmony.key import HarmonicAnalyzer

    analyzer = HarmonicAnalyzer()
    midi_notes = np.array([e["note"] for e in events])
    confidences = np.array([e["confidence"] for e in events])
    key_info = analyzer.detect_key(midi_notes)
    # the scale filter only MASKS (confidences pass through unchanged,
    # harmony/key.py) — survivors just get the harmonic_valid tag
    _, _, out_of_scale = analyzer.filter_out_of_scale_notes(
        midi_notes, confidences, key_info, tolerance=harmonic_tolerance
    )
    kept = [e for e, bad in zip(events, out_of_scale) if not bad]
    for e in kept:
        e["harmonic_valid"] = True
    if kept:
        adjusted = analyzer.adaptive_filter_by_context(
            np.array([e["note"] for e in kept]),
            np.array([e["start"] * (hop_length / sr) * 1000.0 for e in kept]),
            np.array([e["confidence"] for e in kept]),
            key_info,
        )
        for e, c in zip(kept, adjusted):
            e["confidence"] = float(c)
            e["track"] = "main" if c >= confidence_threshold else "safe"
    return kept, key_info
