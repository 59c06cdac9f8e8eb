"""The host half of the poly reference: the piano roll, the note events
and their refinement.

A frozen copy, code unchanged but for the native (C++) fast paths, which
it never takes (their NumPy twins are kept), of the port's polyphonic host
chain: ``ref/poly_ref.py::roll_and_confidence_ref``, ``core/poly.py`` from
``roll_to_events`` down (less ``group_chords``, which the chain does not
call), and ``engine/poly.py::AegisPolyEngine
.extract_events`` as a function of the analysis, at the commit the
benchmark was defined on.  The dB helpers, the onset picking and
splitting, the velocity curve and the MIDI encoder are
``host_v1.py``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from bench_torch.reference.host_v1 import (amplitude_to_db, pick_onsets,
                                           split_events_at_onsets,
                                           velocity_from_db)

CQT_FMIN_MIDI = 24.0  # C1, the CQT's first bin


def midi_to_hz(midi: float) -> float:
    return 440.0 * 2.0 ** ((midi - 69.0) / 12.0)


class _NoNative:
    """Stands for the program's C++ library: never built here."""

    @staticmethod
    def get_lib():
        return None


_NO_NATIVE = _NoNative()


MIDI_BINS = 128


def unpack_cqt_f16(cols: np.ndarray, n_bins: int) -> np.ndarray:
    """Host twin of pack_cqt_f16: (T, ceil(n_bins/2)) f32 -> (T, n_bins)
    f32 magnitudes."""
    cols = np.ascontiguousarray(np.asarray(cols, np.float32))
    mag16 = cols.view(np.float16).reshape(cols.shape[0], -1)
    return mag16[:, :n_bins].astype(np.float32)


def roll_and_confidence_ref(bins: np.ndarray, sals: np.ndarray,
                            bins_per_octave: int = 12,
                            rel_threshold: float = 0.12,
                            abs_threshold: float = 0.02,
                            global_peak: float | None = None,
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy twin of core.poly.roll_and_confidence."""
    bins = np.asarray(bins)
    sals = np.asarray(sals, np.float32)
    T, V = bins.shape
    lead = np.maximum(sals.max(axis=1, keepdims=True), np.float32(1e-10))
    if global_peak is None:
        global_peak = float(sals.max())
    keep = (sals >= np.float32(rel_threshold) * lead) & (
        sals >= np.float32(abs_threshold)
        * np.float32(max(global_peak, 1e-10)))
    midi = np.clip(np.round(CQT_FMIN_MIDI
                            + 12.0 * bins.astype(np.float32)
                            / bins_per_octave).astype(np.int32),
                   0, MIDI_BINS - 1)
    roll = np.zeros((T, MIDI_BINS), bool)
    conf = np.zeros((T, MIDI_BINS), np.float32)
    salience = np.zeros((T, MIDI_BINS), np.float32)
    rows = np.arange(T)
    for v in range(V):
        m = midi[:, v]
        roll[rows, m] |= keep[:, v]
        conf[rows, m] = np.maximum(conf[rows, m], sals[:, v] / lead[:, 0])
        salience[rows, m] = np.maximum(salience[rows, m],
                                       np.maximum(sals[:, v], 0.0))
    return roll, conf, salience


def roll_to_events(roll: np.ndarray, confidence: np.ndarray, rms: np.ndarray,
                   sr: int, hop_length: int,
                   min_note_duration_ms: float = 60.0,
                   sustain_ms: float = 40.0,
                   confidence_threshold: float = 0.5,
                   rms_db: np.ndarray | None = None) -> List[dict]:
    """Segment a (T, 128) activation into overlapping note events.
    ``rms_db`` short-circuits the dB conversion with a caller-precomputed
    plane (the engine passes a track-referenced one for windowed calls)."""
    T = roll.shape[0]
    if rms_db is None:
        rms_db = amplitude_to_db(np.asarray(rms)[:T])
    else:
        rms_db = np.asarray(rms_db)[:T]
    velocity = velocity_from_db(rms_db)
    min_frames = max(int((min_note_duration_ms / 1000.0) * sr / hop_length), 1)
    gap_frames = int((sustain_ms / 1000.0) * sr / hop_length)

    events: List[dict] = []

    # ONE dict-assembly for both branches below: the native-on and
    # native-off runs must stay field-for-field identical (the parity
    # contract tests/test_torch_poly_copies.py pins), so there is exactly one
    # source of truth for the event fields, rounding, and track cutoff
    def _emit(s: int, e: int, note: int, conf: float) -> None:
        events.append({
            "note": note,
            "start": s,
            "end": e,
            "confidence": round(conf, 3),
            "velocity": int(velocity[s]),
            "track": "main" if conf >= confidence_threshold else "safe",
            "technique": None,
            "slope": 0.0,
            "rms_energy": float(rms_db[s]),
        })

    conf_arr = np.asarray(confidence)
    if conf_arr.dtype == np.float32:
        _nat = _NO_NATIVE

        if _nat.get_lib() is not None:
            # C++ run scan (same note-major order, gap merge, min-duration,
            # full-span confidence max); dict assembly + the python
            # round() stay here so the floats match the spec path exactly
            roll_u8 = np.ascontiguousarray(
                np.asarray(roll, bool).view(np.uint8)
                if np.asarray(roll).dtype == bool
                else np.asarray(roll, bool).astype(np.uint8))
            run_s, run_e, run_n, run_c = _nat.poly_roll_runs_native(
                roll_u8, np.ascontiguousarray(conf_arr),
                min_frames, gap_frames)
            for s, e, note, conf in zip(run_s.tolist(), run_e.tolist(),
                                        run_n.tolist(), run_c.tolist()):
                _emit(s, e, note, conf)
            events.sort(key=lambda ev: (ev["start"], ev["note"]))
            return events
    # ONE nonzero pass over the transposed plane gives every (note, t)
    # activation grouped by note with t ascending — run boundaries are a
    # note change or a gap > gap_frames+1 (same merge rule as the old
    # per-note loop over 128 columns, profiled round 4)
    nz_note, nz_t = np.nonzero(np.asarray(roll, bool).T)
    if len(nz_t) == 0:
        return events
    brk = np.nonzero((np.diff(nz_note) != 0)
                     | (np.diff(nz_t) > gap_frames + 1))[0]
    run_s = nz_t[np.concatenate([[0], brk + 1])]
    run_e = nz_t[np.concatenate([brk, [len(nz_t) - 1]])]
    run_n = nz_note[np.concatenate([[0], brk + 1])]
    # contiguous per-run confidence segments (same element order -> the
    # max is the identical float; the strided column gather was the cost)
    conf_T = np.ascontiguousarray(np.asarray(confidence).T)
    for s, e, note in zip(run_s.tolist(), run_e.tolist(), run_n.tolist()):
        if e - s + 1 < min_frames:
            continue
        _emit(s, e, note, float(conf_T[note, s:e + 1].max()))
    events.sort(key=lambda ev: (ev["start"], ev["note"]))
    return events


# --------------------------------------------------------------------------
# Host: polyphonic event refinement (attack physics + harmonic dedup)
#
# The polyphonic sibling of the v1 engine's onset refinement
# (core/events.py::split_events_at_onsets / snap_starts_to_onsets): the
# same onset envelope + RMS planes the fused program already computes,
# applied chord-aware.  Measured on Karplus-Strong chord-progression clips
# with generator ground truth (20 random voicing/rolloff seeds): the
# unrefined roll segmentation scores mean F1 0.34; the refined pipeline
# 0.99 — 17/20 seeds perfect (tests/test_poly_truth.py).
# --------------------------------------------------------------------------

def silence_gate(roll: np.ndarray, rms_db: np.ndarray,
                 silence_db: float = 45.0,
                 peak_db: float | None = None) -> np.ndarray:
    """Zero roll rows whose frame RMS sits more than silence_db below the
    track peak: a voice cannot sound through silence.  (Decay-gap ghosts
    spanned -80 dB frames and still segmented into >min-duration events.)

    ``peak_db`` overrides the reference peak — a windowed caller (the live
    horizon cache) must pass the TRACK-GLOBAL max, not the slice's."""
    if peak_db is None:
        peak_db = float(np.max(rms_db))
    live = np.asarray(rms_db) >= (peak_db - silence_db)
    return roll & live[:, None]


def attach_salience(events: List[dict], salience: np.ndarray) -> List[dict]:
    """Record each event's mean absolute salience (confidence is normalized
    per frame, so concurrent events can't be compared through it)."""
    # transpose once so every per-event segment is contiguous — the mean
    # reduces the SAME element sequence (bit-identical; numpy's pairwise
    # sum follows element order, not memory layout), without the strided
    # per-column gather each call paid before
    sal_T = np.ascontiguousarray(np.asarray(salience).T)
    if events and sal_T.dtype == np.float32:
        _nat = _NO_NATIVE

        if _nat.get_lib() is not None:
            # C++ float32 pairwise mean — bit-identical to seg.mean()
            sals = _nat.poly_attach_salience_native(events, sal_T)
            for e, s in zip(events, sals.tolist()):
                e["salience"] = s
            return events
    for e in events:
        seg = sal_T[e["note"], e["start"]:e["end"] + 1]
        e["salience"] = float(seg.mean()) if seg.size else 0.0
    return events


def snap_starts_poly(events: List[dict], onsets: np.ndarray,
                     rms_db: np.ndarray, back_frames: int) -> List[dict]:
    """Chord-aware start snapping: pull each event's start back to the
    steepest RMS rise after the latest onset within ``back_frames``.

    Unlike the monophonic snap_starts_to_onsets this does NOT truncate the
    previous event (concurrent voices legitimately overlap); the only
    guard is same-pitch: a start never crosses the previous event of the
    SAME note."""
    onsets = np.asarray(onsets, np.int64)
    # pick_onsets/refine hand the onsets sorted; the binary-searched
    # latest-onset lookup is then exact (unsorted callers keep the mask)
    sorted_on = len(onsets) < 2 or bool((np.diff(onsets) >= 0).all())
    if sorted_on and events:
        _nat = _NO_NATIVE

        if _nat.get_lib() is not None:
            order = sorted(events, key=lambda e: (e["note"], e["start"]))
            new_starts = _nat.poly_snap_starts_native(
                order, onsets, np.asarray(rms_db), back_frames)
            out = []
            for e, ns in zip(order, new_starts.tolist()):
                d = dict(e)
                d["start"] = ns
                out.append(d)
            out.sort(key=lambda e: (e["start"], e["note"]))
            return out
    out = [dict(e) for e in sorted(events,
                                   key=lambda e: (e["note"], e["start"]))]
    prev_end: dict = {}
    for e in out:
        lo = max(e["start"] - back_frames, prev_end.get(e["note"], -1) + 1, 0)
        if sorted_on:
            j = int(np.searchsorted(onsets, e["start"], "right")) - 1
            cand = onsets[j:j + 1] if (j >= 0 and onsets[j] >= lo) else ()
        else:
            cand = onsets[(onsets >= lo) & (onsets <= e["start"])]
        if len(cand):
            o = int(cand[-1])
            seg = rms_db[o:e["start"] + 1]
            if len(seg) >= 2:
                ns = o + int(np.argmax(np.diff(seg))) + 1
                if ns < e["start"]:
                    e["start"] = ns
        prev_end[e["note"]] = e["end"]
    out.sort(key=lambda e: (e["start"], e["note"]))
    return out


def decay_prune(events: List[dict], onsets: np.ndarray,
                frac: float = 0.5, total_frames: int | None = None,
                concurrent_tol: int = 4) -> List[dict]:
    """Drop attack-transient splash: an event much shorter than its
    inter-onset gap while a concurrent event clearly sustains the gap is
    broadband attack energy that briefly won a CQT bin, not a note."""
    on = np.asarray(sorted(onsets), np.int64)
    if events:
        _nat = _NO_NATIVE

        if _nat.get_lib() is not None:
            keep = _nat.poly_decay_prune_native(events, on, frac,
                                                total_frames, concurrent_tol)
            return [e for e, k in zip(events, keep) if k]
    # start-sorted view for the concurrency probe: the candidate set is
    # |o.start - e.start| <= tol, a binary-searchable window (the full
    # per-event scan was O(E^2) and measurably dominated live poly polls
    # on long sessions)
    by_start = sorted(events, key=lambda o: o["start"])
    starts = np.asarray([o["start"] for o in by_start], np.int64)
    out = []
    for e in events:
        i = int(np.searchsorted(on, e["start"], "right")) - 1
        if i < 0:
            out.append(e)
            continue
        gap_end = (int(on[i + 1]) if i + 1 < len(on)
                   else (total_frames if total_frames is not None
                         else e["end"] + 1))
        gap = max(gap_end - int(on[i]), 1)
        if (e["end"] - e["start"] + 1) >= frac * gap:
            out.append(e)
            continue
        lo = int(np.searchsorted(starts, e["start"] - concurrent_tol))
        hi = int(np.searchsorted(starts, e["start"] + concurrent_tol,
                                 "right"))
        sustained = any(
            (o is not e) and (o["end"] - o["start"] + 1) >= 0.7 * gap
            for o in by_start[lo:hi])
        if not sustained:
            out.append(e)
    return out


def onset_birth_gate(events: List[dict], onsets: np.ndarray,
                     tol_frames: int) -> List[dict]:
    """A plucked note must be born at a picked onset (within tol)."""
    on = np.asarray(sorted(onsets), np.int64)
    if len(on) == 0:
        return events
    # nearest-onset distance via the two sorted neighbors (identical to
    # the min over all onsets it replaces; one vectorized searchsorted
    # instead of a per-event |on - start| scan)
    starts = np.fromiter((e["start"] for e in events), np.int64, len(events))
    pos = np.searchsorted(on, starts)
    right = on[np.minimum(pos, len(on) - 1)]
    left = on[np.maximum(pos - 1, 0)]
    dmin = np.minimum(np.abs(right - starts), np.abs(left - starts))
    return [e for e, d in zip(events, dmin.tolist()) if d <= tol_frames]


#: frame rate the attack-physics gates were truth-validated at (22.05 kHz
#: hop 512 — identical to the 44.1 kHz hop-1024 sr-proportional default)
_GATE_REF_FPS = 22050.0 / 512.0


def attack_rise_gate(events: List[dict], rms_db: np.ndarray,
                     win_frames: int = 4,
                     min_rise_db: float = 2.0) -> List[dict]:
    """A pluck's start must sit at an RMS attack rise.  The window is
    asymmetric — [start-win, start] — because the CQT lags the physical
    attack (the event's first accepted frame lands a few frames AFTER the
    rise), while a rise shortly after the start is the NEXT note's attack
    (measured: a symmetric window let a decay-gap ghost borrow the next
    chord's rise 4 frames ahead).

    Events starting within the window of frame 0 are exempt: audio that
    begins directly on a sounding note (a trimmed upload) has no
    silence→attack rise to find, and the silence gate already guarantees
    those frames carry real energy."""
    d = np.diff(np.asarray(rms_db, np.float64))
    out = []
    for e in events:
        if e["start"] <= win_frames:
            out.append(e)
            continue
        lo = max(e["start"] - win_frames, 0)
        hi = min(e["start"] + 1, len(d))
        if hi > lo and float(d[lo:hi].max()) >= min_rise_db:
            out.append(e)
    return out


#: semitone intervals of harmonics 2..8 above a fundamental
HARMONIC_INTERVALS = frozenset((12, 19, 24, 28, 31, 34, 36))

#: midi -> Hz lookup built through the SCALAR config.midi_to_hz, so
#: vectorized line scans read bit-identical frequencies to the per-call
#: code they replaced (numpy's pow can differ from libm by an ulp)
_HZ_TABLE = np.array([midi_to_hz(float(m)) for m in range(192)])

#: harmonics 3..8 only — the +12 octave is handled separately (it is the
#: one harmonic interval real chord voicings routinely occupy)
HIGH_HARMONIC_INTERVALS = frozenset((19, 24, 28, 31, 34, 36))


def _foreign_line_near(pitch: float, events, exclude_notes,
                       tol_semis: float = 1.5, hmax: int = 13,
                       parent_note: int | None = None,
                       rim_tol_semis: float = 1.2,
                       med_env=None, evidence_db: float | None = None,
                       contrib_margin_db: float = 10.0) -> bool:
    """Does any event OUTSIDE ``exclude_notes`` place a partial line
    (h2..hmax) within ``tol_semis`` of MIDI ``pitch``?  Beat-evidence
    guards must reason in FREQUENCY lines, not the semitone grid: h5
    sits at +27.86, h7 at +33.69 and h10 at +39.86 semitones, so an
    exact-interval check misses real feeders a rim away (measured round
    3: a 52-string's h5 line 0.85 semitones from bin 79 faked octave
    beat evidence that exact intervals could not see).

    ``parent_note`` marks the expected-component string: a "foreign"
    event sitting within ``rim_tol_semis`` of one of ITS partial lines
    is most likely that line's rim phantom, not an independent string —
    treating it as a feeder would let a phantom veto the very beat
    evidence that could expose it (measured round 3: a rim pick at 63,
    0.97 semitones under the bass's h4 line, blocked the doubled
    octave's h4 beat at bin 76).

    With ``med_env`` (bin-level callback) and ``evidence_db`` set, a
    geometrically-near line only blocks when it is LOUD enough to
    matter: its estimated contribution to the evidence bin — the line's
    own-bin level minus the pseudo-CQT triangle attenuation at its
    semitone offset — must reach within ``contrib_margin_db`` of the
    evidence bin's level.  A −30 dB rolled-off h5 a semitone away
    cannot fake a beat on a −15 dB bin (measured round 3: the
    47-string's quiet h5 line wrongly vetoed the doubled 52's h4 beat,
    while the loud h5/h6 lines that DO fake beats sat within 10 dB)."""
    f_b = midi_to_hz(pitch)
    f_p = midi_to_hz(parent_note) if parent_note is not None else None
    h_arr = np.arange(2.0, hmax + 1.0)
    for o in events:
        if o["note"] in exclude_notes:
            continue
        f_o = midi_to_hz(o["note"])
        # one (h,) distance vector instead of the per-h Python loop
        # (profiled round 4: ~19k genexpr steps per extract) — same
        # elementwise float64 math, same candidate order
        if f_p is not None and (np.abs(12.0 * np.log2(
                f_o / (h_arr * f_p))) <= rim_tol_semis).any():
            continue
        d_all = np.abs(12.0 * np.log2(f_b / (h_arr * f_o)))
        for k in np.nonzero(d_all <= tol_semis)[0]:
            d = float(d_all[k])
            if med_env is None or evidence_db is None:
                return True
            line_bin = int(round(pitch - d)) if (k + 2) * f_o < f_b \
                else int(round(pitch + d))
            line_db = med_env(line_bin)
            if line_db is None:
                return True
            atten = 20.0 * np.log10(max(1.0 - d / 2.0, 0.05))
            if line_db + atten >= evidence_db - contrib_margin_db:
                return True
    return False



def _dbp(cqt_mag: np.ndarray,
         db: np.ndarray | None = None) -> np.ndarray:
    """The (T, bins) dB plane 20*log10(max(mag, 1e-12)), computed ONCE at
    each recovery pass's entry.  The passes read dozens of envelope
    slices per event; converting each slice individually dominated the
    host-side extract cost (profiled round 3: ~50 ms/call on a 10 s
    chord clip, much of it repeated log10 overhead).  Slicing a
    precomputed plane is bit-identical.

    ``db`` short-circuits the conversion with a caller-precomputed
    plane: refine_poly_events threads ONE plane through all ~9 passes
    (the repeat log10 over a (26k, 84) plane was ~13% of a 10-minute
    live poll).  Explicit threading, not an identity memo — callers
    may legally mutate ``cqt_mag`` in place between direct pass calls
    (the constructed-physics tests do), so caching by object identity
    would serve a stale plane."""
    if db is not None:
        return db
    return 20.0 * np.log10(np.maximum(cqt_mag, 1e-12))


def _linefit(t: np.ndarray, y: np.ndarray) -> tuple:
    """Least-squares line y ~ a·t + b via the centered normal equations —
    the closed form of the (T, 2) lstsq/polyfit the recovery passes call
    hundreds of times per clip (profiled round 3: the LAPACK per-call
    overhead, not the math, dominated).  Agrees with lstsq to ~1e-12
    relative; every consumer thresholds at 0.05+ dB scales."""
    n = len(t)
    # sum()/n is np.mean's own reduction + divide without the _methods
    # wrapper overhead (bit-identical; profiled round 4: ~1.8k fits/run)
    tm, ym = t.sum() / n, y.sum() / n
    dt = t - tm
    denom = float(np.dot(dt, dt))
    a = float(np.dot(dt, y - ym)) / denom if denom > 0 else 0.0
    return a, ym - a * tm


#: read-only arange cache for the envelope fits (windows are short and a
#: few hundred distinct lengths occur per track; the arange alloc+fill was
#: measurable at ~220 shape fits per 60 s extract)
_T_CACHE: dict = {}


def _t_axis(T: int) -> np.ndarray:
    t = _T_CACHE.get(T)
    if t is None:
        t = np.arange(T, dtype=np.float64)
        if len(_T_CACHE) < 4096:
            _T_CACHE[T] = t
    return t


def _env_shape(env_db: np.ndarray, fps: float,
               trim_frac: float = 0.15) -> tuple:
    """(linear-fit RMS residual [dB], |late slope - early slope| [dB/s])
    of a bin's dB envelope — the pure-partial vs independent-voice
    discriminator shared by the raw-CQT recovery/drop passes.  A single
    decaying exponential fits a straight dB line (residual ~0.05 dB over
    measured pure-h2 bins); two detuned components beat (residual ~1.4 dB
    median, curvature tens of dB/s).

    The fit is OUTLIER-TRIMMED (fit, drop the ``trim_frac`` worst-residual
    frames, refit on the keepers): a release cliff or a neighbouring
    chord's attack caught by an overhanging event span poisons a handful
    of frames by 20–200 dB and swamped every threshold (measured round 3:
    a straight 44.1 kHz bass read residual 51 dB because its span ran two
    frames into the inter-chord gap).  A beat is periodic and spans the
    window, so trimming barely moves it; span-overhang poison is
    concentrated and gets dropped."""
    T = len(env_db)
    t = _t_axis(T)
    a, b = _linefit(t, env_db)
    n_trim = int(T * trim_frac)
    if n_trim > 0 and T - n_trim >= 4:
        err = np.abs(env_db - (a * t + b))
        keep = np.sort(np.argsort(err)[: T - n_trim])
        # t[keep] is exactly keep as float64 (t is the index axis), and the
        # y gather happens once — identical values, fewer allocations
        tk = keep.astype(np.float64)
        yk = env_db[keep]
        a, b = _linefit(tk, yk)
    else:
        tk = t
        yk = env_db[np.arange(T)]  # gather copy, matching the old keep path
    resid = float(np.sqrt(np.mean((yk - (a * tk + b)) ** 2)))
    h = len(tk) // 2
    s_early = _linefit(tk[:h], yk[:h])[0] * fps
    s_late = _linefit(tk[h:], yk[h:])[0] * fps
    return resid, abs(s_late - s_early)


class _EnvCache:
    """Memoized envelope statistics over ONE dB plane (round-4 profile:
    the per-(event, bin) scalar ``_med``/``_env_shape`` calls were ~40% of
    the amortized 60 s poly extract — ~3.2k medians + ~230 shape fits per
    run, with the same (lo, hi) windows re-read within a pass and across
    the chain's passes, because chord voices share spans and every pass
    uses the same 0.12 s attack skip).

    ``med(lo, hi, b)`` returns the exact ``_med(db[lo:hi, b])``: the whole
    window's per-bin medians are computed in ONE axis-0 partition and
    memoized by window — bit-identical to the scalar call (partition is
    exact k-selection; the even-length mean averages the same two floats).
    ``shape(lo, hi, b)`` memoizes the scalar ``_env_shape`` verbatim.

    Threaded through the recovery chain alongside ``db``
    (refine_poly_events builds one per call).  Direct pass callers that
    mutate the magnitude plane between calls simply don't pass one — each
    pass then builds its own over its ``db``, so no staleness (the same
    contract as the explicit ``db`` threading; see _dbp)."""

    __slots__ = ("db", "fps", "_meds", "_shapes", "_nh")

    def __init__(self, db: np.ndarray, fps: float):
        self.db = db
        self.fps = float(fps)
        self._meds: dict = {}
        self._shapes: dict = {}
        # native (C++) backend: one shared memoized stats core per plane
        # (aegis_tpu_torch/native/poly_recover.cpp) — medians bit-identical, shape
        # fits near-parity (double accumulation vs numpy pairwise/BLAS; see
        # the C++ header).  The heavy recovery passes run natively against
        # the SAME handle, so stats stay shared across the whole chain.
        self._nh = None
        if (getattr(db, "ndim", 0) == 2
                and db.dtype in (np.float32, np.float64)):
            _nat = _NO_NATIVE

            if _nat.get_lib() is not None:
                try:
                    self._nh = _nat.EnvHandle(
                        np.ascontiguousarray(db), self.fps)
                except Exception:
                    self._nh = None

    def med_row(self, lo: int, hi: int) -> np.ndarray:
        key = (lo, hi)
        row = self._meds.get(key)
        if row is None:
            if self._nh is not None:
                row = self._nh.med_row(lo, hi)
            else:
                win = self.db[lo:hi]
                n = win.shape[0]
                if n == 0:
                    row = np.full(win.shape[1], np.nan)
                else:
                    h = n // 2
                    if n % 2:
                        row = np.partition(win, h, axis=0)[h]
                    else:
                        p = np.partition(win, (h - 1, h), axis=0)
                        row = (p[h - 1] + p[h]) / 2.0
            self._meds[key] = row
        return row

    def med(self, lo: int, hi: int, b: int) -> float:
        return float(self.med_row(lo, hi)[b])

    def shape(self, lo: int, hi: int, b: int) -> tuple:
        key = (lo, hi, b)
        v = self._shapes.get(key)
        if v is None:
            if self._nh is not None:
                v = self._nh.shape(lo, hi, b)
            else:
                v = _env_shape(self.db[lo:hi, b], self.fps)
            self._shapes[key] = v
        return v


def _native_pass_ok(events: List[dict], fmin: int, n_bins: int,
                    cache: "_EnvCache") -> bool:
    """Preconditions for routing a recovery pass through the C++ core: the
    plane width matches and every note's bin arithmetic stays in the range
    the Python spec itself tolerates (out-of-range notes would IndexError
    in Python too; tests may construct them — fall back)."""
    nh = getattr(cache, "_nh", None)
    if nh is None or not events or nh.B != n_bins:
        return False
    notes = np.fromiter((e["note"] for e in events), np.int64, len(events))
    return int(notes.min()) >= fmin and int(notes.max()) < fmin + n_bins


def _overlap_rows(events: List[dict], chunk: int = 512) -> List[np.ndarray]:
    """Per-event index arrays of CONCURRENT events — the recovery chain's
    shared scan ``[o for o in events if o is not e and o["start"] <=
    e["end"] and e["start"] <= o["end"]]`` evaluated as one vectorized
    pair comparison instead of a Python generator per event.  The
    O(E^2) generator steps dominated long live-session polls (profiled
    round 3: 2.9M steps / 2.7 s per poll at 10 minutes); row-chunking
    bounds the pair matrix at ~0.5 MB.  Index order equals list order,
    so ``[events[j] for j in rows[i]]`` reproduces the scan exactly."""
    n = len(events)
    starts = np.fromiter((e["start"] for e in events), np.int64, n)
    ends = np.fromiter((e["end"] for e in events), np.int64, n)
    rows: List[np.ndarray] = []
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        ov = (starts[None, :] <= ends[i0:i1, None]) \
            & (starts[i0:i1, None] <= ends[None, :])
        for k in range(i0, i1):
            ov[k - i0, k] = False
        rows.extend(np.nonzero(ov[r])[0] for r in range(i1 - i0))
    return rows


def harmonic_dedup(events: List[dict], sal_ratio: float = 0.55,
                   start_tol: int = 4) -> List[dict]:
    """Drop an event whose pitch is a harmonic interval above a concurrent
    event with much higher ABSOLUTE salience — a partial that survived the
    peel.  Ratio-gated so true octave/fifth chord voices (which carry
    their own comb and hence comparable salience) are kept.  Requires
    attach_salience.  Events tagged ``rescued_root`` are exempt: their
    direct-energy evidence is envelope-measured (rescue_dead_fundamentals)
    and their weak-fundamental salience is exactly what this ratio would
    re-kill."""
    n_ev = len(events)
    if not n_ev:
        return []
    _nat = _NO_NATIVE

    if _nat.get_lib() is not None:
        keep = _nat.poly_harmonic_dedup_native(events, sal_ratio, start_tol)
        return [e for e, k in zip(events, keep) if k]
    # one vectorized pair sweep instead of the O(E^2) generator scan
    # (same predicates, diagonal = the ``o is not e`` exclusion)
    notes = np.fromiter((e["note"] for e in events), np.int64, n_ev)
    starts = np.fromiter((e["start"] for e in events), np.int64, n_ev)
    ends = np.fromiter((e["end"] for e in events), np.int64, n_ev)
    sals = np.fromiter((e.get("salience", 0.0) for e in events),
                       np.float64, n_ev)
    harm = np.fromiter(HARMONIC_INTERVALS, np.int64,
                       len(HARMONIC_INTERVALS))
    dom = np.zeros(n_ev, bool)
    for i0 in range(0, n_ev, 512):
        i1 = min(i0 + 512, n_ev)
        m = np.isin(notes[i0:i1, None] - notes[None, :], harm) \
            & (starts[None, :] - start_tol <= starts[i0:i1, None]) \
            & (starts[i0:i1, None] <= ends[None, :]) \
            & (sals[i0:i1, None] < sal_ratio * sals[None, :])
        for k in range(i0, i1):
            m[k - i0, k] = False
        dom[i0:i1] = m.any(axis=1)
    return [e for e, d in zip(events, dom)
            if e.get("rescued_root") or not d]


def _default_n_fft(sr: int) -> int:
    """The engine's sr-proportional analysis window (engine/poly.py): the
    FFT bin width sr/n_fft is 10.77 Hz at every supported rate, which is
    what the leakage-physics passes below depend on."""
    return 2048 * max(1, round(sr / 22050))


def rescue_dead_fundamentals(events: List[dict], cqt_mag: np.ndarray,
                             sr: int, hop_length: int,
                             n_fft: int | None = None,
                             live_floor_db: float = 33.0,
                             max_resid: float = 0.5,
                             max_curv: float = 1.0,
                             max_slope: float = 0.5,
                             leak_bins: float = 3.5,
                             attack_skip_s: float = 0.12,
                             min_frames: int = 10,
                             db: np.ndarray | None = None,
                             cache: "_EnvCache | None" = None,
                             track_peak_db: float | None = None) -> List[dict]:
    """Mint voices whose FUNDAMENTAL the peel never picked because random
    string rolloff killed the bin's geometric-mean salience — the root
    cause behind the octave-family residuals (measured round 3): a chord
    voice with a −28..−31 dB fundamental is invisible to the peel (the
    ``mag**alpha`` factor zeroes its salience), so the peel picks the
    string's HARMONICS instead, and every later host pass — anchored to
    detected events only — then compounds the miss (orphan harmonic FPs
    survive the straightness drop for lack of a parent; false octave
    recoveries mint off the undetected string's partials).

    DECISION.  Runs BEFORE harmonic_dedup so the peel's harmonic picks
    still exist as evidence.  Each event e VOTES for candidate roots
    f = e.note − h, h ∈ harmonics 2..8: a voter at a harmonic interval is
    exactly the "attributed to the wrong bin" signature (measured: in
    [52,64] with a dead 52, the peel minted 71 = h3 and 80 = h5 of the
    52-string).  A candidate is rescued iff its own raw-CQT bin carries
    direct evidence of a string:
      * live — median dB over the voter's sustain within ``live_floor_db``
        of the track peak (measured dead-fundamental range −28..−31 dB);
      * a clean decaying pluck — linear-fit residual ≤ ``max_resid`` dB,
        slope ≤ ``max_slope`` dB/s (measured 0.00–0.05 dB on all true
        rescues);
      * not window leakage — no concurrent event within ``leak_bins``
        FFT bins (|Δf| ≤ leak_bins·sr/n_fft) whose own bin is louder (at
        MIDI ≤ ~55 a semitone is under one FFT bin and a string's main
        lobe lights its neighbors; see drop_leakage_ghosts);
      * not a detected string's partial — f a harmonic interval above any
        concurrent event is rejected, EXCEPT f = parent+12 when bin f+12
        BEATS (resid ≥ max(0.25, 4× f's own)): a lone bass's h2 lights
        bin f but then its h4 at f+12 is a SINGLE component (measured
        resid 0.00 on a mono pluck), while a true octave string adds its
        detuned h2 there (measured resid 3.63 on the same voicing) — the
        same physics as recover_octave_doublings, read one octave up.

    The minted event inherits the +12 voter's span when present (its h2
    tracks the string exactly), else the strongest voter's, carries the
    max voter salience (the voters' salience IS this string's energy,
    misattributed), and is tagged ``rescued_root`` — exempt from
    harmonic_dedup and repitch_suboctave_ghosts, whose level heuristics
    would re-kill exactly the weak-fundamental voice this pass proved by
    envelope physics.  Measured (VALIDATION.md round 3): the pass closes
    the undetected-bass cascades on oct22A s5/s6 and oct22B s11 with the
    standard family untouched."""
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    n_fft = n_fft or _default_n_fft(sr)
    binw = sr / n_fft
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]
    track_max_db = (float(np.max(db)) if track_peak_db is None
                    else track_peak_db)

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        mints = _nat.poly_rescue_native(
            cache._nh, events, binw, fmin, n_bins, track_max_db,
            live_floor_db, max_resid, max_curv, max_slope, leak_bins,
            attack_skip_s, min_frames)
        out = list(events)
        for src, f, s in mints:
            out.append({**events[src], "note": f, "salience": s,
                        "rescued_root": True})
        out.sort(key=lambda ev: (ev["start"], ev["note"]))
        return out

    def med_env(b, lo, hi):
        return cache.med(lo, hi, b)

    out = list(events)
    # note -> spans already minted at that pitch.  Dedup is per chord
    # occurrence, NOT track-global: a repeated chord later in the
    # progression needs its own rescue (same dead string, new pluck), so
    # skip only when a prior mint at f overlaps the current voter's span.
    minted: dict = {}
    rows = _overlap_rows(events)
    offs = np.array([0, *sorted(HARMONIC_INTERVALS)], np.int64)
    for i, e in enumerate(events):
        concurrent = [events[j] for j in rows[i]]
        group = concurrent + [e]
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if hi - lo < min_frames:
            continue
        # the group's spectral-line notes (fundamentals + harmonics) are
        # constant across the h-loop: precompute them once per voter
        gn = np.fromiter((o["note"] for o in group), np.int64, len(group))
        lines = (gn[:, None] + offs[None, :]).ravel()
        lines = lines[lines < len(_HZ_TABLE)]
        lines_hz = _HZ_TABLE[lines]
        for h in sorted(HARMONIC_INTERVALS):
            f = e["note"] - h
            bf = f - fmin
            if bf < 0 or any(s <= e["end"] and e["start"] <= t
                             for s, t in minted.get(f, ())):
                continue
            if (gn == f).any():
                continue
            own = med_env(bf, lo, hi)
            if own < track_max_db - live_floor_db:
                continue
            env = db[lo:hi, bf]
            r, c = cache.shape(lo, hi, bf)
            t = _t_axis(len(env))
            slope = _linefit(t, env)[0] * fps
            if r > max_resid or c > max_curv or slope > max_slope:
                continue
            # leakage guard: bin f lit by the main lobe of ANY nearby
            # spectral line of the group — an event's fundamental or one
            # of its harmonics (measured: in [53,57] the 53-string's h2
            # at bin 65 lights bin 64 and minted a false 64 before
            # harmonic bins were checked).  A line within a third of a
            # bin is the SAME bin, not leakage — that collision is what
            # the +12-beat exception below adjudicates.  Inside ~one bin
            # the main lobe is full-strength: leakage can even exceed a
            # weak source bin's own reading (measured +0.4 dB on a
            # phantom 44 beside a 45-string) — hence the -2 dB margin.
            d = np.abs(_HZ_TABLE[f] - lines_hz) / binw
            lb = lines - fmin
            m = (0.3 < d) & (d <= leak_bins) & (lb >= 0) & (lb < n_bins)
            if m.any():
                need = np.where(d[m] <= 0.9, -2.0, 1.0)
                meds = cache.med_row(lo, hi)[lb[m]]
                if (own <= meds - need).any():
                    continue
            parents = [o for o in group
                       if (f - o["note"]) in HARMONIC_INTERVALS]
            if parents:
                # only the +12-with-beating-harmonic exception survives:
                # f's own bin collides with the parent's h2, but if a
                # string at f exists, its harmonics beat against the
                # parent's even partials at the SAME bins.  Scan f's
                # h2/h3/h4 bins (+12/+19/+24): the two components' Hz
                # offset scales with harmonic number, so a detuning too
                # slow to beat inside the chord at h2 shows at h3/h4
                # (measured at 44.1 kHz, where string quantization is
                # twice as fine as 22.05 kHz and h2 beats take >2 s).
                if not all(f - o["note"] == 12 for o in parents):
                    continue
                beat = False
                for up in (12, 19, 24):
                    b2 = f + up - fmin
                    if b2 >= n_bins:
                        continue
                    # the beat evidence must come from a LIVE bin — at
                    # the noise floor every residual is large (measured:
                    # a false 69 minted off its h2's −35 dB noise wobble)
                    if med_env(b2, lo, hi) < track_max_db - live_floor_db:
                        continue
                    # ... and not from a bin any FOREIGN string's partial
                    # line feeds: its beat then proves nothing (measured:
                    # in [53,57] bin 81 = 53's h5 ≡ 57's h4 beats with no
                    # 69-string anywhere; in [48,52,55] the 48-string's
                    # h10 LINE a rim off bin 88 faked evidence an exact
                    # interval check missed).  The candidate and its +12
                    # parent are the expected components.
                    if _foreign_line_near(
                            float(f + up), group,
                            {f} | {o["note"] for o in parents},
                            parent_note=f - 12,
                            med_env=lambda note: (
                                med_env(note - fmin, lo, hi)
                                if 0 <= note - fmin < n_bins else None),
                            evidence_db=med_env(b2, lo, hi)):
                        continue
                    r2, _ = cache.shape(lo, hi, b2)
                    if r2 >= max(0.25, 4.0 * r):
                        beat = True
                        break
                if not beat:
                    continue
            voters = [o for o in group if (o["note"] - f) in
                      HARMONIC_INTERVALS]
            v12 = [o for o in voters if o["note"] - f == 12]
            src = v12[0] if v12 else max(
                voters, key=lambda o: o.get("salience", 0.0))
            minted.setdefault(f, []).append((src["start"], src["end"]))
            out.append({**src, "note": f,
                        "salience": max(o.get("salience", 0.0)
                                        for o in voters),
                        "rescued_root": True})
    out.sort(key=lambda ev: (ev["start"], ev["note"]))
    return out


def drop_leakage_ghosts(events: List[dict], cqt_mag: np.ndarray,
                        sr: int, hop_length: int,
                        n_fft: int | None = None,
                        leak_bins: float = 2.0,
                        margin_db: float = 4.0,
                        attack_skip_s: float = 0.12,
                        min_frames: int = 6,
                        db: np.ndarray | None = None,
                        cache: "_EnvCache | None" = None,
                             track_peak_db: float | None = None) -> List[dict]:
    """Drop low-register WINDOW-LEAKAGE phantoms: at MIDI ≲ 55 a semitone
    is narrower than one FFT bin (10.77 Hz at the engine's sr-proportional
    window), so a string's Hann main lobe lights CQT bins 1–3 semitones
    away and the peel mints an event there (measured round 3: a phantom 42
    next to a 45-string in 6 of 12 power-chord seeds, phantoms 44/38/35
    next to a 40-string; levels −5..−19 dB under the source, envelopes
    mirroring it).

    DECISION per untagged event e: drop iff a concurrent event o exists
    with |f_e − f_o| ≤ ``leak_bins``·(sr/n_fft) AND e's own-bin median dB
    (attack-skipped) ≤ o's − margin(Δ), where margin(Δ) =
    max(1, ``margin_db``·(Δbins − 0.5)/1.5) ramps with FFT-bin distance:
    main-lobe leakage is nearly full-strength inside half a bin (measured
    −1.7 dB at Δ0.43 on a phantom 38 beside a 40-string) and ~−9 dB by
    Δ1.6 (the phantom-42 family).  Physics-tagged events
    (recovered/repitched/rescued — each minted by an explicit envelope
    measurement) are exempt.  The margin is deliberately small (measured
    phantoms sit ≥5 dB under; a REAL string within two FFT bins and under
    the margin is genuinely unresolvable by this window — the documented
    ceiling for sub-semitone-spacing voicings at the low end of the
    fretboard)."""
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    n_fft = n_fft or _default_n_fft(sr)
    binw = sr / n_fft
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        keep = _nat.poly_drop_leakage_native(
            cache._nh, events, binw, fmin, n_bins, leak_bins, margin_db,
            attack_skip_s, min_frames)
        return [e for e, k in zip(events, keep) if k]

    def med_env(b, lo, hi):
        return cache.med(lo, hi, b)

    out = []
    rows = _overlap_rows(events)
    notes_a = np.fromiter((e["note"] for e in events), np.int64, len(events))
    for i, e in enumerate(events):
        if (e.get("recovered_octave") or e.get("recovered_fifth")
                or e.get("repitched_octave") or e.get("rescued_root")):
            out.append(e)
            continue
        be = e["note"] - fmin
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if not (0 <= be < n_bins) or hi - lo < min_frames:
            out.append(e)
            continue
        own = med_env(be, lo, hi)
        f_e = _HZ_TABLE[e["note"]]
        # one vector sweep over the concurrent candidates (same elementwise
        # float ops as the per-event generator it replaces)
        cn = notes_a[rows[i]]
        cb = cn - fmin
        m = (cn != e["note"]) & (cb >= 0) & (cb < n_bins)
        if m.any():
            cn, cb = cn[m], cb[m]
            d = np.abs(f_e - _HZ_TABLE[cn]) / binw
            near = d <= leak_bins
            if near.any():
                need = np.maximum(1.0, margin_db * (d[near] - 0.5) / 1.5)
                meds = cache.med_row(lo, hi)[cb[near]]
                if (own <= meds - need).any():
                    continue
        out.append(e)
    return out


def drop_composite_harmonic_ghosts(events: List[dict],
                                   sal_guard: float = 1.0,
                                   line_harmonics: tuple = tuple(
                                       range(2, 11)),
                                   line_tol_semis: float = 1.2
                                   ) -> List[dict]:
    """Drop events sitting on a COMPOSITE harmonic bin — a pitch within
    ``line_tol_semis`` of partials of TWO OR MORE distinct concurrent
    lower voices (e.g. 69 = bass 45's h4 ≡ octave-voice 57's h2 in
    [45,52,57]; or a 44.1 kHz rim ghost at 90 between 57's h6.3 and 60's
    h5.6 lines).  Such bins carry two detuned partial components, so they
    BEAT and the straightness ghost drop cannot touch them (measured
    round 3: resid 2.3 dB — indistinguishable by envelope from a true
    voice).  But a bin whose beat is fully explained by two detected
    parents' partials needs no third string: drop unless the event's
    salience ≥ ``sal_guard`` × the strongest parent's (a true
    triple-octave-stack voice carries its own comb).  Parent matching is
    frequency-line proximity, not the semitone grid — h5 sits at +27.86
    and h7 at +33.69, each lighting two neighboring bins.  The recovery
    passes' own collision guards mean a physics-minted event never has
    two detected parent lines, so this judges peel picks only in
    practice."""
    if events:
        _nat = _NO_NATIVE

        if _nat.get_lib() is not None:
            keep = _nat.poly_drop_composite_native(
                events, line_harmonics, sal_guard, line_tol_semis)
            return [e for e, k in zip(events, keep) if k]
    out = []
    rows = _overlap_rows(events)
    h_a = np.asarray(line_harmonics, np.float64)
    notes_a = np.fromiter((e["note"] for e in events),
                          np.int64, len(events))
    sals_a = np.fromiter((e.get("salience", 0.0) for e in events),
                         np.float64, len(events))
    for i, e in enumerate(events):
        f_e = midi_to_hz(e["note"])
        idx = rows[i]
        cn, cs = notes_a[idx], sals_a[idx]
        near = np.abs(12.0 * np.log2(
            f_e / (h_a[None, :] * _HZ_TABLE[cn][:, None]))
        ) <= line_tol_semis
        pm = (cn < e["note"]) & near.any(axis=1)
        if len(set(cn[pm].tolist())) >= 2:
            psal = float(cs[np.isin(cn, cn[pm])].max())
            if e.get("salience", 0.0) < sal_guard * psal:
                continue
        out.append(e)
    return out


def recover_octave_doublings(events: List[dict], cqt_mag: np.ndarray,
                             sr: int, hop_length: int,
                             resid_thr: float = 0.25,
                             curv_thr: float = 1.0,
                             rel_factor: float = 4.0,
                             attack_skip_s: float = 0.12,
                             min_frames: int = 10,
                             level_floor_db: float = 55.0,
                             parent_ghost_ratio: float = 0.15,
                             feeder_floor_db: float = 35.0,
                             db: np.ndarray | None = None,
                             cache: "_EnvCache | None" = None,
                             track_peak_db: float | None = None) -> List[dict]:
    """Recover octave-doubled voices the peel's comb masking erased.

    The peel's KNOWN-WEAK family (VALIDATION.md): a chord voicing with an
    exact octave (power chords [40,47,52], octave pairs [48,60]) loses the
    doubled voice — the mask weight at +12 semitones is 1.33*0.75 >= 1, and
    the -12 sub-harmonic redirect merges the pair before masking even runs.
    Three alternative comb shapes were measured in round 2 and all traded
    the standard chord family down; the conclusion was "disambiguating
    needs temporal envelope cues, not another comb shape".  This pass is
    that cue, applied on host to the raw (pre-peel) CQT magnitude plane:

    PHYSICS.  A plucked string's partial at frequency v loses energy to
    the string's loop filter once per PERIOD, so its dB/s decay rate is
    proportional to the string's own fundamental.  At bin n+12, the lower
    string's 2nd harmonic therefore decays at ~the lower string's rate,
    while an independent octave string's fundamental decays ~2x faster —
    and the two components are never exactly in tune (any quantized or
    physical string differs by a fraction of a Hz), so their sum BEATS.
    A pure h2 bin is a single decaying exponential: its dB envelope is a
    straight line (measured linear-fit RMS residual <= 0.05 dB and
    curvature <= 0.06 dB/s over 108 pure-h2 chord bins).  A doubled bin's
    envelope carries beat nulls and two-rate curvature (residual median
    1.4 dB, curvature tens of dB/s over 36 doubled bins) — four orders of
    magnitude of separation on the probe families.

    DECISION per detected event (note n, no concurrent event at n+12):
    the n+12 bin's dB envelope over the event's sustain (attack skipped)
    must deviate from a single exponential — linear-fit RMS residual >=
    ``resid_thr`` dB or |late slope - early slope| >= ``curv_thr`` dB/s,
    both also >= ``rel_factor`` x the parent bin's own value (a parent
    wobbling from vibrato/bend excuses the octave bin).  Guards, each
    measured on the probe families:
      * bass only — a non-bass parent's +12 bin can be fed by an
        UNDETECTED lower note's higher harmonic (two strings beat
        regardless of doubling; recovering 52+12=64 in [40,47,52] when 40
        went undetected minted a false 64);
      * ghost guards — a parent below ``parent_ghost_ratio`` x the
        chord's max salience, or a lower blocker below half the parent's,
        is likely itself a ghost: recovering from ghosts compounded
        errors, and ghost "basses" blocked true recoveries.  The parent
        ratio was originally 0.5; the 2026-08-19 re-sweep (0.25/0.3/0.4/
        0.5 over all six truth families) measured 0.3 strictly better —
        a peel-eroded REAL bass like 45 in [45,52,57] carries ~1/3 of
        the top voice's salience, and 0.5 blocked its true +12 recovery
        (oct22A 0.805 -> 0.868, oct44A +0.045, nothing down anywhere);
      * harmonic collision — skip when n+12 is a harmonic interval above
        any other concurrent event (its bin legitimately beats);
      * level floor — the bin must sit within ``level_floor_db`` of the
        track's CQT peak (noise-floor wiggle is not a beat).

    Measured (tests/test_poly_truth.py, VALIDATION.md): octave family
    mean truth F1 0.67 -> 0.88 at 22.05 kHz, 0.66 -> 0.85 at 44.1 kHz,
    NO seed worse, standard families unchanged.  With the full recovery
    chain (repitch_suboctave_ghosts + parent_ghost_ratio=0.3 +
    recover_missing_fifths, swept 2026-08-19): 0.92 at 22.05 kHz /
    0.90 at 44.1 kHz design seeds, 0.91/0.89 fresh seeds.
    """
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]
    out = list(events)
    track_max_db = (float(np.max(db)) if track_peak_db is None
                    else track_peak_db)

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        mints, unc = _nat.poly_recover_octaves_native(
            cache._nh, events, fmin, n_bins, track_max_db, sr,
            resid_thr, curv_thr, rel_factor, attack_skip_s, min_frames,
            level_floor_db, parent_ghost_ratio, feeder_floor_db)
        for i in np.nonzero(unc)[0]:
            events[int(i)]["octave_uncertain"] = True
        for p, s in mints:
            out.append({**events[p], "note": events[p]["note"] + 12,
                        "salience": s, "recovered_octave": True})
        out.sort(key=lambda ev: (ev["start"], ev["note"]))
        return out

    rows = _overlap_rows(events)
    # guard scans as array ops over the shared rows (same predicates; the
    # dict-list is only materialized for events that reach the physics)
    notes_a = np.fromiter((e["note"] for e in events), np.int64, len(events))
    sals_a = np.fromiter((e.get("salience", 0.0) for e in events),
                         np.float64, len(events))
    starts_a = np.fromiter((e["start"] for e in events), np.int64,
                           len(events))
    harm_a = np.fromiter(HARMONIC_INTERVALS, np.int64,
                         len(HARMONIC_INTERVALS))
    for i, e in enumerate(events):
        n = e["note"]
        b0, b12 = n - fmin, n + 12 - fmin
        if not (0 <= b0 < n_bins and b12 < n_bins):
            continue
        idx = rows[i]
        cn, cs = notes_a[idx], sals_a[idx]
        if (cn == n + 12).any():
            continue
        sal = e.get("salience", 0.0)
        # a rescued root IS a proven weak-fundamental voice — judging it
        # by salience ratio would re-apply exactly the bias that hid it
        if sal < parent_ghost_ratio * max(float(cs.max()) if len(cs) else sal,
                                          sal) \
                and not e.get("rescued_root"):
            continue
        # lower-blocker guard, SIMULTANEOUS onsets only (round 4): the
        # ghost basses this guard was measured against share the pluck's
        # attack (a sub-octave phantom is minted from the same onset),
        # while a PREVIOUS chord's decaying bass overhangs into this one
        # with an offset start — blocking on it silently lost the true
        # 45+12 doubling on 5 of the 24 oct44A seeds (its tail feeding
        # is the feeder guard's job, which reads actual bin energies)
        if ((cn < n) & (cs >= 0.5 * sal)
                & (np.abs(starts_a[idx] - e["start"]) <= 4)).any():
            continue
        if np.isin((n + 12) - cn[cn != n], harm_a).any():
            continue
        concurrent = [events[j] for j in idx]
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if hi - lo < min_frames:
            continue
        # clip the window to the parent string's LIVE tail: an event span
        # that runs past the string's death into silence poisons every
        # envelope statistic (a −120 dB floor frame adds ~50 dB of
        # linear-fit residual, swamping the 0.25 dB beat threshold —
        # measured round 3 on a fast-decaying 44.1 kHz bass)
        env_parent = db[lo:hi, b0]
        live = np.where(env_parent >= env_parent.max() - 25.0)[0]
        if len(live) >= min_frames:
            hi = lo + int(live[-1]) + 1
        if hi - lo < min_frames:
            continue
        # feeder guard (round 3): the collision guard above only knows
        # DETECTED events, but an UNDETECTED sounding string whose
        # harmonic lands on bin n+12 makes the bin beat regardless of
        # doubling (measured: a rolled-off 48 in [48,55,60] fed 67 =
        # 48+19 and minted a false octave over the 55; same with a dead
        # 52 feeding 83 = 52+31 in [52,64]).  Any LIVE raw-CQT bin a
        # harmonic interval (h3..h8) below n+12 is such a feeder: skip.
        feeders = np.array([n + 12 - h - fmin
                            for h in HIGH_HARMONIC_INTERVALS], np.int64)
        feeders = feeders[(feeders >= 0) & (feeders < n_bins)]
        if (cache.med_row(lo, hi)[feeders]
                >= track_max_db - feeder_floor_db).any():
            continue
        if cache.med(lo, hi, b12) < track_max_db - level_floor_db:
            continue
        r0, c0 = cache.shape(lo, hi, b0)

        def _beats_at(b, floor_db=level_floor_db):
            """Two detuned components at bin b (vs the parent's own
            wobble)?  The beat scan extends past n+12 to n+31/n+36 — the
            octave string's h3/h4 against the parent's h6/h8 — because
            the components' Hz offset scales with harmonic number: at
            44.1 kHz the string quantization is twice as fine as at
            22.05 kHz and the h2 pair can beat slower than the chord
            lasts (measured: the doubled 52 over a 40-bass reads
            straight at n+12 but beats at n+36).  The aux bins use a
            TIGHTER 40 dB floor than the n+12 bin: near the noise floor
            every residual is large and a rolled-off h8's wiggle minted
            false octaves into standard chords (measured round 3)."""
            if cache.med(lo, hi, b) < track_max_db - floor_db:
                return False
            rb, cb = cache.shape(lo, hi, b)
            return (rb >= max(resid_thr, rel_factor * r0)
                    or cb >= max(curv_thr, rel_factor * c0))

        beat = _beats_at(b12)
        aux_informative = False
        if not beat:
            for up in (31, 36):
                b = n + up - fmin
                if b >= n_bins:
                    continue
                # the higher bin must not be fed by ANOTHER concurrent
                # event's partial LINE (the parent itself legitimately
                # feeds it — that collision is exactly what the beat
                # measures; foreign lines fake it, measured round 3 on a
                # 52-string's h5 a rim away from bin 79)
                def _med_note(note, _lo=lo, _hi=hi):
                    bb = note - fmin
                    if not (0 <= bb < n_bins):
                        return None
                    return cache.med(_lo, _hi, bb)

                if _foreign_line_near(float(n + up), concurrent, {n},
                                      parent_note=n, med_env=_med_note,
                                      evidence_db=cache.med(lo, hi, b)):
                    continue
                if cache.med(lo, hi, b) >= track_max_db - 40.0:
                    # a live, foreign-free aux bin is a REAL measurement:
                    # straight there means a confident "no doubling"
                    aux_informative = True
                if _beats_at(b, floor_db=40.0):
                    beat = True
                    break
        if beat:
            lvl = float(cache.med(lo, hi, b12) - cache.med(lo, hi, b0))
            out.append({**e, "note": n + 12,
                        "salience": sal * min(10.0 ** (lvl / 20.0), 1.0),
                        "recovered_octave": True})
        elif not aux_informative:
            # the measured 44.1 kHz power-chord ceiling (VALIDATION.md
            # rounds 3-4): string-period quantization at this register is
            # so fine that the h2 pair's beat can be SLOWER than the
            # chord — a straight n+12 envelope is then what BOTH a lone
            # bass and a true doubling look like — and every aux bin was
            # dead or fed by a foreign partial line.  When additionally
            # the minimum quantization beat (δf ≈ f₁₂²/2sr, half a
            # period-quantization step at the h2 frequency) cannot
            # complete half a cycle inside the observation window, the
            # doubling is UNPROVABLE either way: surface that to the
            # user instead of silently deciding (VERDICT r3 #4).
            r12, _ = cache.shape(lo, hi, b12)
            f12 = _HZ_TABLE[min(n + 12, len(_HZ_TABLE) - 1)]
            beat_hz_bound = f12 * f12 / (2.0 * sr)
            win_s = (hi - lo) / fps
            if r12 < resid_thr and win_s * beat_hz_bound < 0.5:
                e["octave_uncertain"] = True
    out.sort(key=lambda ev: (ev["start"], ev["note"]))
    return out


def repitch_suboctave_ghosts(events: List[dict], cqt_mag: np.ndarray,
                             sr: int, hop_length: int,
                             margin_db: float = 13.0,
                             abs_floor_db: float = 28.0,
                             attack_skip_s: float = 0.12,
                             min_frames: int = 6,
                             n_fft: int | None = None,
                             leak_bins: float = 2.0,
                             leak_margin_db: float = 4.0,
                             db: np.ndarray | None = None,
                             cache: "_EnvCache | None" = None,
                             track_peak_db: float | None = None) -> List[dict]:
    """Re-pitch sub-octave decodes of the peel's -12 redirect up an octave.

    The peel's sub-harmonic preference redirects a pick at bin n to n-12
    when the comb there looks plausible; on power chords it can OVERSHOOT —
    the true fifth 47 in [40,47,52] lands as a phantom 35 BELOW the real
    bass (measured: the 35 event's own raw-CQT bin sits at -30 dB vs track
    peak while bin 47 carries the real string at -15 dB).  Such an event is
    the upper note decoded an octave low: move it up instead of letting the
    ghost guard block every later recovery from the false "bass".

    Guards, each against a measured failure (2026-08-19 sweep over all six
    truth families, margins 10-18 dB x floors 22-30 dB):
      * lowest voice only — redirect overshoot mints BELOW the true bass;
        a mid-chord true note with a weak fundamental matches the level
        test otherwise (a real 60 in [57,60,64] with dead fundamental was
        re-pitched to a false 72 until this guard);
      * own bin dead in absolute terms (>= ``abs_floor_db`` under the
        track CQT peak) — true fundamentals measured -6..-20 dB, redirect
        ghosts -30 dB;
      * +12 bin >= ``margin_db`` louder — KS harmonics routinely run a few
        dB above a weak fundamental (true 48's h2 measured +10 dB), so the
        margin must clear that.  Margins 10/12 without the lowest-voice
        guard nicked std22/oct22B; with the guard, 12-14 measured
        equivalent and strictly better than 15 (a phantom 35 with
        margin 14.9 dB on oct22A seed 6) — 13 ships as the midpoint,
        fresh-seed identical to 15;
      * drop instead of re-pitch when the +12 note already exists.

    Runs BEFORE recover_octave_doublings/recover_missing_fifths so the
    corrected event (not the phantom) anchors their bass/ghost guards.
    Measured effect (with the other two passes): oct44A family mean F1
    0.826 -> 0.881 design seeds / 0.838 fresh seeds, min 0.71 -> 0.82;
    every other family unchanged."""
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]
    track_max_db = (float(np.max(db)) if track_peak_db is None
                    else track_peak_db)
    n_fft = n_fft or _default_n_fft(sr)
    binw = sr / n_fft

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        action = _nat.poly_repitch_native(
            cache._nh, events, binw, fmin, n_bins, track_max_db,
            margin_db, abs_floor_db, attack_skip_s, min_frames,
            leak_bins, leak_margin_db)
        out = []
        for e, a in zip(events, action.tolist()):
            if a == 0:
                out.append(e)
            elif a == 2:
                out.append({**e, "note": e["note"] + 12,
                            "repitched_octave": True})
        return out

    out = []
    rows = _overlap_rows(events)
    for i, e in enumerate(events):
        n = e["note"]
        b0, b12 = n - fmin, n + 12 - fmin
        if not (0 <= b0 < n_bins and b12 < n_bins):
            out.append(e)
            continue
        if e.get("rescued_root"):
            # rescue proved the weak fundamental by envelope physics; the
            # level test here would re-judge exactly that weakness
            out.append(e)
            continue
        concurrent = [events[j] for j in rows[i]]
        if any(o["note"] < n for o in concurrent):
            out.append(e)
            continue
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if hi - lo < min_frames:
            out.append(e)
            continue
        own = cache.med(lo, hi, b0)
        up = cache.med(lo, hi, b12)
        # "own bin dead" in absolute terms, OR its level fully explained as
        # window leakage from a concurrent string within ~2 FFT bins (the
        # marginal case measured round 3: a phantom 35 at 0.3 dB ABOVE the
        # absolute floor, lit by the 40-string's main lobe)
        f_n = _HZ_TABLE[n]
        leak_dead = any(
            o["note"] != n and 0 <= o["note"] - fmin < n_bins
            and abs(f_n - _HZ_TABLE[o["note"]]) <= leak_bins * binw
            and own <= cache.med(lo, hi, o["note"] - fmin) - leak_margin_db
            for o in concurrent)
        dead = own < track_max_db - abs_floor_db or leak_dead
        if dead and up - own >= margin_db:
            dup = any(o["note"] == n + 12 for o in concurrent)
            if not dup:
                out.append({**e, "note": n + 12, "repitched_octave": True})
            continue
        out.append(e)
    return out


def recover_missing_fifths(events: List[dict], cqt_mag: np.ndarray,
                           sr: int, hop_length: int,
                           level_floor_db: float = 45.0,
                           rel_parent_db: float = 30.0,
                           max_resid: float = 1.0,
                           attack_skip_s: float = 0.12,
                           min_frames: int = 10,
                           db: np.ndarray | None = None,
                           cache: "_EnvCache | None" = None,
                             track_peak_db: float | None = None) -> List[dict]:
    """Recover a power chord's out-competed FIFTH from the raw CQT plane.

    The round-2 residual failure (VALIDATION.md): in [40,47,52] the fifth
    (47, B2) stays alive in the raw CQT at ~-14 dB but the peel's argmax
    never picks it — composite harmonic bins (71 = B2's h4 = E3's h3)
    out-salience it and the -19/-12 redirects can't reach 47 from them.
    Generic masked-voice recovery (mint any unexplained straight-decay
    bin) was measured and rejected — rim-adjacent FPs outweighed the
    recovered fifth at every rim width.  The targeted version works
    because a perfect fifth is NOT in the bass's harmonic series: +7
    semitones (3:2) falls between h1 (+0) and h2 (+12), and the
    pseudo-CQT triangle (~±2 semitones) cannot leak either into bin n+7.
    Direct sustained energy there is therefore a real voice.

    DECISION per detected bass event (note n): recover n+7 iff the bin's
    sustain envelope (attack skipped) sits within ``level_floor_db`` of
    the track CQT peak AND within ``rel_parent_db`` of the parent's own
    bin AND is a clean decaying pluck (linear-fit RMS residual <=
    ``max_resid`` dB, fitted slope <= 0).  Guards shared with
    recover_octave_doublings (bass only, salience ghost guards) plus:
      * note-rim guard — skip when any concurrent event lies within ±2
        semitones of n+7 (its triangle leaks into the bin);
      * harmonic-collision guard — skip when any concurrent event's
        harmonic (h2..h8) lands within ±2 semitones of n+7.

    Measured (2026-08-19 sweep, floors 35-55 x rel 15-35 x resid 0.6-1.5
    over all six truth families): with the re-pitch + ghost-ratio fixes,
    oct22A mean F1 0.805 -> 0.868 design / 0.822 -> 0.880 fresh seeds,
    std44 0.960 -> 0.964 (a true fifth recovered there too), std22 stays
    1.0/precision 1.0 on all 12 seeds, B families bit-identical — zero
    false fifths on 48 non-power-chord clips."""
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]
    out = list(events)
    track_max_db = (float(np.max(db)) if track_peak_db is None
                    else track_peak_db)

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        mints = _nat.poly_recover_fifths_native(
            cache._nh, events, fmin, n_bins, track_max_db, level_floor_db,
            rel_parent_db, max_resid, attack_skip_s, min_frames)
        for p, s in mints:
            new = {**events[p], "note": events[p]["note"] + 7,
                   "salience": s, "recovered_fifth": True}
            new.pop("octave_uncertain", None)
            out.append(new)
        out.sort(key=lambda ev: (ev["start"], ev["note"]))
        return out

    rows = _overlap_rows(events)
    appended: List[dict] = []
    for i, e in enumerate(events):
        n = e["note"]
        b0, b7 = n - fmin, n + 7 - fmin
        if not (0 <= b0 < n_bins and b7 < n_bins):
            continue
        # the original scan walks the GROWING ``out`` (base events in list
        # order, then fifths recovered by earlier iterations) — rebuild
        # that exact order from the precomputed base rows + the short
        # appended tail
        concurrent = [events[j] for j in rows[i]] \
            + [a for a in appended
               if a["start"] <= e["end"] and e["start"] <= a["end"]]
        if any(abs(o["note"] - (n + 7)) <= 2 for o in concurrent):
            continue
        sal = e.get("salience", 0.0)
        peers = [o.get("salience", 0.0) for o in concurrent] + [sal]
        if sal < 0.5 * max(peers):
            continue
        if any(o["note"] < n and o.get("salience", 0.0) >= 0.5 * sal
               for o in concurrent):
            continue
        if any(abs((o["note"] + h) - (n + 7)) <= 2
               for o in concurrent for h in HARMONIC_INTERVALS):
            continue
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if hi - lo < min_frames:
            continue
        env7 = db[lo:hi, b7]
        med7 = cache.med(lo, hi, b7)
        if med7 < track_max_db - level_floor_db:
            continue
        if med7 < cache.med(lo, hi, b0) - rel_parent_db:
            continue
        T = len(env7)
        t = np.arange(T, dtype=np.float64)
        a, b = _linefit(t, env7)
        resid = float(np.sqrt(np.mean((env7 - (a * t + b)) ** 2)))
        if resid > max_resid or a * fps > 0.0:
            continue
        lvl = med7 - cache.med(lo, hi, b0)
        new = {**e, "note": n + 7,
               "salience": sal * min(10.0 ** (lvl / 20.0), 1.0),
               "recovered_fifth": True}
        # the parent's octave ambiguity (octave_uncertain, set by the
        # preceding pass) is about ITS +12 bin, not the minted fifth
        new.pop("octave_uncertain", None)
        out.append(new)
        appended.append(new)
    out.sort(key=lambda ev: (ev["start"], ev["note"]))
    return out


def drop_straight_harmonic_ghosts(events: List[dict], cqt_mag: np.ndarray,
                                  sr: int, hop_length: int,
                                  intervals: frozenset = HARMONIC_INTERVALS,
                                  resid_thr: float = 0.25,
                                  curv_thr: float = 1.0,
                                  rel_factor: float = 4.0,
                                  attack_skip_s: float = 0.12,
                                  min_frames: int = 10,
                                  sal_guard: float | None = None,
                                  line_harmonics: tuple | None = None,
                                  line_tol_semis: float = 1.2,
                                  beat_scan: bool = False,
                                  beat_floor_db: float = 35.0,
                                  db: np.ndarray | None = None,
                                  cache: "_EnvCache | None" = None,
                                  track_peak_db: float | None = None
                                  ) -> List[dict]:
    """Drop harmonic GHOSTS by envelope physics — the INVERSE of
    recover_octave_doublings.

    The peel's residual false positives are events a harmonic interval
    above a concurrent lower voice (e.g. a phantom 79 = 60 + 19, the
    bass's h3) whose salience the comb could not separate.  The same
    string-physics discriminator that recovers doubled octaves judges
    them in reverse: if the candidate's own raw-CQT bin over its sustain
    is a SINGLE clean exponential (straight dB line — linear-fit RMS
    residual < ``resid_thr`` dB AND |late-early slope| < ``curv_thr``
    dB/s, both also < ``rel_factor`` x the lowest parent's own values,
    so a vibrato/bend parent excuses wobble), the bin holds exactly one
    component: the parent's partial.  An independent voice at that pitch
    would add a detuned component and the envelope would beat.

    ``intervals`` selects which harmonic offsets are candidate ghosts;
    ``sal_guard`` keeps any event whose salience >= sal_guard x the max
    overlapping parent's (a voice with its own comb).  The measured
    shipping configuration (2026-08-20 sweep, six truth families x
    design AND fresh seeds) is TWO passes after the recovery chain:
    h3..h8 intervals (+19..+36) on straightness alone — those pitches
    are rarely real chord voices and the straight/beating separation is
    clean — then +12 with sal_guard=1.0, because a true octave voice
    whose bin is dominated by its own fundamental and a pure h2 ghost
    can BOTH read straight (measured degenerate pair: true 52 under a
    40-bass vs false 67 over a 55-bass); salience separates most.

    Measured (tests/test_poly_truth.py, VALIDATION.md): design seeds
    oct22B 0.963 -> 1.0, std44 0.964 -> 0.986, oct44B 0.927 -> 0.987,
    oct44A 0.881 -> 0.894, oct22A 0.886 -> 0.894, std22 1.0 unchanged;
    fresh seeds std22 0.979 -> 0.986, oct22A 0.880 -> 0.888, oct44A
    0.838 -> 0.891, oct44B 0.949 -> 0.959, std44 1.0 / oct22B 0.936
    unchanged — no family or seed worse on either set.  Recovered
    octave events re-enter the +12 pass by design: their bins measured
    beating (that is why they were recovered), so the same physics that
    minted them keeps them."""
    fps = sr / hop_length
    db = _dbp(cqt_mag, db)
    cache = cache if cache is not None else _EnvCache(db, fps)
    fmin = int(round(CQT_FMIN_MIDI))
    n_bins = cqt_mag.shape[1]

    if _native_pass_ok(events, fmin, n_bins, cache):
        _nat = _NO_NATIVE

        tm = (track_peak_db if track_peak_db is not None
              else (float(np.max(db)) if beat_scan else 0.0))
        keep = _nat.poly_drop_straight_native(
            cache._nh, events, fmin, n_bins, tm, intervals, resid_thr,
            curv_thr, rel_factor, attack_skip_s, min_frames, sal_guard,
            line_harmonics, line_tol_semis, beat_scan, beat_floor_db)
        return [e for e, k in zip(events, keep) if k]

    out = []
    rows = _overlap_rows(events)
    for i, e in enumerate(events):
        n = e["note"]
        b0 = n - fmin
        if not (0 <= b0 < n_bins):
            out.append(e)
            continue
        if e.get("rescued_root"):
            # a rescued root's own bin is straight BY CONSTRUCTION (the
            # weak-fundamental case); its voice-hood was proven by the
            # beat at its h2 bin (rescue_dead_fundamentals), which this
            # pass cannot see
            out.append(e)
            continue
        if line_harmonics is not None:
            # frequency-line proximity: a parent's h-th PARTIAL within
            # ``line_tol_semis`` of e's pitch makes e a ghost candidate.
            # The semitone-interval grid misses real partials — h5 sits
            # at +27.86 and h7 at +33.69 semitones, each lighting BOTH
            # neighboring bins (measured 44.1 kHz rim ghosts at +23/+32/
            # +33 that exact-interval matching could never judge).  The
            # pair sweep runs as one (rows, harmonics) log2 matrix.
            f_n = midi_to_hz(n)
            idx = rows[i]
            cn = np.fromiter((events[j]["note"] for j in idx),
                             np.int64, len(idx))
            h_a = np.asarray(line_harmonics, np.float64)
            near = np.abs(12.0 * np.log2(
                f_n / (h_a[None, :] * _HZ_TABLE[cn][:, None]))
            ) <= line_tol_semis
            pm = (cn < n) & near.any(axis=1)
            parents = [events[j] for j, keep in zip(idx, pm) if keep]
        else:
            parents = [o for o in (events[j] for j in rows[i])
                       if (n - o["note"]) in intervals]
        if not parents:
            out.append(e)
            continue
        if sal_guard is not None and e.get("salience", 0.0) >= sal_guard * \
                max(o.get("salience", 0.0) for o in parents):
            out.append(e)
            continue
        lo = e["start"] + int(attack_skip_s * fps)
        hi = min(e["end"] - 1, cqt_mag.shape[0])
        if hi - lo < min_frames:
            out.append(e)
            continue
        r, c = cache.shape(lo, hi, b0)
        # the parent's own envelope excuses wobble (vibrato/bend parents)
        p = min(parents, key=lambda o: o["note"])
        bp = p["note"] - fmin
        rp, cp = cache.shape(lo, hi, bp)
        if r < max(resid_thr, rel_factor * rp) and c < max(curv_thr,
                                                           rel_factor * cp):
            # straight single exponential: a partial — UNLESS the upper
            # beat scan (beat_scan=True on the +12 pass) finds the
            # candidate's own harmonics beating against the parent's even
            # partials at n+12/n+19/n+24.  A true octave voice whose own
            # bin reads straight (string quantization at 44.1 kHz is
            # twice as fine as 22.05 kHz, so the h2 pair can beat slower
            # than the chord lasts) still betrays itself higher up, where
            # the components' Hz offset scales with harmonic number
            # (measured: a true 52 over a 40-bass, straight at bin 52,
            # beats r=1.0-1.3 at bin 76 = its h4 ≡ the bass's h8).  Scan
            # bins must be live and free of OTHER events' partial lines
            # (within 1.5 semitones), else the beat proves nothing.
            if beat_scan:
                track_max_db = (float(np.max(db)) if track_peak_db is None
                                else track_peak_db)
                others = [events[j] for j in rows[i]]
                kept = False
                for up in (12, 19, 24):
                    b = n + up - fmin
                    if b >= n_bins:
                        continue
                    if cache.med(lo, hi, b) < track_max_db - beat_floor_db:
                        continue

                    def _med_note(note, _lo=lo, _hi=hi):
                        bb = note - fmin
                        if not (0 <= bb < n_bins):
                            return None
                        return cache.med(_lo, _hi, bb)

                    if _foreign_line_near(float(n + up), others,
                                          {n, p["note"]},
                                          parent_note=p["note"],
                                          med_env=_med_note,
                                          evidence_db=cache.med(lo, hi, b)):
                        continue
                    rb, cb = cache.shape(lo, hi, b)
                    if (rb >= max(resid_thr, rel_factor * rp)
                            or cb >= max(curv_thr, rel_factor * cp)):
                        kept = True
                        break
                if kept:
                    out.append(e)
                    continue
            continue
        out.append(e)
    return out


def refine_poly_events(events: List[dict], onsets: np.ndarray,
                       rms_db: np.ndarray, salience: np.ndarray,
                       sr: int, hop_length: int,
                       total_frames: int | None = None,
                       snap_back_ms: float = 200.0,
                       birth_tol_ms: float = 80.0,
                       rise_db: float = 2.0,
                       sal_ratio: float = 0.55,
                       decay_frac: float = 0.5,
                       cqt_mag: np.ndarray | None = None,
                       n_fft: int | None = None,
                       track_peak_db: float | None = None) -> List[dict]:
    """The composed polyphonic refinement: salience attach -> start snap ->
    decay prune -> onset birth gate -> attack-rise gate -> dead-fundamental
    rescue -> harmonic dedup -> raw-CQT recovery chain (sub-octave
    re-pitch, leakage-ghost drop, octave-doubling recovery, missing-fifth
    recovery, straightness + composite ghost drops — when the raw CQT
    plane is available).

    Snap runs FIRST so every gate judges the corrected start (a voice
    masked during a chord attack is first accepted late; gating on the raw
    start rejected it, measured on the 3rd voice of dense chords).
    ``events`` must already be onset-split (split_events_at_onsets).

    Frame 0 is added as a virtual onset: spectral flux cannot emit an
    onset at the first frame, so audio that begins directly on a note
    (a trimmed upload) would otherwise lose its whole opening chord to
    the birth gate.  With leading silence the roll near frame 0 is
    already zeroed by silence_gate, so the virtual onset is inert.
    NEGATIVE onsets mark a windowed caller (the live horizon cache passes
    globally-picked onsets shifted by the window offset): the track head
    is then outside the window, so no local virtual onset is added — the
    global one arrives, shifted, in the list itself."""
    fps = sr / hop_length
    onsets = np.asarray(onsets, np.int64)
    if len(onsets) == 0 or onsets.min() >= 0:
        onsets = np.unique(np.concatenate([[0], onsets]))
    else:
        onsets = np.unique(onsets)
    events = attach_salience(events, np.asarray(salience))
    events = snap_starts_poly(events, onsets, rms_db,
                              back_frames=int(snap_back_ms / 1000.0 * fps))
    events = decay_prune(events, onsets, frac=decay_frac,
                         total_frames=total_frames)
    events = onset_birth_gate(events, onsets,
                              tol_frames=int(birth_tol_ms / 1000.0 * fps))
    # the rise gate's window and per-frame-diff threshold are anchored to
    # the truth-validated grid (22.05 kHz hop 512 == 44.1 kHz hop 1024,
    # both fps 43.07 — the scaling is exactly 1.0 there): at a higher
    # frame rate an attack's rise spreads over proportionally more frames,
    # so the window widens and the per-frame rise requirement relaxes
    events = attack_rise_gate(
        events, rms_db,
        win_frames=max(int(round(4 * fps / _GATE_REF_FPS)), 1),
        min_rise_db=rise_db * min(1.0, _GATE_REF_FPS / fps))
    if cqt_mag is not None:
        # the dead-fundamental rescue runs BEFORE harmonic_dedup: the
        # peel's harmonic picks of an invisible string are its evidence,
        # and dedup is about to attribute them to the wrong parent
        # (measured: a dead 52 in [40,47,52] is only witnessed by its h2
        # pick at 64, which dedup then hands to 40 as "h4").
        cqt_mag = np.asarray(cqt_mag)
        # ONE dB plane + ONE envelope-stat memo threaded through the whole
        # chain (see _dbp / _EnvCache): chord voices share windows and the
        # passes share the 0.12 s attack skip, so medians/shape fits repeat
        # heavily across passes
        dbp = _dbp(cqt_mag)
        ecache = _EnvCache(dbp, fps)
        events = rescue_dead_fundamentals(events, cqt_mag, sr, hop_length,
                                          n_fft=n_fft, db=dbp, cache=ecache,
                                          track_peak_db=track_peak_db)
    events = harmonic_dedup(events, sal_ratio=sal_ratio)
    if cqt_mag is not None:
        # the raw-CQT recovery chain runs LAST: it judges the surviving
        # (refined) events, and the events it adds/corrects must not
        # re-enter the gates (start/end are inherited from an
        # already-gated parent).  Order matters and is measured: the
        # re-pitch first (a sub-octave phantom below the true bass blocks
        # every later bass-anchored recovery), then the window-leakage
        # drop (a leakage phantom below the bass anchors guards too, but
        # must outlive the re-pitch, which converts one phantom class to
        # its true note), then octave doublings, then the fifth (whose
        # collision guards read the recovered set), then the straightness
        # ghost drop (which must judge the FULL recovered set — a
        # recovered octave's beating bin survives its +12 pass by the
        # same physics that minted it), then the composite-bin drop
        # (beating bins explained by TWO detected parents' partials).
        events = repitch_suboctave_ghosts(events, cqt_mag, sr, hop_length,
                                          n_fft=n_fft, db=dbp, cache=ecache,
                                          track_peak_db=track_peak_db)
        events = drop_leakage_ghosts(events, cqt_mag, sr, hop_length,
                                     n_fft=n_fft, db=dbp, cache=ecache)
        events = recover_octave_doublings(events, cqt_mag, sr, hop_length,
                                          db=dbp, cache=ecache,
                                          track_peak_db=track_peak_db)
        events = recover_missing_fifths(events, cqt_mag, sr, hop_length,
                                        db=dbp, cache=ecache,
                                        track_peak_db=track_peak_db)
        events = drop_straight_harmonic_ghosts(
            events, cqt_mag, sr, hop_length,
            line_harmonics=tuple(range(3, 11)), db=dbp, cache=ecache,
            track_peak_db=track_peak_db)
        # composite drop BEFORE the +12 pass: a composite rim phantom
        # (e.g. a pick at 63 between the bass's h4 and the octave's h2
        # lines) otherwise survives into the +12 pass's foreign-line
        # guard and blocks the true octave's beat evidence (measured
        # round 3 at 44.1 kHz)
        events = drop_composite_harmonic_ghosts(events)
        events = drop_straight_harmonic_ghosts(
            events, cqt_mag, sr, hop_length,
            intervals=frozenset((12,)), sal_guard=1.0, beat_scan=True,
            db=dbp, cache=ecache, track_peak_db=track_peak_db)
        # a second leakage pass: rim phantoms of a voice that only ENTERED
        # the event set via the recovery chain (e.g. a 44.1 kHz pick at
        # the −1 rim of a dead-fundamental string's h2 line) have no
        # source event to compare against until the chain has run
        events = drop_leakage_ghosts(events, cqt_mag, sr, hop_length,
                                     n_fft=n_fft, db=dbp, cache=ecache)
    return events


def extract_events_poly(analysis: Dict[str, np.ndarray], sr: int,
                        hop_length: int, n_fft: int,
                        **kwargs) -> List[dict]:
    """Segment the piano roll into note events.

    ``use_onsets=True`` (library default) runs the full polyphonic
    refinement: silence gate, onset re-attack split, chord-aware
    start snap, decay prune, onset birth + attack-rise gates,
    absolute-salience harmonic dedup, the raw-CQT recovery chain
    (core.poly.refine_poly_events).  ``use_onsets=False`` is the plain
    pitch-only segmentation.  (The MIDI encode of the facade is
    the checker's, through ``host_v1.events_to_midi``.)"""
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
        roll = silence_gate(
            roll, rms_db, kwargs.get("silence_db", 45.0),
            peak_db=kwargs.get("rms_peak_db"))
    events = roll_to_events(
        roll, analysis["confidence"], analysis["rms"],
        sr, hop_length,
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
            onsets = pick_onsets(analysis["onset_env"], sr,
                                 hop_length)
        fps = sr / hop_length
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
            events = refine_poly_events(
                events, onsets, rms_db, analysis["salience"],
                sr, hop_length,
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
                n_fft=n_fft,
                # track-global CQT peak override (live horizon cache)
                track_peak_db=kwargs.get("track_peak_db"))
    return events
