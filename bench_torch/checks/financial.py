"""The check of the financial configuration: the folder's answers against
the plain reference (``reference/financial_device.py`` for the rows,
``reference/host_financial.py`` for the events and the dual-track MIDI).

For every sampled track the reference analyses the same take from its
int16 samples, runs the guitar filters and the trend stack over the
padded track in float64, extracts its events with the folder's defaults
and encodes its Main and Safe tracks; the numbers, each the worst take's
over the sample but for the pooled event score:

  prob_gap_p99      as ``checks/v1.py``: p99 of |voiced probability -
                    reference| (a trough within float32 rounding of one of
                    the 100 thresholds moves that threshold's mass whole)
  rms_gap           largest |RMS - reference| over the reference's peak
  onset_gap         largest |onset strength - reference| over its peak
  event_miss_pct    100 (1 - F1) of the notes of both named tracks against
                    the reference's, pooled, matched one to one on pitch,
                    track, start, end and velocity (``tol``), from the MIDI
                    files: a note that lands on the other track misses
  trend_gap_p99     p99 over the frames voiced in both of |consensus trend
                    - reference| in cents: float32 scans against float64
                    loops differ by ~1e-3 cent; a frame whose pitch bin
                    differs moves the Kalman state for ~100 frames, hence
                    p99 and not the largest
  fin_conf_gap_p99  p99 of |Bollinger confidence - reference| (a frame
                    whose f0 or band turns NaN on one side only jumps
                    whole)
  code_miss_pct     the share of frames whose articulation code, slide
                    code or palm-mute flag is not the reference's; the
                    articulation code is not compared on the frames that
                    rounding decides (``financial_device.articulation_ties``:
                    a held pitch on its zero-width band, ~30-45 % of a
                    bench take's frames, and the two valid frames after):
                    the program's float32 moving average puts a held f0
                    below the band (noise) at 29 of the 450 pitch bins,
                    exact arithmetic at none
  threshold_gap     |adaptive threshold - reference|: the threshold that
                    splits the events into Main and Safe, the extractor's
                    rule over the fetched voiced probabilities and
                    financial confidences (the folder load keeps a track's
                    rows and not its scalars, so the device's own
                    ``adaptive_threshold``, over the padded track, is not
                    read)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_torch import stats
from bench_torch.checks import v1 as v1_check
from bench_torch.reference import financial_device, host_financial, host_v1

MISSING = v1_check.MISSING
ROWS = ("prob_gap_p99", "rms_gap", "onset_gap", "trend_gap_p99",
        "fin_conf_gap_p99", "code_miss_pct", "threshold_gap")


def _f64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


def _peak_gap(got, want) -> float:
    want = _f64(want)
    return float(np.max(np.abs(_f64(got) - want))
                 / max(float(want.max()), 1e-12))


def trend_gap_p99(rows: Dict, ref: Dict) -> float:
    """p99 in cents over the frames voiced in both with a trend on both."""
    got, want = _f64(rows["trend"]), _f64(ref["trend"])
    both = (np.asarray(rows["voiced_flag"], bool)
            & np.asarray(ref["voiced_flag"], bool)
            & (np.nan_to_num(got) > 0) & (np.nan_to_num(want) > 0))
    if not both.any():
        return 0.0
    cents = 1200.0 * np.abs(np.log2(got[both] / want[both]))
    return stats.percentile(cents.tolist(), 99)


def code_miss_pct(rows: Dict, ref: Dict) -> float:
    differs = (((np.asarray(rows["artic_codes"]) != ref["artic_codes"])
                & ~ref["artic_ties"])
               | (np.asarray(rows["slide_codes"]) != ref["slide_codes"])
               | (np.asarray(rows["mute_mask"], bool) != ref["mute_mask"]))
    return 100.0 * float(np.mean(differs))


def split_threshold(rows: Dict) -> float:
    """The extractor's confidence threshold over a track's rows."""
    return host_financial.adaptive_confidence_threshold(
        np.asarray(rows["voiced_probs"]) * 0.5
        + np.asarray(rows["financial_confidence"]) * 0.5)


def row_numbers(rows: Dict, ref: Dict) -> Dict[str, float]:
    """The row numbers of one take against its reference."""
    return {
        "prob_gap_p99": v1_check.prob_gap_p99(rows["voiced_probs"],
                                              ref["voiced_probs"]),
        "rms_gap": _peak_gap(rows["rms"], ref["rms"]),
        "onset_gap": _peak_gap(rows["onset_env"], ref["onset_env"]),
        "trend_gap_p99": trend_gap_p99(rows, ref),
        "fin_conf_gap_p99": stats.percentile(np.abs(
            _f64(rows["financial_confidence"])
            - ref["financial_confidence"]).tolist(), 99),
        "code_miss_pct": code_miss_pct(rows, ref),
        "threshold_gap": abs(split_threshold(rows) - split_threshold(ref)),
    }


def reference_midi(ref: Dict, cfg: Dict, mix: Dict) -> bytes:
    """The reference's events and MIDI file, with the folder's defaults
    and the mix's extraction and MIDI parameters."""
    a = cfg["audio"]
    sr, hop = a["sample_rate"], a["hop_length"]
    events, info = host_financial.extract_events_financial(
        rake_mask=ref["rake_mask"], f0=ref["f0"],
        voiced_flag=ref["voiced_flag"], active_probs=ref["voiced_probs"],
        rms=ref["rms"], sr=sr, hop_length=hop, trend=ref["trend"],
        artic_codes=ref["artic_codes"], slide_codes=ref["slide_codes"],
        financial_confidence=ref["financial_confidence"],
        onset_env=ref["onset_env"], **mix["extract"])
    return host_financial.events_to_midi_financial(
        events, sr, hop, bpm=info.get("bpm"), **mix["midi"])


def check(samples: List[Dict], cfg: Dict, mix: Dict,
          device) -> Dict[str, float]:
    """The numbers of ``samples`` against the reference."""
    a = cfg["audio"]
    ticks_a_frame = a["hop_length"] / a["sample_rate"] * host_v1.second2tick(
        1.0)
    out = {k: 0.0 for k in ROWS}
    out["event_miss_pct"] = 0.0
    if not samples:
        return {k: MISSING for k in out}
    score = v1_check.EventScore()
    for s in samples:
        ref = financial_device.analyze(s["pcm"], cfg, device)
        rows = s["rows"]
        if rows is None or len(rows["f0"]) != len(ref["f0"]):
            out.update({k: MISSING for k in ROWS})
        else:
            for k, v in row_numbers(rows, ref).items():
                out[k] = max(out[k], v)
        score.add(v1_check.midi_notes(s["midi"], ticks_a_frame),
                  v1_check.midi_notes(reference_midi(ref, cfg, mix),
                                      ticks_a_frame), cfg["check"]["tol"])
    out["event_miss_pct"] = score.miss_pct()
    return out
