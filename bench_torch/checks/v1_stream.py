"""The check of a streamed v1 configuration (``v1_long_44k``): every number
of ``checks/v1.py`` and ``checks/v1_grid.py``'s ``state_miss_pct``, each
computed as there, against the plain reference of what the configuration
states for the take: ``reference/v1_stream.py`` (each haloed tile decoded
on its own, slab edges from the int16 copy) for a take longer than its
``stream.threshold_s``, which the server's ``turbo=auto`` streams, and
``reference/v1_device.py`` (the whole-track fused program) for a shorter
one.

The configuration's ``stream`` numbers are constants of the port that no
request can set; the check refuses a configuration whose numbers differ
from what the port runs (``stream_numbers``).

With ``control`` set the reference computes with that lower-precision
ingest of the slabs in the program's place (the streamed path has no such
option of its own), its events and MIDI from the reference host chain.
"""

from __future__ import annotations

import inspect
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from bench_torch import program
from bench_torch.checks import v1, v1_grid
from bench_torch.reference import host_v1, v1_device, v1_stream

KEYS = ("prob_gap_p99", "rms_gap", "onset_gap", "mel_gap_db",
        "event_miss_pct", "midi_diff", "state_miss_pct")


def stream_numbers(cfg: Dict) -> Iterable[Tuple[str, object, object]]:
    """(key, the configuration's number, what the port runs) for each
    ``stream`` number: ``TurboConfig()``'s tile and halo, the streamed
    program's tiles a slab and fetch group, the server's threshold.  A
    program older than the two constants runs the literals they name."""
    from aegis_tpu_torch.config import TurboConfig
    from aegis_tpu_torch.engine import turbo
    from aegis_tpu_torch.serve import server

    st, tc = cfg["stream"], TurboConfig()
    fetch = inspect.signature(turbo.run_analyze_streamed).parameters[
        "fetch_group"].default
    yield "stream.tile_frames", st["tile_frames"], tc.tile_frames
    yield "stream.halo_frames", st["halo_frames"], tc.halo_frames
    yield ("stream.slab_tiles", st["slab_tiles"],
           getattr(turbo, "STREAM_SLAB_TILES", 16))
    yield "stream.fetch_group", st["fetch_group"], fetch
    yield ("stream.threshold_s", st["threshold_s"],
           getattr(server, "STREAM_THRESHOLD_S", 240.0))


def streamed(pcm: np.ndarray, cfg: Dict) -> bool:
    """True where the server's turbo=auto streams the take."""
    return len(pcm) / cfg["audio"]["sample_rate"] > cfg["stream"][
        "threshold_s"]


def reference_rows(pcm: np.ndarray, cfg: Dict, device,
                   transport: str) -> Dict[str, np.ndarray]:
    """The reference's rows of a take through ``transport``."""
    if streamed(pcm, cfg):
        return v1_stream.analyze(pcm, cfg, device, transport)
    fused = dict(cfg, ingest=dict(cfg["ingest"], transport=transport))
    return v1_device.analyze(pcm, fused, device)


def answer_of(pcm: np.ndarray, cfg: Dict, mix: Dict, device,
              transport: str) -> Dict:
    """What a program following the configuration through ``transport``
    would answer for a take: the reference's rows, events and MIDI."""
    a = cfg["audio"]
    rows = reference_rows(pcm, cfg, device, transport)
    events = v1._events_of(rows, cfg, mix["extract"])
    midi = host_v1.events_to_midi([dict(e) for e in events],
                                  a["sample_rate"], a["hop_length"],
                                  **mix["midi"])
    return {"rows": rows, "events": events, "midi": midi}


def row_gaps(rows: Dict, ref: Dict, cfg: Dict) -> Dict[str, float]:
    """The row numbers of one answer against its reference."""
    def rel(key: str) -> float:
        want = np.asarray(ref[key], np.float64)
        return float(np.max(np.abs(np.asarray(rows[key], np.float64) - want))
                     / max(float(want.max()), 1e-12))

    return {"prob_gap_p99": v1.prob_gap_p99(rows["voiced_probs"],
                                            ref["voiced_probs"]),
            "rms_gap": rel("rms"), "onset_gap": rel("onset_env"),
            "mel_gap_db": float(np.max(np.abs(
                np.asarray(rows["mel_db"], np.float64) - ref["mel_db"]))),
            "state_miss_pct": v1_grid.state_miss_pct(rows, ref, cfg)}


def check(samples: List[Dict], cfg: Dict, mix: Dict, device,
          control: Optional[str] = None) -> Dict[str, float]:
    """The numbers of ``samples`` against the reference, each the worst
    over the sample but for the pooled event score."""
    program.refuse_unless_runs(cfg, extra=stream_numbers(cfg))
    if not samples:
        return dict.fromkeys(KEYS, v1.MISSING)
    a = cfg["audio"]
    out = dict.fromkeys(KEYS, 0.0)
    score = v1.EventScore()
    for s in samples:
        if control:
            s = dict(s, **answer_of(s["pcm"], cfg, mix, device, control))
        ref = answer_of(s["pcm"], cfg, mix, device,
                        cfg["ingest"]["transport"])
        rows = s["rows"]
        if (rows is None or "mel_db" not in rows
                or len(rows["f0"]) != len(ref["rows"]["f0"])):
            for k in KEYS:
                if k not in ("event_miss_pct", "midi_diff"):
                    out[k] = v1.MISSING
        else:
            for k, v in row_gaps(rows, ref["rows"], cfg).items():
                out[k] = max(out[k], v)
        score.add(v1._notes(s["events"]), v1._notes(ref["events"]),
                  cfg["check"]["tol"])
        encoded = host_v1.events_to_midi([dict(e) for e in s["events"]],
                                         a["sample_rate"], a["hop_length"],
                                         **mix["midi"])
        out["midi_diff"] += float(encoded != s["midi"])
    out["event_miss_pct"] = score.miss_pct()
    return out
