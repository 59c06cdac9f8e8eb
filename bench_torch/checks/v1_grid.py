"""The check of a v1 configuration whose pitch grid is what it adds: every
number of ``checks/v1.py``, and the decoded states themselves, which none
of those sees (the voiced probabilities come before the decode, and an
event's note is rounded to a whole semitone):

  state_miss_pct  100 x the share of a take's frames whose decoded state
                  is not the float64 reference's (``reference/v1_device.py``
                  at the configuration's grid): the voiced flag differs, or
                  both are voiced and the pitch bins differ; the worst take
                  of the sample.  A bin is read from the f0 row,
                  fmin * 2^(bin / (12 nbps)), so a program on another grid,
                  or a decode one bin (5 cents at resolution 0.05) off,
                  reads here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bench_torch.checks import v1
from bench_torch.reference import v1_device


def bins(f0, voiced, fmin: float, nbps: int) -> np.ndarray:
    """Each frame's pitch bin at ``nbps`` bins a semitone above ``fmin``,
    -1 where unvoiced."""
    f0 = np.nan_to_num(np.asarray(f0, np.float64))
    on = np.asarray(voiced, bool) & (f0 > 0)
    out = np.full(len(f0), -1, np.int64)
    out[on] = np.round(12 * nbps * np.log2(f0[on] / fmin))
    return out


def state_miss_pct(rows: Dict, ref: Dict, cfg: Dict) -> float:
    p = cfg["pyin"]
    nbps = int(round(1.0 / p["resolution"]))
    got = bins(rows["f0"], rows["voiced_flag"], p["fmin"], nbps)
    want = bins(ref["f0"], ref["voiced_flag"], p["fmin"], nbps)
    return 100.0 * float(np.mean(got != want))


def check(samples: List[Dict], cfg: Dict, mix: Dict,
          device) -> Dict[str, float]:
    """The numbers of ``checks/v1.py`` for ``samples``, and
    ``state_miss_pct``."""
    out = v1.check(samples, cfg, mix, device)
    if not samples:
        return {**out, "state_miss_pct": v1.MISSING}
    worst = 0.0
    for s in samples:
        ref = v1_device.analyze(s["pcm"], cfg, device)
        rows = s["rows"]
        if rows is None or len(rows["f0"]) != len(ref["f0"]):
            worst = v1.MISSING
            break
        worst = max(worst, state_miss_pct(rows, ref, cfg))
    out["state_miss_pct"] = worst
    return out
