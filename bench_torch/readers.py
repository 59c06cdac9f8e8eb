"""Arithmetic shared by the per-layer readers in ``metrics/``: each reader
is a file of its own that calls one of these on the traced slice and
returns None where the slice has nothing for it to read."""

from __future__ import annotations

import json
import os
from typing import List, Optional

from bench_torch import roofline
from bench_torch.trace import Slice

_KERNELS = os.path.join(os.path.dirname(__file__), "metrics",
                        "viterbi_kernels.json")


def span_ms(sl: Slice, item, label: str) -> float:
    """Milliseconds of the spans ``label`` that lie inside the item."""
    return sum(e - s for lab, s, e in sl.spans
               if lab == label and s >= item["t0"] and e <= item["t1"]) / 1e6


def mean_span_ms(sl: Slice, label: str) -> Optional[float]:
    if not sl.items or not any(lab == label for lab, _, _ in sl.spans):
        return None
    return sum(span_ms(sl, it, label) for it in sl.items) / len(sl.items)


def mean_outside_ms(sl: Slice, labels: List[str]) -> Optional[float]:
    """An item's wall time less its spans ``labels``, mean over items."""
    if not sl.items or not any(lab in labels for lab, _, _ in sl.spans):
        return None
    return sum(it["ms"] - sum(span_ms(sl, it, lab) for lab in labels)
               for it in sl.items) / len(sl.items)


def n_units(sl: Slice) -> int:
    """Requests, or tracks (each pass of a folder counts its tracks)."""
    return sum(it.get("n_tracks", 1) for it in sl.items)


def ops_per_unit(sl: Slice) -> Optional[float]:
    if not sl.ops or not sl.items:
        return None
    return len(sl.ops) / n_units(sl)


def idle_pct(sl: Slice) -> Optional[float]:
    if not sl.ops or sl.t1 <= sl.t0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def viterbi_roofline_pct(sl: Slice) -> Optional[float]:
    """The decode's least time, counted from its shapes, over the device
    time of the kernels the data file names."""
    with open(_KERNELS) as f:
        names = json.load(f)["kernels"]
    busy_ns = sum(e - s for name, s, e in sl.ops
                  if any(k in name for k in names))
    decodes = [d for it in sl.items for d in it.get("decodes", [])]
    if busy_ns <= 0 or not decodes or "pyin" not in sl.cfg:
        return None
    a = sl.cfg["audio"]
    n, w = roofline.pitch_grid(sl.cfg["pyin"], a["sample_rate"],
                               a["hop_length"])
    return 100.0 * roofline.decode_bound_s(decodes, n, w) / (busy_ns / 1e9)




def kernel_launches_per_unit(sl: Slice) -> Optional[float]:
    """Launches of the decode's kernels over the items of a traced slice
    that saw the device at all."""
    if not sl.ops or not sl.items:
        return None
    with open(_KERNELS) as f:
        names = json.load(f)["kernels"]
    return sum(any(k in name for k in names)
               for name, _, _ in sl.ops) / n_units(sl)
