"""Readers of the streamed program (``engine/turbo.py::run_analyze_streamed``)
over a traced slice: its stages by the program's own spans, and the
decode's share of its roofline at the shapes the program reports.  Each
returns None where the slice has nothing for it to read: a program
without the spans gives none, a fused request no ``aegis.stream_*``."""

from __future__ import annotations

import json
from typing import Optional

from bench_torch import program_spans, readers, roofline
from bench_torch.trace import Slice

STAGE = "aegis.stream_stage"
FETCH = "aegis.stream_fetch"
SLAB = "aegis.stream_slab"
DECODE = "aegis.viterbi"


def stage_ms(sl: Slice) -> Optional[float]:
    """ms of the host staging (both quantized copies, the edges, the
    uploads), a request."""
    return program_spans.mean_ms(sl, STAGE)


def fetch_ms(sl: Slice) -> Optional[float]:
    """ms of the grouped fetches of pass 2's outputs, a request."""
    return program_spans.mean_ms(sl, FETCH)


def slabs(sl: Slice) -> Optional[float]:
    """Pass-2 slab dispatches, a request."""
    return program_spans.count_per_unit(sl, SLAB)


def decode_roofline_pct(sl: Slice) -> Optional[float]:
    """The least time of the forward and backtrace kernels, summed over the
    (B, T, n, w) of the slice's ``aegis.viterbi`` spans, over the device
    time of the kernels ``metrics/viterbi_kernels.json`` names (%)."""
    with open(readers._KERNELS) as f:
        names = json.load(f)["kernels"]
    busy_ns = sum(e - s for name, s, e in sl.ops
                  if any(k in name for k in names))
    spans = [s for s in program_spans.in_slice(sl) if s.name == DECODE]
    if busy_ns <= 0 or not spans:
        return None
    bound_s = sum(roofline.decode_bound_s([(s.attrs["B"], s.attrs["T"])],
                                          s.attrs["n"], s.attrs["w"])
                  for s in spans)
    return 100.0 * bound_s / (busy_ns / 1e9)
