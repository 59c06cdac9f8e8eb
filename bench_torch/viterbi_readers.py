"""Readers of the decode's forward pass by its kernel variant: the device
time of the two forward kernels, the wide kernel's share of its roofline,
and the program's ``aegis.viterbi`` spans that name the wide kernel.  Each
returns None where the slice has nothing for it to read: a program without
the span gives no spans, a cell on the one-pass kernel no wide kernel."""

from __future__ import annotations

import json
from typing import Optional

from bench_torch import program_spans, readers, roofline
from bench_torch.trace import Slice

# the forward kernels of the data file (csrc/viterbi.cu): n <= 512 states
# in one pass of a CTA's threads, more in several passes ("wide")
with open(readers._KERNELS) as _f:
    FORWARD = tuple(k for k in json.load(_f)["kernels"] if "_fwd" in k)
WIDE = next(k for k in FORWARD if "wide" in k)
SPAN = "aegis.viterbi"


def kernel_ns(sl: Slice, name: str) -> float:
    """Device ns of the slice's operations whose name holds ``name``."""
    return sum(e - s for op, s, e in sl.ops if name in op)


def forward_ms_per_unit(sl: Slice) -> Optional[float]:
    """Device ms of both forward kernels, a request, chunk or track."""
    if not sl.ops or not sl.items:
        return None
    return sum(kernel_ns(sl, k) for k in FORWARD) / 1e6 / readers.n_units(sl)


def wide_roofline_pct(sl: Slice) -> Optional[float]:
    """The forward pass's least time from the slice's decodes at the
    configuration's grid over the wide kernel's device time (%).  None
    where the wide kernel did not run, or where another forward kernel ran
    beside it: the decodes of the slice would then not all be the wide
    kernel's."""
    busy_ns = kernel_ns(sl, WIDE)
    decodes = [d for it in sl.items for d in it.get("decodes", [])]
    if (busy_ns <= 0 or not decodes or "pyin" not in sl.cfg
            or any(kernel_ns(sl, k) > 0 for k in FORWARD if k != WIDE)):
        return None
    a = sl.cfg["audio"]
    n, w = roofline.pitch_grid(sl.cfg["pyin"], a["sample_rate"],
                               a["hop_length"])
    bound_s = sum(roofline.seconds(*roofline.forward_bound(B, T, n, w))
                  for B, T in decodes)
    return 100.0 * bound_s / (busy_ns / 1e9)


def wide_decodes_per_unit(sl: Slice) -> Optional[float]:
    """``aegis.viterbi`` spans whose forward kernel is the wide one, a
    request, chunk or track; 0 where every decode took the one-pass
    kernel."""
    got = [s for s in program_spans.in_slice(sl) if s.name == SPAN]
    if not got or not sl.items:
        return None
    return sum(s.attrs.get("kernel") == WIDE for s in got) / readers.n_units(sl)
