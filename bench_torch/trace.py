"""The traced slice: ``torch.profiler`` over a fixed number of the cell's
items (requests, tracks), read as raw kineto events in the pattern of
``chip_smoke.py::profile_kernels``: one item runs first inside the profiler
and is left out by its time stamps (a tracing session may lose its first
device events); the slice is marked by a range of the benchmark's own,
whose start also ties the host clock of the benchmark's spans
(``time.perf_counter``, shared by the client process) to the trace's."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from bench_torch import stats

MARK = "bench_torch.slice"


@dataclasses.dataclass
class Slice:
    """What the per-layer readers read.  Times in ns on the trace's clock."""
    ops: List[Tuple[str, float, float]]     # device operations in the slice
    t0: float
    t1: float
    items: List[Dict]                       # the slice's items, t0/t1 in ns
    spans: List[Tuple[str, float, float]]   # the benchmark's spans
    cfg: Dict

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return stats.covered(stats.clip([(s, e) for _, s, e in self.ops],
                                        self.t0, self.t1)) / 1e9


def run(load, n: int, cuda: bool) -> Slice:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with torch.profiler.profile(activities=acts) as prof:
        load.traced(n, warm=True)
        sync()
        with torch.profiler.record_function(MARK):
            h0 = time.perf_counter()
            items = load.traced(n, warm=False)
            sync()
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    dev = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events
                if e.name() == MARK and e.device_type() != dev)
    m0, m1 = float(mark.start_ns()), float(mark.end_ns())

    def ns(pc: float) -> float:
        return m0 + (pc - h0) * 1e9

    ops = [(e.name(), float(e.start_ns()),
            float(e.start_ns() + e.duration_ns()))
           for e in events
           if e.device_type() == dev and not e.is_user_annotation()
           and m0 <= e.start_ns() <= m1]
    items = [dict(it, t0=ns(it["t0"]), t1=ns(it["t1"])) for it in items]
    spans = [(label, ns(a), ns(b)) for label, a, b in load.spans]
    return Slice(ops=ops, t0=m0, t1=m1, items=items, spans=spans,
                 cfg=load.cfg)


def breakdown(sl: Slice, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost span of the
    benchmark's that was open at its middle ("outside_spans" where none
    was: the client, the HTTP exchange, the harness)."""
    by_name: Dict[str, float] = {}
    for name, s, e in sl.ops:
        key = name if len(name) <= 160 else name[:157] + "..."
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = stats.gaps([(s, e) for _, s, e in sl.ops], sl.t0, sl.t1)
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [(s, label) for label, s, e in sl.spans if s <= mid <= e]
        named.append([max(open_)[1] if open_ else "outside_spans",
                      (b - a) / 1e9])
    named.sort(key=lambda x: -x[1])
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": named[:top]}
