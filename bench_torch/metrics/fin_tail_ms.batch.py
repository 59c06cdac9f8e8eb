"""Device programs: device ms of the financial tail (the guitar filters,
the trend stack, the confidences, the row packing), a folder track.  A
graph replay hides the program's `aegis.trend` span, so the tail is placed
by launch order: in each replay the operations after the boundary kernel
that `fin_tail_kernels.json` names, up to the replay's copy-out.  None
where the slice has no such kernel."""

import json
import os

from bench_torch import readers

with open(os.path.join(os.path.dirname(__file__),
                       "fin_tail_kernels.json")) as _f:
    _MARKS = json.load(_f)


def tail_ns(ops) -> float:
    """Device ns of the operations after each boundary kernel, up to the
    next operation whose name starts with the end mark."""
    total, inside = 0.0, False
    for name, s, e in sorted(ops, key=lambda op: op[1]):
        if _MARKS["boundary"] in name:
            inside = True
        elif inside and name.startswith(_MARKS["end"]):
            inside = False
        elif inside:
            total += e - s
    return total


def read(sl):
    if not sl.items or not any(_MARKS["boundary"] in name
                               for name, _, _ in sl.ops):
        return None
    return tail_ns(sl.ops) / 1e6 / readers.n_units(sl)
