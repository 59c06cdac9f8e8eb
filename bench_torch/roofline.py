"""The yardstick of the kernels: published peaks of the card and the
operations and bytes of the pYIN Viterbi decode, counted from the decode's
shape (B sequences of T frames over n pitch states, band half-width w).

``decode_bound_s`` is a copy of ``chip_smoke.py::kernel_bounds`` (forward
and backtrace), so that no later change to the program moves it.  The
count follows the decode, not the kernels that implement it: each input
byte read once, each output byte written once.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
# (a card set lower runs slower under load; run.py prints the card's limit
# beside every result).
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3
N_SMS = 132


def pitch_grid(pyin: Dict, sample_rate: int, hop_length: int) -> Tuple[int, int]:
    """(n, w): the pitch states and the band half-width of the decode, by
    the formulas of ``aegis_tpu_torch/config.py::PyinConfig`` from the
    configuration's own numbers."""
    nbps = int(round(1.0 / pyin["resolution"]))
    n = int(math.floor(12 * nbps * math.log2(pyin["fmax"] / pyin["fmin"]))) + 1
    w = int(round(pyin["max_transition_rate"] * 12 * nbps * hop_length
                  / sample_rate)) + 1
    return n, w


def forward_bound(B: int, T: int, n: int, w: int) -> Tuple[float, float]:
    """(operations, bytes) of the forward pass: an add and a compare-select
    per in-band pair and chain a step; the observations, the class table,
    the backpointers and the last delta."""
    step_ops = 4 * (n * (2 * w + 1) - w * (w + 1))
    ops = B * (T - 1) * step_ops
    n_cls = n if n < 2 * w + 1 else w + 1
    nbytes = 4 * (B * T * n + B * T + n_cls * (w + 1)
                  + 2 * B * T * n + 2 * B * n)
    return float(ops), float(nbytes)


def backtrace_bound(B: int, T: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of the backtrace: the final delta, then one
    backpointer read and one state written a frame."""
    return float(B * (2 * n + T)), float(4 * B * (2 * n + 2 * T))


def seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the memory rate."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def decode_bound_s(decodes: Iterable[Tuple[int, int]], n: int, w: int) -> float:
    """Summed least time of the forward and backtrace kernels over the
    decodes (B, T) of a traced slice."""
    total = 0.0
    for B, T in decodes:
        total += seconds(*forward_bound(B, T, n, w))
        total += seconds(*backtrace_bound(B, T, n))
    return total
