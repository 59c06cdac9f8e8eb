"""Device programs: `aegis.fused_graph` spans (one a replay of the captured
fused program) per folder track; None on a program without the span."""

from bench_torch import program_spans


def read(sl):
    return program_spans.count_per_unit(sl, "aegis.fused_graph")
