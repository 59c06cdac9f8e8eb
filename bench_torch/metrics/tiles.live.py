"""Live transcriber: `aegis.live_tile` spans (one a tile program run) per
chunk."""

from bench_torch import program_spans


def read(sl):
    return program_spans.count_per_unit(sl, "aegis.live_tile")
