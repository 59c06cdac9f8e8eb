"""Device programs: `aegis.live_graph` spans (one a replay of the captured
tile program) per chunk; equal to `tiles.live` where every tile replays."""

from bench_torch import program_spans


def read(sl):
    return program_spans.count_per_unit(sl, "aegis.live_graph")
