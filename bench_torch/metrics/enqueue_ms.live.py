"""Device programs: ms of the `aegis.live_tile` spans (the tile program's
launches), mean a chunk."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.live_tile")
