"""Device: ms in which no device operation ran while `aegis.live_tile` was
open, mean a chunk: the launch-bound loss of the tile program."""

from bench_torch import program_spans


def read(sl):
    return program_spans.idle_inside_ms(sl, "aegis.live_tile")
