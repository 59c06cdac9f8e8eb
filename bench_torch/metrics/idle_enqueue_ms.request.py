"""Device: ms in which no device operation ran while `aegis.enqueue` was
open, mean a request: the launch-bound loss of the fused program."""

from bench_torch import program_spans


def read(sl):
    return program_spans.idle_inside_ms(sl, "aegis.enqueue")
