"""Streamed program: ms of the `aegis.stream_slab` spans (pass 2's slab
dispatches, one a slab), mean a request; None on a fused request or a
program without the span."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "aegis.stream_slab")
