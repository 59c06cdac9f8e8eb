"""Device programs: ms of the `aegis.enqueue` span (bucket pad, quantize,
pinned upload and the fused program's launches, up to the handle), mean a
request."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.enqueue")
