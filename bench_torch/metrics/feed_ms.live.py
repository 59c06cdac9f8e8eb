"""Live transcriber: ms of the benchmark's span around feed(chunk), mean a
chunk."""

from bench_torch import readers


def read(sl):
    return readers.mean_span_ms(sl, "feed")
