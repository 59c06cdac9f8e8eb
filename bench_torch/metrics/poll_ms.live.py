"""Live transcriber, host poll: ms of the benchmark's span around
poll_events(), mean a chunk."""

from bench_torch import readers


def read(sl):
    return readers.mean_span_ms(sl, "poll")
