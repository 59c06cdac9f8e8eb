"""Engine facade: ms inside the configuration's perception call (the span
"perception"), mean a request."""

from bench_torch import readers


def read(sl):
    return readers.mean_span_ms(sl, "perception")
