"""REST server: a request's client wall ms less the engine facade's perception
and extract spans, mean a request."""

from bench_torch import readers


def read(sl):
    return readers.mean_outside_ms(sl, ["perception", "extract"])
