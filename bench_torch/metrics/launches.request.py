"""Device programs: device operations (kernels and copies) of the traced
slice, a request."""

from bench_torch import readers


def read(sl):
    return readers.ops_per_unit(sl)
