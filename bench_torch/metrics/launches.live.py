"""Device programs: device operations (kernels and copies) of the traced
slice, a chunk."""

from bench_torch import readers


def read(sl):
    return readers.ops_per_unit(sl)
