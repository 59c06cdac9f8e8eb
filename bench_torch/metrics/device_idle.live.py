"""Device: the share (%) of the traced slice of chunks in which no device
operation ran."""

from bench_torch import readers


def read(sl):
    return readers.idle_pct(sl)
