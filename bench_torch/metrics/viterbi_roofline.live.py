"""Viterbi kernels: the decode's least time from its shapes over the decode
kernels' device time (%), over a slice of chunks."""

from bench_torch import readers


def read(sl):
    return readers.viterbi_roofline_pct(sl)
