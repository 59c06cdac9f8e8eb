"""Viterbi kernels: launches of the decode's kernels (the names of
``viterbi_kernels.json``) in the traced slice, a request; 0 on a path that
bypasses the decode."""

from bench_torch import readers


def read(sl):
    return readers.kernel_launches_per_unit(sl)
