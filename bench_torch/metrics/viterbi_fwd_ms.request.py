"""Viterbi kernels: device ms of the forward pass (`viterbi_fwd_kernel`
plus `viterbi_fwd_wide_kernel`), a request."""

from bench_torch import viterbi_readers


def read(sl):
    return viterbi_readers.forward_ms_per_unit(sl)
