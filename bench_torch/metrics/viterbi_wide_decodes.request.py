"""Viterbi kernels: the program's `aegis.viterbi` spans whose `kernel` is
`viterbi_fwd_wide_kernel`, a request; None on a program without the span."""

from bench_torch import viterbi_readers


def read(sl):
    return viterbi_readers.wide_decodes_per_unit(sl)
