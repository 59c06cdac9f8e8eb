"""Viterbi kernels: the forward pass's least time from the slice's decodes
at the configuration's (n, w) over the device time of
`viterbi_fwd_wide_kernel` alone (%); None where that kernel did not run."""

from bench_torch import viterbi_readers


def read(sl):
    return viterbi_readers.wide_roofline_pct(sl)
