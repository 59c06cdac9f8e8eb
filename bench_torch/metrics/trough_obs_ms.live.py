"""Device programs: device ms of `trough_obs_kernel` (csrc/trough_obs.cu:
the pYIN trough loop and the per-lag scatter as one launch), a chunk; None
where the slice ran no such kernel, as a program without it does."""

from bench_torch import readers, viterbi_readers

KERNEL = "trough_obs_kernel"


def read(sl):
    ns = viterbi_readers.kernel_ns(sl, KERNEL)
    if ns <= 0 or not sl.items:
        return None
    return ns / 1e6 / readers.n_units(sl)
