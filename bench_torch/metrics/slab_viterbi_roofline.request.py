"""Viterbi kernels: the decode's least time at the (B, T) the program's
`aegis.viterbi` spans report (a slab's B = 16 tiles of T = 1 152 frames)
over the decode kernels' device time (%); None without the spans."""

from bench_torch import stream_readers


def read(sl):
    return stream_readers.decode_roofline_pct(sl)
