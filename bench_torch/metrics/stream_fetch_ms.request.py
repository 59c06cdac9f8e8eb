"""Streamed program: ms of the `aegis.stream_fetch` spans (the host's wait
for each group of pass-2 slabs and their device-to-host copy), mean a
request; None on a program without the span."""

from bench_torch import stream_readers


def read(sl):
    return stream_readers.fetch_ms(sl)
