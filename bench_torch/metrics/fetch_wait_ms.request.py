"""Device programs: ms of the `aegis.fetch` span (the host's wait for the
card, the device-to-host copy and the unpack), mean a request."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.fetch")
