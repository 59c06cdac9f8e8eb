"""Device programs: ms of the folder's `aegis.fetch` spans, mean a track:
the device time that dispatching every track ahead does not hide."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.fetch")
