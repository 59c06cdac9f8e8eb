"""Device programs: ms of the `aegis.live_fetch` spans (the host's wait
for a tile's rows and their copy), mean a chunk."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.live_fetch")
