"""Live transcriber: ms of the program's `live.feed` spans (the tiles a
chunk completes, enqueued and fetched), mean a chunk."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "live.feed")
