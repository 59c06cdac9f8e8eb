"""Live transcriber: ms of the program's `live.poll` spans (the events of
the rows so far), mean a chunk."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.spans_ms(sl, "live.poll")
