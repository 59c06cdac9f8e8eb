"""Device: ms in which no device operation ran and no span of the program
was open on any thread (spans that opened before the slice included), mean
a request: the idle time the program cannot place."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.unspanned_ms(sl)
