"""REST server: ms of the HTTP exchange's `serve.read` (the query parse and
the body read) and `serve.write` (status, headers and body) spans, mean a
request (its upload and its analysis); None on a program without them."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.http_io_ms(sl)
