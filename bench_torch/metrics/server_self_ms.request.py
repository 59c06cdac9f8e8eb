"""REST server: ms of each routed call's `serve.request` span less the
engine facades' spans under it (`aegis.*`), mean a request (its upload and
its analysis): the server's own host work, read inside the program."""

from bench_torch import program_spans


def read(sl):
    return program_spans.self_ms(sl, "serve.request", "aegis.")
