"""REST server: ms of the `serve.decode` span (the upload's WAV decode to
samples at the engine's rate), mean a request."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "serve.decode")
