"""Device programs: `aegis.capture` spans (one a CUDA graph captured, fused
or live) per request; 0.0 where none started, None on a program without
the span recorder."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.captures(sl)
