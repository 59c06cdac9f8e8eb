"""Host events and MIDI: ms of the program's `aegis.fin_extract` spans (the
financial extractor: segmentation, ghost filter, harmonic context), mean a
folder track; None on a program without the span."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.fin_extract")
