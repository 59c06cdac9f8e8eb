"""Host events and MIDI: ms of the program's `aegis.fin_harmonic` spans
(key detection, scale filter, chord context, the Main / Safe split), mean a
folder track; None on a program without the span."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "aegis.fin_harmonic")
