"""Host events and MIDI: ms of the folder's `folder.midi` spans (one MIDI
file written), mean a folder track; None on a program without the span."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "folder.midi")
