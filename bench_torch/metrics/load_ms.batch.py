"""Engine facades: ms of the folder's `folder.load` spans (a track's
read and decode), mean a track."""

from bench_torch import program_spans


def read(sl):
    return program_spans.mean_ms(sl, "folder.load")
