"""Host interpreter: ms of the program's `py.gc` spans (the interpreter's
collections, every generation), mean a folder track; 0.0 where none ran, None
on a program that records no collections."""

from bench_torch import idle_readers


def read(sl):
    return idle_readers.gc_ms(sl)
