"""Seconds from the run's start to the end of its warm-up: the process's
imports, the CUDA context, the takes, the builds (on a checkout's first
run), the server or engine and one item of every shape the cell sends."""


def value(run):
    return run["setup_s"]
