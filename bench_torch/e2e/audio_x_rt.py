"""Seconds of audio transcribed in the window over the window's wall
seconds: all the work over all the time, so a stall shows."""

from bench_torch import stats


def value(run):
    return stats.rate(sum(it["audio_s"] for it in run["items"] if it["ok"]),
                      run["window_s"])
