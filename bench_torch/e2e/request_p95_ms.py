"""95th percentile (nearest rank) of every completed request's client
wall time in the window, ms: upload start to the analysis's last byte."""

from bench_torch import stats


def value(run):
    return stats.percentile([it["ms"] for it in run["items"] if it["ok"]], 95)
