"""95th percentile (nearest rank) of every chunk's wait in the window, ms:
feed(chunk) + poll_events(), from the chunk's arrival to its events."""

from bench_torch import stats


def value(run):
    return stats.percentile([it["ms"] for it in run["items"] if it["ok"]], 95)
