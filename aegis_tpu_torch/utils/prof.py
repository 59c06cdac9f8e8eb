"""Phase tracing utilities (counterpart of ``aegis_tpu/utils/prof.py``).

Each pipeline phase is both a structured log record and a
``torch.profiler.record_function`` range, so a profiler trace of the card
carries the same phase names as the log.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from aegis_tpu_torch.utils.logging import get_logger

log = get_logger("prof")


@contextlib.contextmanager
def phase(name: str, quiet: bool = False) -> Iterator[None]:
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if not quiet:
        log.info(f"{name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Profile the host and, where there is one, the card while the body
    runs; the Chrome trace (``trace.json``, open in chrome://tracing or
    Perfetto) is written into ``log_dir`` when the body ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
