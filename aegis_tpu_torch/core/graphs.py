"""Device programs captured once as CUDA graphs and replayed.

The live tile program (``engine/realtime.py::_LiveGraph``) and the fused
program (``core/analyze.py::_FusedGraph``) are both run this way: the
program over static input tensors is run once eagerly on a side stream and
then captured on it (``CapturedProgram``), and every later call fills the
static inputs and replays the graph inside a turn of its ``Replays``, which
orders it after the previous replay's copies out.  A capture that fails
raises; nothing falls back to the eager program.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Iterator

import torch

from aegis_tpu_torch.core import pyin_cuda
from aegis_tpu_torch.utils.prof import phase

# one capture at a time in the process: the fused graphs of a card are
# warmed up and captured on one side stream, and PyTorch's caching
# allocator is not held to two captures at once on a device; a live
# session's first tile waits here while a fused key is captured
CAPTURE_LOCK = threading.Lock()


class Replays:
    """What serializes the replays of graphs that share static tensors or
    a memory pool: a lock, held from the copies into the static inputs to
    the copies out of the outputs, and an event after the last replay's
    copies out, which the next replay's copies in follow on the stream.
    With them the side stream the graphs are warmed up and captured on,
    and the memory pool they share (``shared_pool``; else each graph
    captures into a private pool of its own)."""

    def __init__(self, device: torch.device, shared_pool: bool = False):
        self.device = device
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
            self.pool = (torch.cuda.graph_pool_handle() if shared_pool
                         else None)
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()

    @contextlib.contextmanager
    def turn(self) -> Iterator[None]:
        """One replay's turn on the current stream: inside, the caller
        copies in, replays and copies out."""
        with self.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            stream.wait_event(self.done)
            yield
            self.done.record(stream)


class CapturedProgram:
    """``run()``, a device program over static tensors, captured once.

    It runs eagerly first, on the side stream of ``replays`` and in the
    order of their turns: that loads the Viterbi library, makes the cuBLAS
    and cuFFT handles and plans and fills the caching allocator, and its
    outputs (``first``, on the static inputs as they were filled) may
    answer the call that made the capture.  Then the capture on the same stream, in ``thread_local``
    mode, so that handler threads of the server may launch meanwhile; it
    neither synchronizes nor empties the allocator's cache (as
    ``torch.cuda.graph`` does), so the next capture's warm-up finds the
    blocks this one's left.  The Viterbi launches of the warm-up
    (``first_launched``) and of the capture (``launched``) are recorded,
    not counted, and the captured decodes' span attributes kept
    (``decodes``): each replay counts and spans them (``replay``)."""

    def __init__(self, run: Callable, replays: Replays):
        with torch.cuda.device(replays.device):
            current = torch.cuda.current_stream()
            side = replays.stream
            # in the replays' order: the graph's own replays, which other
            # threads may start once it is cached, rewrite the static
            # inputs that the warm-up reads
            with replays.lock:
                side.wait_stream(current)
                side.wait_event(replays.done)
                with torch.cuda.stream(side), \
                        pyin_cuda.recording_launches() as self.first_launched:
                    self.first = run()
                replays.done.record(side)
            current.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with pyin_cuda.recording_launches() as self.launched, \
                    pyin_cuda.recording_decodes() as self.decodes, \
                    torch.cuda.stream(side):
                self.graph.capture_begin(replays.pool,
                                         capture_error_mode="thread_local")
                try:
                    self.out = run()
                finally:
                    self.graph.capture_end()

    def take_first(self) -> Any:
        """The warm-up's outputs, once (None after): ready on the current
        stream, their launches counted as one call's."""
        first, self.first = self.first, None
        if first is None:
            return None
        stream = torch.cuda.current_stream()
        for t in (first if isinstance(first, tuple) else (first,)):
            # made on the side stream, read on this one
            t.record_stream(stream)
        pyin_cuda.count_launches(self.first_launched)
        return first

    def replay(self) -> None:
        """The graph's launch, with one ``aegis.viterbi`` span a captured
        decode while a profiler runs; the recorded launches counted."""
        self.graph.replay()
        for attrs in self.decodes:
            with phase("aegis.viterbi", **attrs):
                pass
        pyin_cuda.count_launches(self.launched)
