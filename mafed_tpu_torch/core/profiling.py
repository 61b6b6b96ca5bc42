"""Tracing and step timing (counterpart of mafed_tpu/core/profiling.py).

`trace(profile_dir)` captures a torch.profiler trace of the host and the
card into profile_dir as a Chrome trace (open it in chrome://tracing or
Perfetto); `annotate(name)` is a named region in it; `StepTimer` measures
throughput after synchronising the device its results live on, since CUDA
work is asynchronous and a host clock without a synchronise measures the
enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mafed_tpu_torch.core.logging import LOGGER

TRACE_FILE = "trace.json"


class Trace:
    """A torch.profiler capture written to <profile_dir>/trace.json at stop()."""

    def __init__(self, profile_dir: str) -> None:
        self.profile_dir = profile_dir
        self.path = os.path.join(profile_dir, TRACE_FILE)
        cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        self._prof = profile(activities=[ProfilerActivity.CPU] + cuda)

    def start(self) -> "Trace":
        LOGGER.info("capturing profiler trace -> %s", self.path)
        self._prof.start()
        return self

    def stop(self) -> str:
        """Stop the capture, synchronising the card first so that its
        queued work lands in the trace; write the trace and return its path."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        LOGGER.info("profiler trace written to %s", self.path)
        return self.path


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[Optional[Trace]]:
    """Capture a trace into profile_dir (no-op when None or empty)."""
    if not profile_dir:
        yield None
        return
    capture = Trace(profile_dir).start()
    try:
        yield capture
    finally:
        capture.stop()


def annotate(name: str):
    """Named region visible in the trace viewer."""
    return record_function(name)


class StepTimer:
    """Throughput meter that synchronises the device before reading the clock."""

    def __init__(self) -> None:
        self._start: Optional[float] = None
        self._items = 0

    def start(self) -> None:
        self._start = time.perf_counter()
        self._items = 0

    def tick(self, n_items: int) -> None:
        self._items += n_items

    def stop(self, sync_on: Optional[torch.Tensor] = None) -> float:
        """Items per second; with `sync_on`, a tensor on the card, waits for
        that device's queued work before reading the clock."""
        if sync_on is not None and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        elapsed = time.perf_counter() - (self._start or time.perf_counter())
        return self._items / max(elapsed, 1e-9)
