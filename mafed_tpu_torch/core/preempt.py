"""Cooperative preemption (counterpart of mafed_tpu/core/preempt.py): a clean
exit and an exact resume at the granularity of an optimizer update.

A preemptible machine gets SIGTERM with a short grace period. Here the
signal sets a flag; the task runner checks it at every update boundary,
saves a mid-epoch resume bundle (parameters, optimizer state and
`batches_done`, trainer/runner.py `fit`) and raises `Preempted`, which
exits with the conventional 128 + SIGTERM = 143 so a supervisor restarts
the job; the restart with --resume_from_checkpoint continues where it
stopped (the loader skips the batches already consumed of the seeded
epoch order).

Several ranks (core/dist.py): the save is collective, so every rank must
stop at the same update boundary although the signal may reach only some of
them. `sync_preemption_requested` takes the maximum of the local flags over
the ranks at every boundary, so a SIGTERM seen by one rank stops all of them
after the same update; one rank reads its local flag.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

import torch
import torch.distributed

LOGGER = logging.getLogger("mafed_tpu_torch")

_FLAG = threading.Event()
_INSTALLED = False
_PREV_HANDLERS: dict = {}
_TEST_COUNTDOWN: Optional[int] = None
_lock = threading.Lock()


class Preempted(SystemExit):
    """Raised at a clean update boundary after a preemption request: a
    SystemExit with code 143, so an uncaught one ends the process with that
    status and no traceback."""

    def __init__(self, message: str = "preempted") -> None:
        super().__init__(143)
        self.message = message


def _handler(signum, frame):
    _FLAG.set()
    LOGGER.warning("received signal %d: will save a resume bundle and exit at the next update boundary", signum)
    prev = _PREV_HANDLERS.get(signum)
    if callable(prev):
        prev(signum, frame)


def install_handlers(signals=(signal.SIGTERM,)) -> None:
    """Install the flag handler, chaining any previous handler. Main thread
    only (a restriction of the signal module); the CLI calls it once."""
    global _INSTALLED
    for s in signals:
        prev = signal.signal(s, _handler)
        if prev not in (None, _handler):
            _PREV_HANDLERS[s] = prev
    _INSTALLED = True


def reinstall_after_dist_init() -> None:
    """Re-arm the flag handler after the process group is joined, should the
    backend or its launcher have replaced it. A no-op unless
    `install_handlers` ran, and off the main thread."""
    if not _INSTALLED or threading.current_thread() is not threading.main_thread():
        return
    if signal.getsignal(signal.SIGTERM) is not _handler:
        install_handlers()


def preemption_requested() -> bool:
    """True once a signal, or a request, has arrived."""
    if _FLAG.is_set():
        return True
    with _lock:
        return _TEST_COUNTDOWN is not None and _TEST_COUNTDOWN <= 0


def sync_preemption_requested(step_id: int) -> bool:
    """The preemption check every rank agrees on at an update boundary: the
    local flag on one rank; on several, the maximum of the ranks' flags
    (one all-reduce), so all ranks stop at the same `step_id` if any saw
    the signal. The countdown of `request_preemption_after` ticks the same
    boundaries on every rank, so it needs no collective."""
    from mafed_tpu_torch.core import dist as D

    if D.process_count() == 1:
        return preemption_requested()
    with _lock:
        if _TEST_COUNTDOWN is not None and _TEST_COUNTDOWN <= 0:
            return True
    flag = torch.tensor([int(_FLAG.is_set())], dtype=torch.int32)
    torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX, group=D.host_group())
    if flag.item():
        LOGGER.warning("preemption agreed by every rank at update %d", step_id)
        return True
    return False


def tick_update() -> None:
    """Called by the runner once per applied optimizer update; drives
    `request_preemption_after`."""
    global _TEST_COUNTDOWN
    with _lock:
        if _TEST_COUNTDOWN is not None and _TEST_COUNTDOWN > 0:
            _TEST_COUNTDOWN -= 1


def request_preemption() -> None:
    """The programmatic equivalent of receiving SIGTERM."""
    _FLAG.set()


def request_preemption_after(n_updates: int) -> None:
    """Make `preemption_requested` true after n more applied updates: a
    deterministic stand-in for a signal arriving mid-epoch."""
    global _TEST_COUNTDOWN
    with _lock:
        _TEST_COUNTDOWN = int(n_updates)


def clear() -> None:
    """Reset all preemption state."""
    global _TEST_COUNTDOWN
    _FLAG.clear()
    with _lock:
        _TEST_COUNTDOWN = None
