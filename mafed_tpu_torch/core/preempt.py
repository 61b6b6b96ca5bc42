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

One process: the check is the local flag (the JAX package's
`sync_preemption_requested` reduces to it, and its
`reinstall_after_dist_init` has nothing to re-arm; both come with the
multi-process work, ROADMAP queue 1 item 1).
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

LOGGER = logging.getLogger("mafed_tpu_torch")

_FLAG = threading.Event()
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
    for s in signals:
        prev = signal.signal(s, _handler)
        if prev not in (None, _handler):
            _PREV_HANDLERS[s] = prev


def preemption_requested() -> bool:
    """True once a signal, or a request, has arrived."""
    if _FLAG.is_set():
        return True
    with _lock:
        return _TEST_COUNTDOWN is not None and _TEST_COUNTDOWN <= 0


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
