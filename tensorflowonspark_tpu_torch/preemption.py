"""Preemption handling: turn SIGTERM into a checkpoint + graceful stop.

Port of ``tensorflowonspark_tpu/preemption.py``, copied.  The port's
node harness registers its heartbeat reporter here, and
``resnet_train.map_fun`` trains under a :class:`PreemptionGuard`.

The reference's recovery model is whole-job restart + resume from
checkpoints (SURVEY.md §5 "no elasticity"), and it relies on Spark/YARN to
notice dead executors.  On cloud accelerators the dominant failure is *planned*: preemptible
/ spot VMs get a SIGTERM with a grace window before the slice is
reclaimed.  Catching it and writing one final checkpoint converts "lose the
work since the last save" into "lose nothing" — the restart path
(``cluster.run_with_recovery`` or a scheduler relaunch) then resumes from
that step via the normal ``model_dir`` contract.

:class:`PreemptionGuard` is a context manager that latches the signal
instead of dying mid-step; pollers (``Estimator.train``, or any user
``map_fun`` loop via ``guard.preempted``) finish the in-flight step, save,
and return cleanly.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading

logger = logging.getLogger(__name__)

# Process-wide latch: preemption is a fact about the PROCESS, not about one
# guard instance — a training loop that re-enters train() after the signal
# must still see it (the OS will follow up with SIGKILL).
_PREEMPTED = threading.Event()

# Observers notified (once, from the signal handler's thread) when the latch
# first sets.  The node harness registers the heartbeat reporter here so the
# driver's ClusterMonitor sees phase 'preempted' and classifies a
# SIGTERM-shaped exit as a preemption rather than a crash (health.py).
# Deliberately lockless: the notifier runs inside the signal handler, which
# executes on the main thread and can interrupt that same thread mid-
# register — holding any lock here would self-deadlock.  CPython list
# append/snapshot are atomic under the GIL, which is all that's needed.
_CALLBACKS: list = []


def is_preempted() -> bool:
    """True once any PreemptionGuard in this process has seen its signal."""
    return _PREEMPTED.is_set()


def reset() -> None:
    """Clear the process-wide latch (tests / deliberate in-process restart)."""
    _PREEMPTED.clear()


class _Once:
    """Fire-at-most-once wrapper, closing the register-time race where the
    signal lands between a callback's append and its latched-already check
    (both paths would otherwise run it)."""

    __slots__ = ("cb", "fired")

    def __init__(self, cb):
        self.cb = cb
        self.fired = False

    def run(self) -> None:
        if self.fired:
            return
        self.fired = True
        try:
            self.cb()
        except Exception:  # observer bugs must not break signal handling
            logger.exception("preemption callback failed")


def on_preempted(callback) -> None:
    """Register ``callback()`` to run (at most once) when this process's
    latch sets; runs immediately if it already has.  Callbacks must be
    quick, must not raise, and must not acquire non-reentrant locks the
    interrupted code could hold (they execute inside the signal handler)."""
    entry = _Once(callback)
    _CALLBACKS.append(entry)
    if _PREEMPTED.is_set():
        entry.run()


def remove_on_preempted(callback) -> None:
    for entry in list(_CALLBACKS):
        if entry.cb is callback:
            with contextlib.suppress(ValueError):
                _CALLBACKS.remove(entry)


def _notify() -> None:
    for entry in list(_CALLBACKS):
        entry.run()


class PreemptionGuard:
    """Latches termination signals while active.

    Usage::

        with PreemptionGuard() as guard:
            for batch in data:
                state, _ = step(state, batch)
                if guard.preempted:
                    ckpt.save(step_no, state, force=True)
                    break

    Only the main thread can install signal handlers; constructed off the
    main thread (e.g. inside a worker's feeder thread) the guard degrades
    to an inert flag that is never set, rather than raising.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._active = False

    # -- context manager ------------------------------------------------
    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            logger.warning("PreemptionGuard: not on the main thread; "
                           "signals will not be intercepted")
            return self
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._active = True
        return self

    def __exit__(self, *exc):
        if self._active:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._previous.clear()
            self._active = False

    # -- signal path ----------------------------------------------------
    def _handle(self, signum, frame):
        logger.warning("PreemptionGuard: received signal %d; requesting "
                       "graceful stop", signum)
        self._event.set()
        first = not _PREEMPTED.is_set()
        _PREEMPTED.set()
        if first:
            _notify()

    @property
    def preempted(self) -> bool:
        return self._event.is_set() or _PREEMPTED.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        # wait on the process-wide latch: every handler sets both events,
        # and a latch set by an EARLIER guard must not leave a fresh
        # guard's wait() sleeping through the reclaim grace window
        return _PREEMPTED.wait(timeout) or self._event.is_set()
