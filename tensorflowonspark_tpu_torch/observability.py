"""Observability: health-event log and goodput accounting.

Port of the two pieces of ``tensorflowonspark_tpu/observability.py`` that
the node harness and the health monitor use: :class:`EventLog` (the
JSONL stream of cluster lifecycle/health events) and
:class:`GoodputRecorder` (wall time split into productive step time vs
init/data/idle).  TensorBoard spawning and profiler wiring are not ported
yet (ROADMAP queue A).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ health events

class EventLog:
    """Append-only JSONL stream of cluster lifecycle/health events.

    The reference surfaced executor failures through the Spark UI/event
    log; this is the rebuild's equivalent record.  One JSON object per
    line, each stamped with the writer's ``time.time()`` — the
    :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` writes
    ``monitor_started`` / ``crash`` / ``hang`` / ``preemption`` / ``abort``
    events here (default path: ``<working_dir>/health_events.jsonl``), and
    ``scripts/bench_recovery.py`` reads the timestamps back for
    detection-latency accounting.  Line-buffered append, so a post-mortem
    sees every event the driver managed to classify before dying.
    """

    def __init__(self, path: str, echo: bool = True):
        """``echo=False`` silences the per-event INFO log line — required
        for per-request/per-span streams (serving audit, tracing) whose
        emit rate would flood the process log."""
        self.path = path
        self._echo = echo
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._lock = threading.Lock()
        self._write_failed = False

    def emit(self, kind: str, **fields) -> dict:
        """Append one event.  Safe after :meth:`close` (and after the fd
        is otherwise gone): a late monitor-thread emit into a closed
        line-buffered file degrades to a one-time logged warning instead
        of a ``ValueError`` out of the writer thread.  Later emits still
        attempt the write (a transient failure — brief ENOSPC — may
        clear), but only the first failure warns."""
        rec = {"t": time.time(), "kind": kind, **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            try:
                self._f.write(line)
            except (ValueError, OSError, AttributeError) as e:
                # ValueError: write-after-close; OSError: fd gone
                if not self._write_failed:
                    self._write_failed = True
                    logger.warning(
                        "event log %s is unwritable (%s); dropped %r — "
                        "later writes are retried silently", self.path, e,
                        kind)
                return rec
        if self._echo:
            logger.info("health event: %s %s", kind, fields or "")
        return rec

    def close(self) -> None:
        with self._lock, contextlib.suppress(OSError, ValueError):
            self._f.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse an event file back into records (bench/test helper).

        Tolerates malformed lines: a driver killed mid-``emit`` leaves a
        truncated final line — cut mid-payload, mid-UTF-8 sequence, or
        before its newline — and a post-mortem read that raised on it
        would lose every GOOD record in the file.  The file is read as
        bytes and decoded per line (a text-mode iterator raises
        ``UnicodeDecodeError`` on a torn multibyte tail and drops every
        line after it); bad lines are skipped with a warning, intact
        lines before AND after still come back."""
        out: list[dict] = []
        with open(path, "rb") as f:
            data = f.read()
        for lineno, raw in enumerate(data.split(b"\n"), 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                out.append(json.loads(raw.decode("utf-8")))
            except (UnicodeDecodeError, json.JSONDecodeError):
                logger.warning(
                    "skipping malformed event at %s:%d (truncated by a "
                    "mid-write death?): %.80r", path, lineno, raw)
        return out


class GoodputRecorder:
    """Wall-clock accounting: productive step time vs everything else.

    Categories follow the badput taxonomy: ``init`` (bootstrap + compile),
    ``checkpoint`` (save/restore stalls), ``data`` (feed waits), ``step``
    (productive compute).  Unattributed wall time counts as ``idle``.

        rec = GoodputRecorder()
        with rec.time("init"): state = make_state()
        while ...:
            with rec.time("data"): batch = feed.next_batch(...)
            with rec.time("step"): state, _ = train_step(state, batch)
        rec.summary()  # {'goodput': 0.87, 'wall_secs': ..., 'secs': {...}}
    """

    PRODUCTIVE = ("step",)

    def __init__(self):
        self._t0 = time.monotonic()
        self._secs: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, category: str):
        start = time.monotonic()
        try:
            yield
        finally:
            self._secs[category] += time.monotonic() - start
            self._counts[category] += 1

    def record(self, category: str, secs: float, count: bool = True) -> None:
        self._secs[category] += secs
        if count:
            self._counts[category] += 1

    def summary(self) -> dict:
        wall = time.monotonic() - self._t0
        attributed = sum(self._secs.values())
        secs = dict(self._secs)
        secs["idle"] = max(0.0, wall - attributed)
        productive = sum(self._secs[c] for c in self.PRODUCTIVE)
        return {
            "wall_secs": wall,
            "goodput": productive / wall if wall > 0 else 0.0,
            "secs": secs,
            "counts": dict(self._counts),
        }

    def write(self, path: str) -> dict:
        """Write the summary as one JSON file (per-host goodput roll-up)."""
        s = self.summary()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(s, f, indent=2)
        return s
