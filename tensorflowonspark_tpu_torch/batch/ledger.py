"""Durable per-shard progress: the JSONL ledger behind resumable predict.

The ledger is an append-only JSONL file (``progress.jsonl``) in the job's
output dir.  Every shard state transition is one fsync'd line::

    {"t": 1722…, "event": "attempt",  "attempt_note": "…"}
    {"t": …,     "event": "assigned", "key": "shard-00003", "worker": 1}
    {"t": …,     "event": "done",     "key": "shard-00003", "worker": 1,
     "count": 512, "path": "parts/shard-00003.tfrecord"}
    {"t": …,     "event": "requeued", "key": "shard-00007", "worker": 1}

``done`` is appended only *after* the shard's output part was committed by
the worker's atomic rename (:mod:`~tensorflowonspark_tpu_torch.batch.writer`), so
"in the ledger" implies "on disk".  The converse race — part committed,
driver killed before the ledger line — re-scores that one shard on resume,
which is safe because the rename overwrites the part idempotently.  Under
that ordering a restarted :class:`~tensorflowonspark_tpu_torch.batch.job.
BatchJob` replays the ledger and reprocesses **zero committed shards**.

:meth:`Replay.reprocessed_committed` exists for exactly that proof: the
bench (``python -m tensorflowonspark_tpu_torch.bench_batch``) fails itself if any committed shard is
ever assigned again.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

LEDGER_NAME = "progress.jsonl"

ASSIGNED = "assigned"
DONE = "done"
REQUEUED = "requeued"
ATTEMPT = "attempt"


class Replay:
    """Parsed view of one ledger file (see :meth:`ProgressLedger.replay`)."""

    def __init__(self, events: list[dict]):
        self.events = events
        self.committed: dict[str, dict] = {}   # key -> its done event
        self.attempts = 0
        reprocessed: set[str] = set()
        for e in events:
            kind, key = e.get("event"), e.get("key")
            if kind == ATTEMPT:
                self.attempts += 1
            elif kind == DONE and key:
                self.committed[key] = e
            elif kind == ASSIGNED and key and key in self.committed:
                reprocessed.add(key)
        #: committed shards that were later assigned again — the resume
        #: contract's failure mode; must stay empty
        self.reprocessed_committed = sorted(reprocessed)

    def done_at_attempt(self, attempt: int) -> set[str]:
        """Keys committed strictly before the 1-based ``attempt`` marker
        (what a restart at that attempt found already done)."""
        seen = 0
        out: set[str] = set()
        for e in self.events:
            if e.get("event") == ATTEMPT:
                seen += 1
                if seen >= attempt:
                    break
            elif e.get("event") == DONE and e.get("key"):
                out.add(e["key"])
        return out


class ProgressLedger:
    """Append-only shard-state ledger for one output dir.

    Thread-safe: the dispatcher's per-node collector threads all append
    through one lock, and each append is flushed + fsync'd before
    returning, so a committed ``done`` line survives a driver SIGKILL.
    """

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.path = os.path.join(output_dir, LEDGER_NAME)
        os.makedirs(output_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- append ------------------------------------------------------------
    def append(self, event: str, key: str | None = None, **fields) -> None:
        rec = {"t": time.time(), "event": event}
        if key is not None:
            rec["key"] = key
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            # exactly-once resume depends on fsync-before-release: a
            # DONE released before it is durable can double-commit a
            # shard after a driver restart
            os.fsync(self._f.fileno())  # tfos: ignore[blocking-under-lock]

    def attempt(self, **fields) -> None:
        """Mark the start of one dispatch attempt (restart boundary)."""
        self.append(ATTEMPT, **fields)

    def assigned(self, key: str, worker: int) -> None:
        self.append(ASSIGNED, key, worker=int(worker))

    def done(self, key: str, worker: int, count: int, path: str) -> None:
        self.append(DONE, key, worker=int(worker), count=int(count),
                    path=path)

    def requeued(self, key: str, worker: int) -> None:
        """A shard taken back from a dead worker, returned to pending."""
        self.append(REQUEUED, key, worker=int(worker))

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- replay ------------------------------------------------------------
    @classmethod
    def replay(cls, output_dir: str) -> Replay:
        """Parse the ledger (missing file = empty job).  Corrupt/truncated
        tail lines — a driver killed mid-append — are skipped with a
        warning, mirroring ``EventLog.read``."""
        path = os.path.join(output_dir, LEDGER_NAME)
        events: list[dict] = []
        if not os.path.exists(path):
            return Replay(events)
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    logger.warning("ledger %s: skipping corrupt line %d",
                                   path, lineno)
        return Replay(events)
