"""Observability: health-event log, TensorBoard scalars, goodput accounting.

Port of the pieces of ``tensorflowonspark_tpu/observability.py`` that the
node harness, the health monitor and the estimator use: :class:`EventLog`
(the JSONL stream of cluster lifecycle/health events),
:class:`SummaryWriter` (TensorBoard event files, with
:func:`read_scalars` to read them back) and :class:`GoodputRecorder`
(wall time split into productive step time vs init/data/idle), and
:class:`LatencyHistogram` (the serving tier's TTFT/end-to-end
percentiles).  TensorBoard spawning and the profiler helpers are not
ported yet (ROADMAP A2r).
"""

from __future__ import annotations

import contextlib
import itertools
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


# ------------------------------------------------------ latency histogram

class LatencyHistogram:
    """Latency percentile accumulator (p50/p95/p99) with a lock-free
    hot path and a **bounded** sample reservoir.

    ``record`` costs one ``itertools.count`` tick plus one list
    append/assign — all GIL-atomic, no lock — so request threads never
    contend to record a sample (the serving frontend records TTFT/e2e
    from many connection threads at once).  The reservoir is a ring of
    the most recent ``cap`` samples (default 4096): a long-lived serving
    frontend at millions-of-users scale must not grow a sample list
    forever, and recency is the window an operator actually wants
    percentiles over.  Readers take a snapshot copy (GIL-atomic slice)
    and sort it; percentile reads are O(cap log cap) off the hot path.
    Percentiles use the nearest-rank method on the retained window, so
    every reported value is a latency that actually occurred;
    ``summary()['count']`` stays the TOTAL recorded count.
    """

    DEFAULT_CAP = 4096

    def __init__(self, cap: int = DEFAULT_CAP):
        self._cap = max(1, int(cap))
        self._samples: list[float] = []
        self._ids = itertools.count()   # thread-safe total-count source
        self._count = 0

    def record(self, secs: float) -> None:
        i = next(self._ids)
        if i >= self._count:            # monotonic, benign-race update
            self._count = i + 1
        v = float(secs)
        s = self._samples
        n = len(s)
        if n >= self._cap:
            # the list never shrinks, so i % n is always in range even
            # if a fill-phase straggler appends concurrently; indexing
            # by the ACTUAL length keeps every slot reachable
            s[i % n] = v
        else:
            # fill phase: racing threads may overshoot cap by at most
            # one slot each (bounded, and still part of the ring above)
            s.append(v)

    def __len__(self) -> int:
        """Total samples recorded (retained window is ``min(len, cap)``)."""
        return max(len(self._samples), self._count)

    @staticmethod
    def _rank(snap: list, q: float):
        """Nearest-rank pick from a sorted snapshot (``ceil(q/100*n)``-th
        sample, 1-based, clamped)."""
        n = len(snap)
        return snap[min(n, int(max(1, -(-n * q // 100)))) - 1]

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile ``q`` in [0, 100]; None when empty."""
        snap = sorted(self._samples)
        return self._rank(snap, q) if snap else None

    def window_summary(self, since_count: int) -> dict:
        """:meth:`summary` restricted to the samples recorded AFTER the
        first ``since_count`` — the canary-gate window: a baseline
        snapshot's total ``count`` feeds back in, so the gate compares
        bake-window latencies and is never biased by history the other
        side doesn't share (warm-up compiles in the incumbent's
        cumulative percentiles were exactly that bias).  Exact while
        the reservoir has not wrapped (total <= cap — the gate-scale
        case); after a wrap the retained recent ring is the best
        available approximation of the window."""
        total = len(self)
        n = max(0, total - max(0, int(since_count)))
        snap = list(self._samples)
        if n and total <= len(snap):
            # no wrap yet: the list is still in append order
            snap = snap[total - n:]
        if n == 0 or not snap:
            return {"count": 0, "mean_secs": None, "p50_secs": None,
                    "p95_secs": None, "p99_secs": None, "max_secs": None}
        snap.sort()
        return {"count": n,
                "mean_secs": sum(snap) / len(snap),
                "p50_secs": self._rank(snap, 50),
                "p95_secs": self._rank(snap, 95),
                "p99_secs": self._rank(snap, 99),
                "max_secs": snap[-1]}

    def summary(self) -> dict:
        """``{count, mean_secs, p50_secs, p95_secs, p99_secs, max_secs}``
        (None-valued stats when no sample was recorded).  ``count`` is
        the total ever recorded; the other stats cover the retained
        window (the most recent ``cap`` samples)."""
        snap = sorted(self._samples)
        n = len(snap)
        if not n:
            return {"count": 0, "mean_secs": None, "p50_secs": None,
                    "p95_secs": None, "p99_secs": None, "max_secs": None}
        return {"count": len(self), "mean_secs": sum(snap) / n,
                "p50_secs": self._rank(snap, 50),
                "p95_secs": self._rank(snap, 95),
                "p99_secs": self._rank(snap, 99), "max_secs": snap[-1]}


# ------------------------------------------------------- summary writing

class SummaryWriter:
    """TensorBoard scalar writer with zero TF dependency.

    TensorBoard event files are TFRecord streams of ``Event`` protos; this
    writer hand-encodes the ``Event``/``Summary`` wire format (the same
    approach as :mod:`.example_proto`) and frames records with the
    package's own :class:`~.tfrecord.TFRecordWriter` (CRC32C via the C++
    codec).  Byte-compatibility with TensorBoard's reader is pinned by
    test against the TF event parser; :func:`read_scalars` reads the
    scalars back without it.

    The reference delegated training curves to Keras/TF summary callbacks
    (SURVEY.md §5); here the estimator writes them natively::

        with SummaryWriter(logdir) as w:
            w.scalar("loss", 0.5, step=10)
            w.scalars({"loss": 0.4, "acc": 0.9}, step=20)
    """

    _FILE_VERSION = "brain.Event:2"

    def __init__(self, logdir: str, filename_suffix: str = ""):
        import socket

        from tensorflowonspark_tpu_torch import filesystem as fsutil
        from tensorflowonspark_tpu_torch.tfrecord import TFRecordWriter

        # scheme-aware: logdir may be gs:// etc., like the checkpoint dir
        fsutil.makedirs(logdir)
        name = (f"events.out.tfevents.{time.time():.6f}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = fsutil.join(logdir, name)
        self._w = TFRecordWriter(self.path)
        self._w.write(self._encode_event(file_version=self._FILE_VERSION))

    @staticmethod
    def _encode_event(step: int | None = None, summary: bytes | None = None,
                      file_version: str | None = None) -> bytes:
        import struct

        from tensorflowonspark_tpu_torch.example_proto import (_tag, _write_len_field,
                                                               _write_varint)

        out = bytearray()
        _write_varint(out, _tag(1, 1))                 # wall_time: double
        out.extend(struct.pack("<d", time.time()))
        if step is not None:
            _write_varint(out, _tag(2, 0))             # step: int64
            _write_varint(out, int(step))
        if file_version is not None:
            _write_len_field(out, 3, file_version.encode())
        if summary is not None:
            _write_len_field(out, 5, summary)
        return bytes(out)

    @staticmethod
    def _encode_summary(metrics: dict) -> bytes:
        import struct

        from tensorflowonspark_tpu_torch.example_proto import (_tag, _write_len_field,
                                                               _write_varint)

        out = bytearray()
        for tag_name, value in metrics.items():
            val = bytearray()
            _write_len_field(val, 1, str(tag_name).encode())  # Value.tag
            _write_varint(val, _tag(2, 5))                    # simple_value
            val.extend(struct.pack("<f", float(value)))
            _write_len_field(out, 1, bytes(val))              # Summary.value
        return bytes(out)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars({tag: value}, step)

    def scalars(self, metrics: dict, step: int) -> None:
        """Write a dict of scalars as one event at ``step`` and flush —
        a live TensorBoard should see the point now, and a preempted
        process must not lose its buffered curves."""
        self._w.write(self._encode_event(
            step=step, summary=self._encode_summary(metrics)))
        self._w.flush()

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(path: str) -> list[tuple[float, int, str, float]]:
    """``(wall_time, step, tag, value)`` for every scalar of the event file
    ``path`` that :class:`SummaryWriter` (or TensorBoard's writer) wrote,
    in file order: the ``Event``/``Summary``/``Value`` wire format decoded
    by hand, as the writer encodes it.  Other fields are skipped."""
    import struct

    from tensorflowonspark_tpu_torch.example_proto import _read_varint, _skip_field
    from tensorflowonspark_tpu_torch.tfrecord import read_records

    def fields(buf: bytes):
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            if wire == 2:
                n, pos = _read_varint(buf, pos)
                yield num, wire, buf[pos:pos + n]
                pos += n
            elif wire == 0:
                v, pos = _read_varint(buf, pos)
                yield num, wire, v
            elif wire in (1, 5):
                width = 8 if wire == 1 else 4
                yield num, wire, buf[pos:pos + width]
                pos += width
            else:
                pos = _skip_field(buf, pos, wire)

    out = []
    for rec in read_records(path):
        wall, step, summary = 0.0, 0, None
        for num, wire, v in fields(rec):
            if num == 1 and wire == 1:
                wall = struct.unpack("<d", v)[0]
            elif num == 2 and wire == 0:
                step = v
            elif num == 5 and wire == 2:
                summary = v
        for num, wire, value in fields(summary or b""):
            if num != 1 or wire != 2:
                continue
            tag, scalar = None, None
            for vnum, vwire, v in fields(value):
                if vnum == 1 and vwire == 2:
                    tag = v.decode()
                elif vnum == 2 and vwire == 5:
                    scalar = struct.unpack("<f", v)[0]
            if tag is not None and scalar is not None:
                out.append((wall, step, tag, scalar))
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
