"""End-to-end request tracing: trace-ID propagation + timeline stitching.

Port of ``tensorflowonspark_tpu/tracing.py``: a copy; its metrics plane and
event log are the port's.

The serving tier's JSONL streams each record their own hop of a request's
life (admission and routing in ``serving_events.jsonl``, replica intake
and decode in the worker process, failures in ``health_events.jsonl``) —
but before this module there was no ID correlating them, so "why was
this request slow" had no answer.  Now:

- the frontend stamps every ``generate`` with a **trace id**
  (:func:`new_trace_id`, or a client-supplied one) that flows through
  :meth:`~tensorflowonspark_tpu_torch.serving.scheduler.ReplicaScheduler.
  submit`, the request message over the node queue/shm hop, replica
  intake, and the per-step token flushes;
- every scheduler event for the request (``request_admitted`` /
  ``request_routed`` / ``request_first_token`` / ``request_requeued`` /
  ``request_done`` / ``request_failed``) carries ``trace=<id>``, and the
  replica emits its own ``replica_intake`` / ``replica_first_token`` /
  ``replica_done`` spans into ``trace_events.jsonl`` in the cluster
  working dir (one shared file: line-buffered ``O_APPEND`` writes are
  atomic at these record sizes, so multi-process interleave is safe);
- :func:`stitch_trace` reconstructs one request's full timeline —
  admission → route → queue → prefill → first token → done, including
  requeue-failover hops — by merging the streams on the trace id, with
  untraced-but-relevant cluster failures (``replica_dead`` / ``crash`` /
  ``hang`` / ``preemption``) inside the request's time window folded in
  as context rows.  ``scripts/tfos_trace.py`` is the CLI.

Tracing obeys the same ``TFOS_NO_TELEMETRY=1`` kill switch as the
metrics plane (:mod:`~tensorflowonspark_tpu_torch.metrics`): disabled tracers
swallow every event.
"""

from __future__ import annotations

import logging
import os
import secrets
import threading

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch import observability

logger = logging.getLogger(__name__)

#: filename of the span stream inside a cluster working dir
TRACE_FILENAME = "trace_events.jsonl"

#: event kinds from the health/serving streams that explain a slow or
#: failed-over request even though they carry no trace id of their own
CONTEXT_KINDS = ("replica_dead", "crash", "hang", "preemption", "abort")

#: the JSONL streams stitch_trace merges, in working-dir-relative form
STREAMS = ("serving_events.jsonl", TRACE_FILENAME, "health_events.jsonl")


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id."""
    return secrets.token_hex(8)


class Tracer:
    """Span emitter for one process: appends ``{"t", "kind", "trace",
    ...}`` records to a ``trace_events.jsonl``.  Emission failures are
    absorbed by :class:`~tensorflowonspark_tpu_torch.observability.EventLog`'s
    post-close degrade — tracing must never take down serving."""

    def __init__(self, path: str | None):
        # echo=False: spans fire per request on the decode loop — they
        # must not print an INFO line each
        self._log = (observability.EventLog(path, echo=False)
                     if path and _metrics.telemetry_enabled() else None)

    @property
    def enabled(self) -> bool:
        return self._log is not None

    def event(self, kind: str, trace: str | None, **fields) -> None:
        if self._log is None or trace is None:
            return
        self._log.emit(kind, trace=trace, **fields)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None


_NULL_TRACER = Tracer(None)
_tracers: dict[str, Tracer] = {}
_tracers_lock = threading.Lock()


def tracer_for(working_dir: str | None) -> Tracer:
    """The process's tracer for ``working_dir`` (cached per dir; a null
    tracer when the dir is unset or telemetry is disabled)."""
    if not working_dir:
        return _NULL_TRACER
    key = os.path.abspath(working_dir)
    with _tracers_lock:
        tracer = _tracers.get(key)
        if tracer is None:
            try:
                tracer = Tracer(os.path.join(key, TRACE_FILENAME))
            except OSError as e:
                logger.warning("trace log unavailable at %s (%s); "
                               "tracing disabled for this process", key, e)
                tracer = _NULL_TRACER
            _tracers[key] = tracer
        return tracer


# -- stitching (the tfos_trace CLI core) -----------------------------------

def _read_streams(working_dir: str) -> list[dict]:
    records: list[dict] = []
    for name in STREAMS:
        path = os.path.join(working_dir, name)
        if os.path.exists(path):
            for rec in observability.EventLog.read(path):
                rec["_stream"] = name
                records.append(rec)
    return records


def list_traces(working_dir: str) -> dict[str, dict]:
    """``{trace_id: {"t0", "spans", "kinds"}}`` across the dir's streams
    (oldest-first: dict insertion order follows each trace's t0)."""
    by_trace: dict[str, dict] = {}
    for rec in sorted(_read_streams(working_dir),
                      key=lambda r: r.get("t", 0.0)):
        trace = rec.get("trace")
        if not trace:
            continue
        info = by_trace.setdefault(
            trace, {"t0": rec.get("t"), "spans": 0, "kinds": []})
        info["spans"] += 1
        if rec.get("kind") not in info["kinds"]:
            info["kinds"].append(rec.get("kind"))
    return by_trace


def stitch_trace(working_dir: str, trace_id: str,
                 context_slack: float = 1.0) -> list[dict]:
    """One request's merged timeline, time-sorted.

    Returns the trace's own records plus (marked ``"_context": True``)
    any :data:`CONTEXT_KINDS` event within ``context_slack`` seconds of
    the trace's [first, last] window — the replica kill that explains a
    requeue hop shows up in the same timeline.
    """
    records = _read_streams(working_dir)
    own = sorted((r for r in records if r.get("trace") == trace_id),
                 key=lambda r: r.get("t", 0.0))
    if not own:
        return []
    t0 = own[0].get("t", 0.0) - context_slack
    t1 = own[-1].get("t", 0.0) + context_slack
    context = [dict(r, _context=True) for r in records
               if r.get("trace") != trace_id
               and r.get("kind") in CONTEXT_KINDS
               and t0 <= r.get("t", 0.0) <= t1]
    return sorted(own + context, key=lambda r: r.get("t", 0.0))


def format_timeline(timeline: list[dict]) -> str:
    """Human-readable rendering of a :func:`stitch_trace` result:
    per-row offset from the first event, kind, and the useful fields."""
    if not timeline:
        return "(no events)"
    base = timeline[0].get("t", 0.0)
    skip = {"t", "kind", "trace", "_stream", "_context"}
    lines = []
    for rec in timeline:
        extras = " ".join(f"{k}={rec[k]}" for k in rec
                          if k not in skip and rec[k] is not None)
        mark = " [context]" if rec.get("_context") else ""
        lines.append(f"+{rec.get('t', 0.0) - base:8.3f}s  "
                     f"{rec.get('kind', '?'):<22s} "
                     f"({rec.get('_stream', '?')}){mark}  {extras}".rstrip())
    return "\n".join(lines)
