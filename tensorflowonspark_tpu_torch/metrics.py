"""Cluster-wide metrics plane: registry, exposition, aggregation.

Port of ``tensorflowonspark_tpu/metrics.py``: a copy, the exposition,
aggregation and HTTP endpoint included.

The reference's observability story is "spawn TensorBoard and read the
Spark UI" (SURVEY.md §5); this rebuild's subsystems each grew their own
telemetry silo — ``health_events.jsonl``, ``serving_events.jsonl``,
per-host goodput files, ad-hoc counters on ``SegmentRing`` and
``ReplicaScheduler``.  This module is the unified plane they register
into:

- :class:`MetricsRegistry` — a process-local registry of labeled
  :class:`Counter` / :class:`Gauge` / :class:`Histogram` families.  Hot
  paths stay cheap: ``Histogram.record`` is a single ``deque.append``
  (GIL-atomic, folded into buckets only at snapshot time), counter
  increments take one uncontended per-family lock, and gauges that mirror
  live state (queue depth, per-replica outstanding) are computed lazily
  by *collect hooks* at snapshot time instead of on every mutation.
- **Transport**: worker registries ride the existing heartbeat kv payload
  (:class:`~tensorflowonspark_tpu_torch.health.HeartbeatReporter` attaches
  :func:`snapshot`; the driver's
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` keeps the last
  snapshot per node) — a live cluster view with zero new sockets.
  :func:`merge_snapshots` stamps each node's samples with a ``node``
  label so one exposition page shows the whole cluster.
- **Exposition**: :func:`render_prometheus` renders any snapshot in the
  Prometheus text format (0.0.4: ``# HELP``/``# TYPE``, escaped labels,
  cumulative histogram buckets with ``+Inf``/``_sum``/``_count``);
  :class:`MetricsHTTPServer` hangs ``/metrics`` (text) and ``/statusz``
  (JSON) off a stdlib HTTP server — the serving tier starts one next to
  its frontend, training-only jobs via ``TPUCluster.serve_metrics()``.

Naming is enforced (here at registration, statically by tfos-check's
``metric-naming`` rule): ``^[a-z][a-z0-9_]*$`` with a ``tfos_`` prefix
and a unit suffix — counters end ``_total``, other kinds end in one of
``_seconds`` / ``_bytes`` / ``_count`` / ``_ratio`` / ``_info`` — so the
catalog (docs/observability.md) cannot drift into inconsistency.

``TFOS_NO_TELEMETRY=1`` turns the process registry into a no-op (every
instrument swallows its updates) — the bench A/B switch for measuring
the plane's own overhead (``scripts/bench_telemetry.py``).
"""

from __future__ import annotations

import bisect
import collections
import json
import logging
import os
import re
import threading

logger = logging.getLogger(__name__)

#: kill switch: set to "1" to no-op every instrument in this process
DISABLE_ENV = "TFOS_NO_TELEMETRY"

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
NAME_PREFIX = "tfos_"
#: unit suffixes for gauges/histograms; counters end ``_total`` instead
#: (and ONLY counters may — a gauge named ``*_total`` would read as a
#: monotonic counter to every Prometheus consumer)
UNIT_SUFFIXES = ("_seconds", "_bytes", "_count", "_ratio", "_info")

#: default histogram bucket upper bounds (latency-shaped; seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def telemetry_enabled() -> bool:
    """False when the operator disabled telemetry via ``TFOS_NO_TELEMETRY``."""
    return os.environ.get(DISABLE_ENV, "").strip() not in ("1", "true", "yes")


def validate_name(name: str, kind: str) -> None:
    """Raise ``ValueError`` unless ``name`` follows the catalog convention
    (the runtime twin of tfos-check's ``metric-naming`` rule)."""
    if not _NAME_RE.match(name):
        raise ValueError(f"metric name {name!r} must match {_NAME_RE.pattern}")
    if not name.startswith(NAME_PREFIX):
        raise ValueError(f"metric name {name!r} must start with "
                         f"{NAME_PREFIX!r}")
    if kind == "counter":
        if not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end with '_total'")
    elif not name.endswith(UNIT_SUFFIXES):
        raise ValueError(f"{kind} {name!r} must end with a unit suffix "
                         f"{UNIT_SUFFIXES}")


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {labelnames}, got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Base family: name, help, declared label names, per-family lock."""

    kind = ""

    def __init__(self, name: str, help: str = "", labelnames=()):
        validate_name(name, self.kind)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _sample_rows(self) -> list:
        raise NotImplementedError

    def snapshot_entry(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "labelnames": list(self.labelnames),
                "samples": self._sample_rows()}


class Counter(_Metric):
    """Monotonic counter family.  ``inc(n=1, **labels)``; hot loops can
    pre-resolve a child via ``labels(**l)`` and call ``child.inc(n)``."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames=()):
        super().__init__(name, help, labelnames)
        self._vals: dict[tuple, float] = collections.defaultdict(float)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._vals[key] += n

    def labels(self, **labels) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(self.labelnames, labels))

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_label_key(self.labelnames, labels), 0.0)

    def _sample_rows(self) -> list:
        with self._lock:
            return [[dict(zip(self.labelnames, key)), v]
                    for key, v in sorted(self._vals.items())]


class _BoundCounter:
    __slots__ = ("_fam", "_key")

    def __init__(self, fam: Counter, key: tuple):
        self._fam = fam
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        with self._fam._lock:
            self._fam._vals[self._key] += n


class Gauge(_Metric):
    """Last-value gauge family: ``set(v, **labels)``.  Gauges mirroring
    live structures are better set from a registry collect hook, so the
    mutating hot path never touches them."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labelnames=()):
        super().__init__(name, help, labelnames)
        self._vals: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._vals[key] = float(value)

    def remove(self, **labels) -> None:
        """Drop one labeled series (a retired replica must stop being
        reported, not freeze at its last value)."""
        with self._lock:
            self._vals.pop(_label_key(self.labelnames, labels), None)

    def value(self, **labels):
        with self._lock:
            return self._vals.get(_label_key(self.labelnames, labels))

    def _sample_rows(self) -> list:
        with self._lock:
            return [[dict(zip(self.labelnames, key)), v]
                    for key, v in sorted(self._vals.items())]


class Histogram(_Metric):
    """Fixed-bucket histogram family with a lock-free hot path.

    ``record`` appends to a per-child ``deque`` — GIL-atomic, no lock, the
    same contract as :class:`~tensorflowonspark_tpu_torch.observability.
    LatencyHistogram.record` — and the pending samples are folded into
    bucket counts only when a snapshot is taken (heartbeat interval /
    scrape time), off the request path.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._children: dict[tuple, _HistChild] = {}

    def _child(self, key: tuple) -> "_HistChild":
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _HistChild(self.buckets))
        return child

    def record(self, value: float, **labels) -> None:
        self._child(_label_key(self.labelnames, labels)).record(value)

    def labels(self, **labels) -> "_HistChild":
        return self._child(_label_key(self.labelnames, labels))

    def _sample_rows(self) -> list:
        with self._lock:
            items = sorted(self._children.items())
        return [[dict(zip(self.labelnames, key)), child.fold()]
                for key, child in items]


class _HistChild:
    """One labeled histogram series: pending deque + folded buckets."""

    def __init__(self, buckets: tuple):
        self._buckets = buckets
        self._pending: collections.deque = collections.deque()
        self._counts = [0] * (len(buckets) + 1)   # last = overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._fold_lock = threading.Lock()

    def record(self, value: float) -> None:
        self._pending.append(float(value))        # GIL-atomic, lock-free

    def fold(self) -> dict:
        """Drain pending samples into the bucket counts; returns the
        folded series as a JSON-able dict."""
        with self._fold_lock:
            while True:
                try:
                    v = self._pending.popleft()
                except IndexError:
                    break
                self._counts[bisect.bisect_left(self._buckets, v)] += 1
                self._sum += v
                self._count += 1
            return {"le": list(self._buckets),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}


class _NullMetric:
    """Shared no-op instrument for the ``TFOS_NO_TELEMETRY=1`` registry."""

    def inc(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def record(self, *a, **k):
        pass

    def remove(self, *a, **k):
        pass

    def labels(self, *a, **k):
        return self

    def value(self, *a, **k):
        return None


_NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Process-local registry of metric families.

    ``counter``/``gauge``/``histogram`` are get-or-create: every
    subsystem can ask for its family at import/construction time and the
    first registration wins (a kind or label mismatch on re-registration
    raises — two subsystems silently sharing a name with different
    schemas would corrupt the catalog).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, _Metric] = {}
        self._hooks: list = []
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------
    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        if not self.enabled:
            return _NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help,
                                              labelnames=labelnames, **kwargs)
            elif not isinstance(m, cls) \
                    or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labelnames}; cannot re-register as "
                    f"{cls.kind} with labels {tuple(labelnames)}")
            elif "buckets" in kwargs and m.buckets != tuple(
                    sorted(float(b) for b in kwargs["buckets"])):
                # silently sharing a family across different bucket
                # layouts would fold one caller's samples into +Inf
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}; cannot re-register with "
                    f"{tuple(kwargs['buckets'])}")
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def add_collect_hook(self, hook) -> None:
        """Register ``hook()`` to run at every :meth:`snapshot` — the
        place to set gauges that mirror live state (queue depth,
        per-replica outstanding) without touching the mutating hot path."""
        with self._lock:
            self._hooks.append(hook)

    def remove_collect_hook(self, hook) -> None:
        with self._lock:
            with_hook = [h for h in self._hooks if h is not hook]
            self._hooks = with_hook

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time view of every family, as a picklable/JSON-able
        dict (the heartbeat payload shape; see module docstring)."""
        if not self.enabled:
            return {}
        with self._lock:
            hooks = list(self._hooks)
            metrics = list(self._metrics.values())
        for hook in hooks:
            try:
                hook()
            # tfos: ignore[broad-except] — a buggy subscriber must not
            # take down the scrape; the hook's gauges just go stale
            except Exception:
                logger.exception("metrics collect hook failed")
        return {m.name: m.snapshot_entry() for m in metrics}

    def render(self) -> str:
        return render_prometheus(self.snapshot())


# -- process default registry ----------------------------------------------

_default_registry: MetricsRegistry | None = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-local default registry every subsystem registers into
    (disabled — all-no-op — when ``TFOS_NO_TELEMETRY=1`` at first use)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry(enabled=telemetry_enabled())
        return _default_registry


# -- aggregation -----------------------------------------------------------

def merge_snapshots(by_node: dict, label: str = "node") -> dict:
    """Merge per-node snapshots into one, stamping each sample with
    ``label=<node key>``.  Same-name families must agree on type; a
    conflicting node's family is dropped with a warning (a half-upgraded
    cluster must not poison the whole page)."""
    merged: dict = {}
    for node_key, snap in sorted(by_node.items(), key=lambda kv: str(kv[0])):
        for name, entry in (snap or {}).items():
            tgt = merged.get(name)
            if tgt is None:
                tgt = merged[name] = {
                    "type": entry.get("type"), "help": entry.get("help", ""),
                    "labelnames": [label] + list(entry.get("labelnames", [])),
                    "samples": []}
            elif tgt["type"] != entry.get("type"):
                logger.warning(
                    "metric %r: node %r reports type %r but %r was merged "
                    "first; dropping the conflicting family", name, node_key,
                    entry.get("type"), tgt["type"])
                continue
            for labels, value in entry.get("samples", []):
                tgt["samples"].append(
                    [{label: str(node_key), **labels}, value])
    return merged


def render_cluster_text(driver_snapshot: dict, node_metrics: dict) -> str:
    """One Prometheus page for a whole cluster: the driver's registry
    snapshot (labeled ``node="driver"``) merged with each worker's
    heartbeat-carried snapshot from ``ClusterMonitor.node_metrics()``
    (labeled by executor id) — the shared backend of
    ``TPUCluster.metrics_text`` and ``ServingCluster.metrics_text``."""
    by_node = {"driver": driver_snapshot}
    for eid, node in node_metrics.items():
        by_node[str(eid)] = (node or {}).get("metrics") or {}
    return render_prometheus(merge_snapshots(by_node))


# -- Prometheus text exposition --------------------------------------------

def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Render a snapshot (one registry's, or a :func:`merge_snapshots`
    result) in the Prometheus text exposition format 0.0.4."""
    out: list[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind = entry.get("type", "untyped")
        if entry.get("help"):
            out.append(f"# HELP {name} {_escape_help(entry['help'])}")
        out.append(f"# TYPE {name} {kind}")
        for labels, value in entry.get("samples", []):
            if kind == "histogram":
                cum = 0
                for le, c in zip(value["le"] + [float("inf")],
                                 value["counts"]):
                    cum += c
                    le_s = "+Inf" if le == float("inf") else _fmt_value(le)
                    out.append(f"{name}_bucket"
                               f"{_fmt_labels({**labels, 'le': le_s})} {cum}")
                out.append(f"{name}_sum{_fmt_labels(labels)} "
                           f"{_fmt_value(value['sum'])}")
                out.append(f"{name}_count{_fmt_labels(labels)} "
                           f"{value['count']}")
            else:
                out.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(out) + ("\n" if out else "")


# -- HTTP exposition -------------------------------------------------------

class MetricsHTTPServer:
    """``/metrics`` (Prometheus text) + ``/statusz`` (JSON) on a stdlib
    threading HTTP server.

    ``render`` returns the exposition text; ``statusz`` (optional)
    returns a JSON-able dict.  Both run per request, so the page is
    always live.  Serving tier: hung off the frontend by
    ``ServingCluster.run``; training jobs: ``TPUCluster.serve_metrics``.
    """

    def __init__(self, render, statusz=None, host: str = "127.0.0.1",
                 port: int = 0):
        self._render = render
        self._statusz = statusz
        self._host = host
        self._port = port
        self._httpd = None
        self.address: tuple[str, int] | None = None

    def start(self) -> tuple[str, int]:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        render, statusz = self._render, self._statusz

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # no stderr chatter
                logger.debug("metrics http: " + fmt, *args)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = render().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/statusz" and statusz is not None:
                        body = json.dumps(statusz(), indent=1,
                                          default=str).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                # tfos: ignore[broad-except] — a scrape handler bug must
                # surface as a 500 to the scraper, never kill the server
                except Exception:
                    logger.exception("metrics endpoint render failed")
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.daemon_threads = True
        self.address = self._httpd.server_address[:2]
        threading.Thread(target=self._httpd.serve_forever,
                         name="metrics-http", daemon=True).start()
        logger.info("metrics endpoint at http://%s:%d/metrics",
                    *self.address)
        return self.address

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
