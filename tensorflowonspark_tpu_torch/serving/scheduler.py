"""Driver-side request scheduler: admission, routing, re-queue on death.

Port of ``tensorflowonspark_tpu/serving/scheduler.py`` over the port's
metrics, observability, tracing and queues.  The JAX package's routing
for disaggregated prefill/decode pools, multi-model hosting with traffic
splits and hot swaps, and the control-plane journal wait for their
modules (ROADMAP A8c); mesh-sharded gang replicas for the port's mesh
(A6).  The ``model`` label of the request series stays, as
``"default"``, so the exposition keeps the JAX package's series.

The scheduler is the piece between the :class:`~tensorflowonspark_tpu_torch.
serving.frontend.ServeFrontend` (which owns client connections) and the
per-worker replica loops (:func:`~tensorflowonspark_tpu_torch.serving.replica.
serve_replica`).  It speaks to each replica through the node's existing
queue data plane — a :class:`~tensorflowonspark_tpu_torch.queues.QueueClient`
pair per replica (one for request puts, one for streamed-response gets,
so a blocked read never serializes behind a write on the shared
connection lock), which transparently negotiates the zero-copy shm
transport when driver and replica share a host (``shm.py``).

Scheduling policy (docs/serving.md):

- **Admission control** — a bounded global queue: when queued + in-flight
  requests reach ``max_queue_depth``, ``submit`` raises a typed
  :class:`RequestRejected` (``reason="queue_full"``) instead of letting an
  overloaded service build an unbounded latency backlog.  Shedding at
  admission is the serving-tier analogue of the data plane's bounded
  queue backpressure.
- **Routing** — least-outstanding-requests: a request is dispatched to
  the alive replica with the fewest driver-tracked in-flight requests
  (ties broken by the replica's last self-reported
  :meth:`~tensorflowonspark_tpu_torch.models.serving.ContinuousBatcher.load`),
  bounded per replica by ``slots x overcommit`` so one replica's local
  queue can never absorb the whole backlog.
- **Deadlines** — a request's ``timeout`` covers its time in the
  scheduler: expired while queued → typed :class:`DeadlineExceeded`
  before any replica sees it; expired while streaming → the frontend
  abandons it (tokens already computed are discarded, the replica runs
  the slot to completion — a deliberately simple contract, the deadline
  bounds what the *client* waits for).
- **Failure handling** — replica deaths arrive from three independent
  signals: the :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor`'s
  classified failures (``on_cluster_failure``), the supervisor's
  ``backend.exitcodes()`` poll, and transport errors on the replica's
  queue connections.  A dead replica's in-flight requests are re-queued
  ONCE to the survivors at the FRONT of the queue; because decode output
  is a pure function of the request (the ContinuousBatcher contract),
  the replay regenerates the identical token sequence and the scheduler
  suppresses the first ``len(delivered)`` tokens, so a client mid-stream
  observes an uninterrupted exact stream across the failover.  A second
  death fails the request with a typed :class:`ReplicaFailed`.
- **Tenant-aware admission** — admission is split per tenant: each
  configured tenant gets a :class:`TokenBucket` (sustained rate +
  burst) and a priority class, so load shed is a *policy* — the noisy
  tenant's overflow is rejected with a typed
  ``RequestRejected(reason="tenant_throttled")`` while the quiet
  tenant's traffic sails through, and the global ``max_queue_depth``
  bound stays the backstop.  Priority classes (``high``/``normal``/
  ``low``) order the pending queue: a high-priority request dispatches
  ahead of earlier-admitted low-priority ones (FIFO within a class;
  failover re-queues go to the front of their own class so the
  exactness contract is priority-blind).
- **Elastic membership** — replicas can be added (:meth:`ReplicaScheduler.
  add_replica`, fed by ``ServingCluster.add_replicas``'s re-opened
  reservation path) and retired live.  Retirement is drain-based:
  :meth:`mark_draining` stops new routing, :meth:`drain_replica` waits
  out the in-flight set, :meth:`retire_replica` removes the replica
  without it ever counting as *dead* — ``serving_events.jsonl`` carries
  the ``replica_draining``/``replica_retired``/``replica_added``
  taxonomy next to the failure events (docs/serving.md).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch import observability, tracing
from tensorflowonspark_tpu_torch.queues import QueueClient

logger = logging.getLogger(__name__)

#: serving traffic rides the node's standard data-plane queues — the
#: shm fast path, queue_depth bound and EndOfFeed shutdown all come for
#: free (cluster.shutdown drains replicas exactly like a training feed)
REQUEST_QUEUE = "input"
RESPONSE_QUEUE = "output"


class ServingError(RuntimeError):
    """Base class for typed serving-tier failures."""


class RequestRejected(ServingError):
    """Load-shed at admission: the request never entered the queue.

    ``reason`` is machine-readable: ``queue_full`` (bounded queue depth
    reached), ``tenant_throttled`` (the tenant's token bucket is empty —
    only THIS tenant is over budget), ``shutdown`` (scheduler stopping),
    ``no_replica`` (every replica is dead), ``unknown_model`` (the
    request names a ``model``: multi-model hosting waits for ROADMAP
    A8c)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


#: priority classes, best first — the pending queue dispatches strictly
#: in this order (FIFO within a class)
PRIORITIES = ("high", "normal", "low")


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s sustained, ``burst``
    capacity.  ``try_take`` is called under the scheduler lock, so no
    lock of its own; ``now`` is injectable for deterministic tests."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self.tokens = self.burst
        self.stamp: float | None = None

    def try_take(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        if self.stamp is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _Tenant:
    """One tenant's admission policy + live counters."""

    __slots__ = ("name", "bucket", "priority", "accepted", "shed")

    def __init__(self, name: str, spec: dict | None):
        spec = spec or {}
        self.name = name
        rate = spec.get("rate")
        self.bucket = (None if rate is None
                       else TokenBucket(rate, spec.get("burst")))
        self.priority = spec.get("priority", "normal")
        if self.priority not in PRIORITIES:
            raise ValueError(f"tenant {name!r}: unknown priority "
                             f"{self.priority!r} (want one of {PRIORITIES})")
        self.accepted = 0
        self.shed = 0


class _PendingQueue:
    """Priority-banded pending queue: one FIFO deque per class, popped
    best class first.  Exposes the deque surface the scheduler already
    uses (append/appendleft/popleft/remove/clear/len/iter); appendleft
    fronts a request within ITS OWN class, so a failover re-queue of a
    low-priority request can never leapfrog high-priority work."""

    def __init__(self):
        self._bands = {p: collections.deque() for p in PRIORITIES}

    def _band(self, req) -> collections.deque:
        return self._bands[getattr(req, "priority", "normal")]

    def append(self, req) -> None:
        self._band(req).append(req)

    def appendleft(self, req) -> None:
        self._band(req).appendleft(req)

    def popleft(self):
        for band in self._bands.values():
            if band:
                return band.popleft()
        raise IndexError("pop from empty pending queue")

    def remove(self, req) -> None:
        self._band(req).remove(req)   # ValueError when absent, like deque

    def clear(self) -> None:
        for band in self._bands.values():
            band.clear()

    def __len__(self) -> int:
        return sum(len(b) for b in self._bands.values())

    def __iter__(self):
        return itertools.chain.from_iterable(self._bands.values())


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it completed."""


class ReplicaFailed(ServingError):
    """The request was lost to replica failure(s) after its one re-queue
    (or no replica survives to run it)."""


class ServeRequest:
    """One in-flight generate request, owned by the scheduler.

    ``events`` is the delivery channel to whoever is waiting (the
    frontend's connection thread): ``("tok", [t...])`` deltas,
    ``("done", n_tokens)``, or ``("err", reason, message)``.  ``tokens``
    accumulates every delta already delivered — the replay-dedup source
    and the non-streaming result.
    """

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_p",
                 "seed", "deadline", "events", "tokens", "attempts",
                 "replica", "skip", "created", "first_token_at", "finished",
                 "trace", "tenant", "priority")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 temperature: float, top_p: float, seed: int,
                 deadline: float | None, trace: str | None = None,
                 tenant: str = "default", priority: str = "normal"):
        self.rid = rid
        self.trace = trace or tracing.new_trace_id()
        self.tenant = tenant
        self.priority = priority
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.deadline = deadline          # time.monotonic() deadline | None
        self.events: _queue.Queue = _queue.Queue()
        self.tokens: list[int] = []
        self.attempts = 0
        self.replica: int | None = None   # executor id currently serving
        self.skip = 0                     # replay dedup: deltas to suppress
        self.created = time.monotonic()
        self.first_token_at: float | None = None
        self.finished = False

    def message(self) -> dict:
        """The wire message the replica loop consumes (``trace`` rides
        along so replica-side spans correlate with the driver's)."""
        return {"op": "gen", "rid": self.rid, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature, "top_p": self.top_p,
                "seed": self.seed, "trace": self.trace}


#: the ``model`` label value of every request series (one model a tier)
_MODEL = "default"


class _Replica:
    """Driver-side view of one routable replica (a serving worker)."""

    def __init__(self, info: dict, max_inflight: int):
        self.info = info
        self.eid = int(info["executor_id"])
        self.max_inflight = int(max_inflight)
        self.outstanding: dict[int, ServeRequest] = {}
        self.reported_load = 0   # last ContinuousBatcher.load()["total"]
        #: last self-reported allocatable KV pages (paged-KV replicas;
        #: 0 for dense ones) — the memory-pressure routing tie-break
        self.reported_free_pages = 0
        #: last self-reported cumulative speculation counters
        #: ({"proposed": n, "accepted": n}) from a speculating replica's
        #: response piggyback; None when the replica never speculates
        self.reported_spec: dict | None = None
        self.alive = True
        self.draining = False    # no NEW routes; in-flight runs out
        self.retired = False     # left cleanly — never counts as dead
        self.send_cli = None
        self.recv_cli = None
        self.served = 0
        #: first tok/done message seen from this replica (one-shot
        #: ``replica_first_response`` event: the heal-time benches'
        #: restored-capacity clock — request_first_token alone misses
        #: replayed streams, whose first token already happened)
        self.responded = False


class ReplicaScheduler:
    """Routes generate requests over a cluster of ContinuousBatcher
    replicas (see module docstring for policy)."""

    def __init__(self, cluster, *, slots_per_replica: int,
                 overcommit: int = 2, max_queue_depth: int | None = None,
                 poll_interval: float = 0.25, requeue_limit: int = 1,
                 client_factory=None, event_log=None,
                 tenants: dict | None = None):
        self.cluster = cluster
        feedable = sorted(
            (n for n in cluster.cluster_info
             if n.get("job_name", "worker") in ("worker", "chief", "master")),
            key=lambda n: n["executor_id"])
        if not feedable:
            raise ValueError("serving cluster has no feedable replicas")
        max_inflight = max(1, int(slots_per_replica) * int(overcommit))
        self._max_inflight = max_inflight  # replicas added live inherit it
        self.replicas: dict[int, _Replica] = {
            int(n["executor_id"]): _Replica(n, max_inflight) for n in feedable}
        #: bounded admission queue: queued + in-flight across the tier
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else 2 * max_inflight * len(self.replicas))
        #: per-tenant admission policies (docs/serving.md): ``{name:
        #: {"rate": req/s | None, "burst": n, "priority": "high" |
        #: "normal" | "low"}}``.  Unknown tenants fall back to the
        #: ``"default"`` entry (unlimited, normal priority, unless
        #: configured otherwise).
        self.tenants: dict[str, _Tenant] = {
            name: _Tenant(name, spec) for name, spec in (tenants or {}).items()}
        self.tenants.setdefault("default", _Tenant("default", None))
        self.poll_interval = float(poll_interval)
        self.requeue_limit = int(requeue_limit)
        #: ``on_replica_ready(eid) -> dict | None`` fires when a replica
        #: acks ``standby_ready`` on its response channel (a promoted
        #: warm standby finished loading weights — restored capacity).
        #: Runs under the scheduler lock and must not re-enter it; any
        #: returned fields ride the emitted ``standby_ready`` event.
        #: The serving tier uses it to close its heal-time measurement.
        self.on_replica_ready = None
        self._client_factory = client_factory or self._default_client
        self._own_events = event_log is None and bool(
            getattr(cluster, "working_dir", None))
        if self._own_events:
            # echo=False: admitted/routed/first-token/done fire per
            # request — lifecycle problems still log via logger.warning
            event_log = observability.EventLog(
                os.path.join(cluster.working_dir, "serving_events.jsonl"),
                echo=False)
        self.events = event_log
        self._pending = _PendingQueue()
        #: in-flight replacements (expect_replica): while a heal is
        #: pending, dispatch QUEUES work instead of fail-fasting on "no
        #: survivor"
        self._expected = 0
        #: seconds dispatch keeps work queued after the LAST replica
        #: dies, bridging death-detection (the recv loop's requeue fires
        #: sub-second) to the tier's heal announcing itself via
        #: :meth:`expect_replica` (the monitor classifies the crash on
        #: its poll cadence).  0 = shed immediately (tiers with no heal
        #: path keep the typed fail-fast); tiers that configure heals
        #: (warm standbys / replace_failed) set this.
        self.heal_grace = 0.0
        #: monotonic time the last replica died (None while any lives)
        self._lost_at: float | None = None
        self._requests: dict[int, ServeRequest] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._ids = itertools.count()
        self._threads: list[threading.Thread] = []
        # -- metrics (observability.LatencyHistogram: lock-free record) --
        self.ttft = observability.LatencyHistogram()
        self.e2e = observability.LatencyHistogram()
        self.accepted = 0
        self.completed = 0
        self.shed = 0
        self.expired = 0
        self.abandoned = 0      # client disconnects, not deadline expiries
        self.failed = 0
        self.requeued = 0
        # -- registry instruments (metrics.py): counters/histograms inc
        # on the paths that already hold the scheduler lock; gauges that
        # mirror live state are set by the collect hook at snapshot time
        # so the hot path never touches them
        reg = _metrics.get_registry()
        self._m_requests = reg.counter(
            "tfos_serving_requests_total",
            "Serving requests by outcome (accepted/completed/shed/"
            "expired/abandoned/failed/requeued) and hosted model.",
            labelnames=("outcome", "model"))
        # label values come from the CONFIGURED tenant set (unknown names
        # collapse to "default"), so cardinality is operator-bounded
        self._m_tenant = reg.counter(
            "tfos_serving_tenant_requests_total",
            "Per-tenant admission outcomes (accepted/tenant_throttled).",
            labelnames=("tenant", "outcome"))
        self._m_scale = reg.counter(
            "tfos_serving_scale_events_total",
            "Replica membership changes (added/draining/retired/dead).",
            labelnames=("change",))
        self._m_ttft = reg.histogram(
            "tfos_serving_ttft_seconds",
            "Admission to first token, per hosted model.",
            labelnames=("model",))
        self._m_e2e = reg.histogram(
            "tfos_serving_e2e_seconds",
            "Admission to completion, per hosted model.",
            labelnames=("model",))
        self._g_depth = reg.gauge(
            "tfos_serving_queue_depth_count",
            "Requests queued in the scheduler, not yet dispatched.")
        self._g_outstanding = reg.gauge(
            "tfos_serving_replica_outstanding_count",
            "Driver-tracked in-flight requests per replica.",
            labelnames=("replica",))
        self._g_load = reg.gauge(
            "tfos_serving_replica_load_count",
            "Replica's last self-reported batcher load.",
            labelnames=("replica",))
        self._g_alive = reg.gauge(
            "tfos_serving_replicas_alive_count", "Alive serving replicas.")
        reg.add_collect_hook(self._collect_gauges)
        # audit events are enqueued (GIL-atomic append) and written by a
        # dedicated thread: a stalled disk must never block the request
        # path, which emits under the global scheduler lock
        self._event_q: collections.deque = collections.deque()
        self._event_wake = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaScheduler":
        self._emit("scheduler_started", replicas=sorted(self.replicas),
                   max_queue_depth=self.max_queue_depth)
        self._threads = [
            threading.Thread(target=self._dispatch_loop, name="serve-dispatch",
                             daemon=True),
            threading.Thread(target=self._supervise_loop,
                             name="serve-supervise", daemon=True),
        ] + [
            threading.Thread(target=self._recv_loop, args=(rep,),
                             name=f"serve-recv-{rep.eid}", daemon=True)
            for rep in self.replicas.values()
        ] + [
            threading.Thread(target=self._event_loop, name="serve-events",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        """Stop routing; reject queued/in-flight leftovers as ``shutdown``."""
        with self._lock:
            self._stop.set()
            self._work.notify_all()
            leftovers = list(self._pending) + [
                r for rep in self.replicas.values()
                for r in rep.outstanding.values()]
            self._pending.clear()
            for rep in self.replicas.values():
                rep.outstanding.clear()
            for req in leftovers:
                if not req.finished:
                    self._finish_err(req, "shutdown",
                                     "scheduler stopped before completion")
        for t in list(self._threads):  # add_replica appends recv threads
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        # the collect hook holds a reference to this scheduler; unhook so
        # a later snapshot doesn't read gauges off a stopped instance —
        # and drop this tier's gauge series so a still-running /metrics
        # page doesn't freeze them at their last values
        _metrics.get_registry().remove_collect_hook(self._collect_gauges)
        for eid in self.replicas:
            self._g_outstanding.remove(replica=str(eid))
            self._g_load.remove(replica=str(eid))
        self._g_depth.remove()
        self._g_alive.remove()
        for rep in self.replicas.values():
            self._close_clients(rep)
        self._drain_events()     # anything emitted after the writer exited
        if self._own_events and self.events is not None:
            self.events.close()
            self.events = None
            self._own_events = False

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait for the queue and every replica's in-flight set to empty;
        False if ``timeout`` elapses first."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._pending) or any(
                    rep.outstanding for rep in self.replicas.values())
            if not busy:
                return True
            time.sleep(0.05)
        return False

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_p: float = 1.0, seed: int = 0,
               timeout: float | None = None,
               trace: str | None = None, tenant: str = "default",
               priority: str | None = None,
               model: str | None = None) -> ServeRequest:
        """Admit one request (typed rejections; see module docstring).
        ``trace`` propagates a caller-supplied trace id; one is minted
        otherwise — every event for this request carries it.  ``tenant``
        selects the admission policy (unknown names fall back to the
        ``default`` tenant); ``priority`` overrides the tenant's class
        but can only DEMOTE — a tenant configured ``low`` cannot smuggle
        requests into the high band.  A named ``model`` is rejected
        typed ``unknown_model``: multi-model hosting waits for ROADMAP
        A8c."""
        with self._lock:
            if self._stop.is_set():
                raise RequestRejected("shutdown", "serving tier is stopping")
            if not any(rep.alive for rep in self.replicas.values()):
                raise RequestRejected("no_replica", "no replica alive")
            if model is not None:
                raise RequestRejected(
                    "unknown_model",
                    f"model {model!r} is not hosted: this tier serves one model "
                    "(multi-model hosting waits for ROADMAP A8c)")
            ten = self.tenants.get(tenant) or self.tenants["default"]
            if priority is not None and priority not in PRIORITIES:
                raise ValueError(f"unknown priority {priority!r} "
                                 f"(want one of {PRIORITIES})")
            eff_priority = max(priority or ten.priority, ten.priority,
                               key=PRIORITIES.index)
            # depth check BEFORE the bucket take: a queue_full rejection
            # must not burn the tenant's rate budget for a request that
            # was never admitted — the bucket meters admissions, not
            # attempts against a saturated tier
            depth = len(self._pending) + sum(
                len(rep.outstanding) for rep in self.replicas.values())
            if depth >= self.max_queue_depth:
                ten.shed += 1
                self.shed += 1
                self._m_requests.inc(outcome="shed", model=_MODEL)
                self._m_tenant.inc(tenant=ten.name, outcome="queue_full")
                raise RequestRejected(
                    "queue_full",
                    f"serving queue full ({depth} >= "
                    f"{self.max_queue_depth} queued+in-flight)")
            if ten.bucket is not None and not ten.bucket.try_take():
                ten.shed += 1
                self.shed += 1
                self._m_requests.inc(outcome="shed", model=_MODEL)
                self._m_tenant.inc(tenant=ten.name,
                                   outcome="tenant_throttled")
                self._emit("request_shed", tenant=ten.name,
                           reason="tenant_throttled")
                raise RequestRejected(
                    "tenant_throttled",
                    f"tenant {ten.name!r} over budget "
                    f"({ten.bucket.rate:g} req/s sustained, burst "
                    f"{ten.bucket.burst:g})")
            rid = next(self._ids)
            req = ServeRequest(
                rid, prompt, max_new_tokens, temperature, top_p, seed,
                deadline=None if timeout is None
                else time.monotonic() + float(timeout), trace=trace,
                tenant=ten.name, priority=eff_priority)
            self._requests[rid] = req
            self._pending.append(req)
            self.accepted += 1
            ten.accepted += 1
            self._m_requests.inc(outcome="accepted", model=_MODEL)
            self._m_tenant.inc(tenant=ten.name, outcome="accepted")
            self._emit("request_admitted", rid=rid, trace=req.trace,
                       depth=depth, tenant=ten.name, priority=eff_priority,
                       model=None)
            self._work.notify()
        return req

    def abandon(self, req: ServeRequest, reason: str = "expired") -> None:
        """Stop tracking ``req``: later replica output for it is discarded
        on arrival.  ``reason`` keeps the metrics honest — ``expired``
        (frontend-side deadline) vs ``disconnect`` (client went away)."""
        with self._lock:
            if req.finished:
                return
            req.finished = True
            self._requests.pop(req.rid, None)
            with contextlib.suppress(ValueError):
                self._pending.remove(req)
            if req.replica is not None:
                rep = self.replicas.get(req.replica)
                if rep is not None:
                    rep.outstanding.pop(req.rid, None)
                    self._work.notify_all()
            if reason == "expired":
                self.expired += 1
                self._m_requests.inc(outcome="expired", model=_MODEL)
            else:
                self.abandoned += 1
                self._m_requests.inc(outcome="abandoned", model=_MODEL)
            self._emit("request_failed", rid=req.rid, trace=req.trace,
                       reason=reason)

    # -- failure intake ----------------------------------------------------
    def on_cluster_failure(self, failure) -> None:
        """`ClusterMonitor` subscriber: classified crash/hang/preemption."""
        with self._lock:
            for eid in getattr(failure, "failed_workers", ()):
                self._mark_dead(int(eid),
                                f"{getattr(failure, 'kind', 'failure')}: {failure}")

    def peer_replica_info(self, exclude=()) -> dict | None:
        """Reservation info of the least-loaded alive, non-draining
        replica — the clone SOURCE a promoted warm standby pulls weights
        from; None when no healthy peer exists (the promotion then falls
        back to checkpoint restore via the model builder)."""
        with self._lock:
            best = None
            for eid, rep in self.replicas.items():
                if not rep.alive or rep.draining or eid in exclude:
                    continue
                if best is None \
                        or len(rep.outstanding) < len(best.outstanding):
                    best = rep
            return None if best is None else dict(best.info)

    def dead_replicas(self) -> set[int]:
        """Every executor id lost to FAILURE (cleanly retired replicas
        excluded)."""
        with self._lock:
            return {eid for eid, rep in self.replicas.items()
                    if not rep.alive and not rep.retired}

    def alive_replicas(self) -> set[int]:
        with self._lock:
            return {eid for eid, rep in self.replicas.items() if rep.alive}

    def draining_replicas(self) -> set[int]:
        with self._lock:
            return {eid for eid, rep in self.replicas.items()
                    if rep.alive and rep.draining}

    # -- elastic membership ------------------------------------------------
    def expect_replica(self) -> None:
        """Announce an in-flight replacement (warm promotion or cold
        spawn).  Until the matching :meth:`expect_done`, the dispatch
        loop QUEUES work instead of fail-fasting on "no survivor" — a
        heal window must not shed the very requests it exists to save.
        Deadlines and client timeouts still bound the wait."""
        with self._work:
            self._expected += 1

    def expect_done(self) -> None:
        """The announced replacement registered — or the heal gave up;
        either way dispatch resumes its normal no-survivor handling."""
        with self._work:
            self._expected = max(0, self._expected - 1)
            self._work.notify_all()

    def _heal_grace_active(self) -> bool:
        """True while work should stay queued awaiting the heal's
        ``expect_replica`` — bounded by ``heal_grace`` so a heal that
        never comes still fails typed (lock held by caller).  The clock
        is anchored at the DEATH that left no replica (``_mark_dead``),
        not at the first dispatch attempt — a request arriving minutes
        after a heal already gave up must fail fast, not stall a full
        grace window."""
        if self.heal_grace <= 0 or self._lost_at is None:
            return False
        return (time.monotonic() - self._lost_at) < self.heal_grace

    def _holding(self) -> bool:
        """Whether queued work waits for a heal (lock held by caller)."""
        return bool(self._expected) or self._heal_grace_active()

    def add_replica(self, info: dict) -> None:
        """Register a freshly reserved replica worker and start routing
        to it (live scale-up / preemption replacement).  ``info`` is the
        node's reservation dict, exactly as ``cluster_info`` carries it."""
        eid = int(info["executor_id"])
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("scheduler is stopping")
            existing = self.replicas.get(eid)
            if existing is not None and existing.alive:
                raise ValueError(f"replica {eid} already registered")
            rep = _Replica(info, self._max_inflight)
            self.replicas[eid] = rep
            # a fresh acceptor stops the lost-tier clock
            self._lost_at = None
            self._m_scale.inc(change="added")
            self._emit("replica_added", replica=eid,
                       alive=sum(1 for r in self.replicas.values()
                                 if r.alive))
            self._work.notify_all()
        t = threading.Thread(target=self._recv_loop, args=(rep,),
                             name=f"serve-recv-{eid}", daemon=True)
        self._threads.append(t)
        t.start()

    def mark_draining(self, eid: int, reason: str = "retiring") -> bool:
        """Stop routing NEW requests to ``eid``; in-flight work runs to
        completion.  False when the replica is unknown/not alive/already
        draining."""
        with self._lock:
            rep = self.replicas.get(eid)
            if rep is None or not rep.alive or rep.draining:
                return False
            rep.draining = True
            self._m_scale.inc(change="draining")
            self._emit("replica_draining", replica=eid, reason=reason,
                       inflight=len(rep.outstanding))
            return True

    def drain_replica(self, eid: int, timeout: float = 60.0) -> bool:
        """Wait until ``eid`` has no driver-tracked in-flight requests
        (callers ``mark_draining`` first, or new routes refill it);
        True immediately if the replica is gone.  False on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                rep = self.replicas.get(eid)
                if rep is None or not rep.alive or not rep.outstanding:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def retire_replica(self, eid: int, reason: str = "retired") -> None:
        """Remove ``eid`` from the tier as a CLEAN departure: it never
        joins ``dead_replicas``, and any request still in flight (a
        forced retire, or the dispatch-vs-drain race during a preemption
        grace window) is re-queued to the front of its priority band
        WITHOUT charging the request's one failover attempt — a planned
        move must not burn the budget kept for real failures."""
        with self._lock:
            rep = self.replicas.get(eid)
            if rep is None or not rep.alive:
                return
            rep.draining = True
            rep.alive = False        # recv loop exits; gauges drop the row
            rep.retired = True
            stranded = list(rep.outstanding.values())
            rep.outstanding.clear()
            self._close_clients(rep)
            self._m_scale.inc(change="retired")
            self._emit("replica_retired", replica=eid, reason=reason,
                       requeued=len(stranded),
                       alive=sum(1 for r in self.replicas.values()
                                 if r.alive))
            for req in stranded:
                if req.finished:
                    continue
                self.requeued += 1
                self._m_requests.inc(outcome="requeued", model=_MODEL)
                req.attempts = max(0, req.attempts - 1)
                req.replica = None
                req.skip = len(req.tokens)
                self._pending.appendleft(req)
                self._emit("request_requeued", rid=req.rid, trace=req.trace,
                           from_replica=eid, delivered=len(req.tokens),
                           planned=True)
            self._work.notify_all()

    # -- metrics -----------------------------------------------------------
    def _collect_gauges(self) -> None:
        """Registry collect hook: mirror live scheduler state into the
        queue-depth / per-replica gauges at snapshot (scrape) time."""
        with self._lock:
            self._g_depth.set(len(self._pending))
            alive = 0
            for eid, rep in self.replicas.items():
                if rep.alive:
                    self._g_outstanding.set(len(rep.outstanding),
                                            replica=str(eid))
                    self._g_load.set(rep.reported_load, replica=str(eid))
                    alive += 1
                else:
                    # a retired replica must stop being reported, not
                    # freeze at its last values
                    self._g_outstanding.remove(replica=str(eid))
                    self._g_load.remove(replica=str(eid))
            self._g_alive.set(alive)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "accepted": self.accepted, "completed": self.completed,
                "shed": self.shed, "expired": self.expired,
                "abandoned": self.abandoned,
                "failed": self.failed, "requeued": self.requeued,
                "queued": len(self._pending),
                "ttft": self.ttft.summary(), "e2e": self.e2e.summary(),
                "replicas": {
                    eid: {"alive": rep.alive, "draining": rep.draining,
                          "retired": rep.retired,
                          "outstanding": len(rep.outstanding),
                          "reported_load": rep.reported_load,
                          "free_pages": rep.reported_free_pages,
                          # speculation acceptance piggyback (None for a
                          # non-speculating replica): rate = accepted /
                          # proposed, the tokens-per-dispatch signal
                          "spec": None if rep.reported_spec is None
                          else {**rep.reported_spec,
                                "acceptance": (
                                    rep.reported_spec["accepted"]
                                    / rep.reported_spec["proposed"]
                                    if rep.reported_spec["proposed"]
                                    else None)},
                          "served": rep.served}
                    for eid, rep in self.replicas.items()},
                "tenants": {
                    name: {"accepted": t.accepted, "shed": t.shed,
                           "priority": t.priority,
                           "rate": None if t.bucket is None
                           else t.bucket.rate}
                    for name, t in self.tenants.items()},
            }

    def emit_event(self, kind: str, **fields) -> None:
        """Public audit-event hook for tier components that share this
        scheduler's ``serving_events.jsonl`` (the standby pool's and the
        tier's membership events ride here so one log tells the whole
        story)."""
        with self._lock:
            self._emit(kind, **fields)

    # -- internals ---------------------------------------------------------
    def _default_client(self, info: dict):
        return QueueClient(info["addr"], info["authkey"], timeout=30.0,
                           shm=self.cluster.cluster_meta.get("queue_shm"))

    def _emit(self, kind: str, **fields) -> None:
        """Queue an audit event (callers hold the scheduler lock — the
        actual file write happens on the serve-events thread).  The
        timestamp is captured here so a backlogged writer can't skew the
        stitched trace timelines."""
        if self.events is not None:
            self._event_q.append((time.time(), kind, fields))
            self._event_wake.set()

    def _event_loop(self) -> None:
        while True:
            self._event_wake.wait(0.2)
            self._event_wake.clear()
            self._drain_events()
            if self._stop.is_set() and not self._event_q:
                return

    def _drain_events(self) -> None:
        while True:
            try:
                t, kind, fields = self._event_q.popleft()
            except IndexError:
                return
            if self.events is not None:
                with contextlib.suppress(Exception):
                    self.events.emit(kind, t=t, **fields)

    def _close_clients(self, rep: _Replica) -> None:
        for cli in (rep.send_cli, rep.recv_cli):
            if cli is not None:
                with contextlib.suppress(Exception):
                    cli.close()
        rep.send_cli = rep.recv_cli = None

    def _pick_replica(self) -> _Replica | None:
        """Least-outstanding alive replica with spare in-flight capacity
        (ties by last self-reported batcher load, then by KV-page
        pressure — MORE free pages wins, so long prompts stop landing
        on memory-starved replicas); None when saturated.  Draining
        replicas take no new work."""
        best = best_key = None
        for rep in self.replicas.values():
            if not rep.alive or rep.draining \
                    or len(rep.outstanding) >= rep.max_inflight:
                continue
            key = (len(rep.outstanding), rep.reported_load,
                   -rep.reported_free_pages)
            if best is None or key < best_key:
                best, best_key = rep, key
        return best

    # -- dispatch ----------------------------------------------------------
    def _next_dispatch(self):
        """The first dispatchable ``(req, rep)`` in the pending queue, or
        None when everything queued waits on capacity or a heal (lock
        held).  Expires deadline-passed requests anywhere in the queue,
        and fails (typed) the queue when no replica survives and no heal
        is in flight."""
        saturated = False
        for req in list(self._pending):
            if req.finished:
                with contextlib.suppress(ValueError):
                    self._pending.remove(req)
                continue
            if req.deadline is not None \
                    and time.monotonic() > req.deadline:
                with contextlib.suppress(ValueError):
                    self._pending.remove(req)
                self._expire(req)
                continue
            if saturated:
                continue        # the tier was already probed saturated
            rep = self._pick_replica()
            if rep is not None:
                with contextlib.suppress(ValueError):
                    self._pending.remove(req)
                return req, rep
            # no capacity right now: does any replica survive?  Fail
            # typed if not — UNLESS a heal is in flight (expect_replica)
            # or recent enough that its announcement may still be coming
            # (heal_grace), in which case the work stays queued
            if not any(r.alive for r in self.replicas.values()) \
                    and not self._holding():
                with contextlib.suppress(ValueError):
                    self._pending.remove(req)
                self._finish_err(req, "no_replica", "no replica alive")
                continue
            # saturated (or healing): every later request faces the same
            # candidate set, so FIFO within a priority class holds
            saturated = True
        return None

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._work:
                while not self._pending and not self._stop.is_set():
                    self._work.wait(0.2)
                if self._stop.is_set():
                    return
                got = self._next_dispatch()
                if got is None:
                    # every queued request is waiting on capacity or a
                    # heal window
                    self._work.wait(0.05)
                    continue
                req, rep = got
                req.replica = rep.eid
                rep.outstanding[req.rid] = req
                req.attempts += 1
                msg = req.message()
                self._emit("request_routed", rid=req.rid,
                           trace=req.trace, replica=rep.eid,
                           attempt=req.attempts)
            # the put may block on the socket — never under the lock
            try:
                if rep.send_cli is None:
                    rep.send_cli = self._client_factory(rep.info)
                rep.send_cli.put(REQUEST_QUEUE, msg, timeout=30)
            except Exception as e:
                # a dead/wedged replica: everything it holds (including
                # this request) is re-queued or failed by _mark_dead
                with self._lock:
                    self._mark_dead(rep.eid, f"request put failed: {e!r}")

    def _expire(self, req: ServeRequest) -> None:
        """Fail ``req`` with a deadline error (lock held by caller)."""
        self.expired += 1
        self._m_requests.inc(outcome="expired", model=_MODEL)
        req.finished = True
        self._requests.pop(req.rid, None)
        self._emit("request_failed", rid=req.rid, trace=req.trace,
                   reason="deadline")
        req.events.put(("err", "deadline",
                        f"deadline exceeded after "
                        f"{time.monotonic() - req.created:.2f}s in queue"))

    def _finish_err(self, req: ServeRequest, reason: str, msg: str) -> None:
        """Fail ``req`` with a typed error (lock held by caller)."""
        self.failed += 1
        self._m_requests.inc(outcome="failed", model=_MODEL)
        req.finished = True
        self._requests.pop(req.rid, None)
        self._emit("request_failed", rid=req.rid, trace=req.trace,
                   reason=reason)
        req.events.put(("err", reason, msg))

    # -- replica responses -------------------------------------------------
    def _recv_loop(self, rep: _Replica) -> None:
        while not self._stop.is_set() and rep.alive:
            try:
                if rep.recv_cli is None:
                    rep.recv_cli = self._client_factory(rep.info)
                msg = rep.recv_cli.get(RESPONSE_QUEUE, timeout=0.5)
            except TimeoutError:
                continue
            except Exception as e:
                if self._stop.is_set():
                    return
                with self._lock:
                    self._mark_dead(rep.eid, f"response channel lost: {e!r}")
                return
            if not isinstance(msg, dict):
                continue
            self._handle_response(rep, msg)

    def _handle_response(self, rep: _Replica, msg: dict) -> None:
        rid = msg.get("rid")
        event = msg.get("event")
        with self._lock:
            if "load" in msg:
                rep.reported_load = int(msg["load"])
            if "free_pages" in msg:
                rep.reported_free_pages = int(msg["free_pages"])
            spec = msg.get("spec")
            if spec is not None:
                rep.reported_spec = {
                    "proposed": int(spec.get("proposed", 0)),
                    "accepted": int(spec.get("accepted", 0))}
            if event == "standby_ready":
                # a promoted standby finished loading weights: capacity
                # is restored — let the tier close its heal measurement
                fields = {}
                if self.on_replica_ready is not None:
                    try:
                        fields = self.on_replica_ready(rep.eid) or {}
                    except Exception:
                        logger.exception("on_replica_ready hook raised")
                self._emit("standby_ready", replica=rep.eid,
                           source=msg.get("source"), **fields)
                return
            if not rep.responded and event in ("tok", "done"):
                rep.responded = True
                self._emit("replica_first_response", replica=rep.eid)
            req = rep.outstanding.get(rid)
            if req is None or req.finished:
                return          # abandoned, or replayed on another replica
            if event == "tok":
                toks = [int(t) for t in msg.get("tokens", ())]
                if req.skip:    # replay after failover: dedup the prefix
                    cut = min(req.skip, len(toks))
                    req.skip -= cut
                    toks = toks[cut:]
                if not toks:
                    return
                if req.first_token_at is None:
                    req.first_token_at = time.monotonic()
                    ttft = req.first_token_at - req.created
                    self.ttft.record(ttft)
                    self._m_ttft.record(ttft, model=_MODEL)
                    self._emit("request_first_token", rid=rid,
                               trace=req.trace, replica=rep.eid,
                               ttft_secs=round(ttft, 6))
                req.tokens.extend(toks)
                req.events.put(("tok", toks))
            elif event == "done":
                rep.outstanding.pop(rid, None)
                rep.served += 1
                req.finished = True
                self._requests.pop(rid, None)
                self.completed += 1
                self._m_requests.inc(outcome="completed", model=_MODEL)
                e2e = time.monotonic() - req.created
                self.e2e.record(e2e)
                self._m_e2e.record(e2e, model=_MODEL)
                self._emit("request_done", rid=rid, trace=req.trace,
                           replica=rep.eid, tokens=len(req.tokens),
                           e2e_secs=round(e2e, 6))
                req.events.put(("done", len(req.tokens)))
                self._work.notify_all()
            elif event == "error":
                rep.outstanding.pop(rid, None)
                self._finish_err(req, "bad_request",
                                 str(msg.get("error", "replica error")))
                self._work.notify_all()

    # -- supervision -------------------------------------------------------
    def _supervise_loop(self) -> None:
        backend = getattr(self.cluster, "backend", None)
        exitcodes = getattr(backend, "exitcodes", None)
        while not self._stop.wait(self.poll_interval):
            if exitcodes is None:
                continue
            try:
                codes = dict(exitcodes())
            except Exception:
                logger.debug("replica supervise: exitcodes() failed "
                             "(transient during teardown)", exc_info=True)
                continue
            with self._lock:
                for eid, rep in self.replicas.items():
                    if rep.alive and codes.get(eid) not in (0, None):
                        self._mark_dead(
                            eid, f"process exited (code {codes[eid]})")

    def _mark_dead(self, eid: int, reason: str) -> None:
        """Retire a replica and fail over its in-flight requests (lock
        held by caller).  Idempotent — death is observed from several
        independent signals."""
        rep = self.replicas.get(eid)
        if rep is None or not rep.alive:
            return
        rep.alive = False
        logger.warning("serving replica %d marked dead: %s", eid, reason)
        self._m_scale.inc(change="dead")
        self._emit("replica_dead", replica=eid, reason=reason,
                   shards=[eid], inflight=len(rep.outstanding))
        stranded = list(rep.outstanding.values())
        rep.outstanding.clear()
        self._close_clients(rep)
        survivors = any(r.alive for r in self.replicas.values())
        if not survivors and self._lost_at is None:
            # the heal-grace window runs from HERE (a fresh replica
            # stops the clock in add_replica)
            self._lost_at = time.monotonic()
        # while a heal is announced (or recent enough that its
        # announcement may still be coming), stranded/pending work is
        # HELD instead of shed — the heal window must not lose the very
        # requests it exists to save
        hold = self._holding()
        for req in stranded:
            if req.finished:
                continue
            if not survivors and not hold:
                self._finish_err(req, "no_replica",
                                 f"replica {eid} died and no replica "
                                 "survives to replay the request")
            elif req.attempts > self.requeue_limit:
                self._finish_err(
                    req, "replica_failed",
                    f"request lost to replica {eid} after "
                    f"{req.attempts} attempts (re-queue limit "
                    f"{self.requeue_limit})")
            else:
                # replay from scratch on a survivor; decode determinism
                # + the skip counter make the client's stream exact
                self.requeued += 1
                self._m_requests.inc(outcome="requeued", model=_MODEL)
                req.replica = None
                req.skip = len(req.tokens)
                self._pending.appendleft(req)
                self._emit("request_requeued", rid=req.rid, trace=req.trace,
                           from_replica=eid, delivered=len(req.tokens))
        if not survivors and not hold:
            for req in list(self._pending):
                self._finish_err(req, "no_replica", "no replica alive")
            self._pending.clear()
        self._work.notify_all()
