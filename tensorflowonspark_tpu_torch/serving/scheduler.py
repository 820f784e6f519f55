"""Driver-side request scheduler: admission, routing, re-queue on death.

Port of ``tensorflowonspark_tpu/serving/scheduler.py`` over the port's
metrics, observability, tracing and queues, the mesh-sharded gang
bookkeeping included (leaders, shard members, device-weighted capacity).

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
- **Disaggregated routing** (``roles=``; docs/serving.md "Disaggregated
  prefill/decode") — in a role-aware tier a prompt routes only to the
  least-loaded PREFILL gang, which computes the prompt KV and hands the
  session back as a first-class KV-page transfer (``handoff`` response);
  the scheduler then dispatches the session to the DECODE gang with the
  fewest outstanding requests, tie-broken toward MORE free KV pages
  (``op="adopt"``).  The adopt hop continues the same attempt, so the
  requeue-once failover contract spans the handoff boundary: a death on
  either side replays the request exactly once through the full
  prefill→handoff→decode pipeline, skip-dedup keeping the client stream
  oracle-exact.  ``submit`` on a tier whose prefill pool is gone raises
  a typed ``RequestRejected(reason="role_mismatch")`` instead of
  silently queueing a bare prompt on a decode-only gang.
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
    ``no_replica`` (every replica is dead), ``role_mismatch`` (a
    disaggregated tier with no routable prefill-capable replica —
    refusing to queue a bare prompt on a decode-only gang),
    ``unknown_model`` (the request names a ``model`` no replica of this
    tier hosts — docs/serving.md "Multi-model serving")."""

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
                 "trace", "tenant", "priority", "session", "model",
                 "session_version")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 temperature: float, top_p: float, seed: int,
                 deadline: float | None, trace: str | None = None,
                 tenant: str = "default", priority: str = "normal",
                 model: str | None = None):
        self.rid = rid
        self.trace = trace or tracing.new_trace_id()
        self.tenant = tenant
        self.priority = priority
        #: resolved hosting model id (multi-model tiers; None on a
        #: single-model tier) — routing only considers replicas whose
        #: registered model matches
        self.model = model
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
        #: the KV-page session a prefill gang handed back, held only
        #: between the ``handoff`` response and its adopt dispatch —
        #: ``session_version`` pins the VERSION whose weights computed
        #: it (adopt dispatch must match: KV decoded under other
        #: weights would silently emit wrong tokens)
        self.session: dict | None = None
        self.session_version: str | None = None

    def message(self) -> dict:
        """The wire message the replica loop consumes (``trace`` rides
        along so replica-side spans correlate with the driver's)."""
        return {"op": "gen", "rid": self.rid, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature, "top_p": self.top_p,
                "seed": self.seed, "trace": self.trace,
                "model": self.model}


class _Replica:
    """Driver-side view of one routable replica endpoint — a single
    worker, or the LEADER of a mesh-sharded gang (``members`` holds the
    shard workers' executor ids, ``weight`` the gang's device count:
    its capacity contribution to device-weighted signals)."""

    def __init__(self, info: dict, max_inflight: int,
                 members: tuple = (), weight: int = 1,
                 role: str | None = None, model: tuple | None = None):
        self.info = info
        self.eid = int(info["executor_id"])
        self.max_inflight = int(max_inflight)
        self.members = tuple(int(m) for m in members)
        self.weight = max(1, int(weight))
        #: disaggregated-tier specialization: ``"prefill"`` (computes
        #: prompt KV, never decode-steps), ``"decode"`` (only adopts
        #: handed-off sessions and steps them), or None (unified — the
        #: historical replica, serves the whole request)
        self.role = role
        #: multi-model tier: the ``(model_id, version)`` this replica
        #: serves (docs/serving.md "Multi-model serving").  None = the
        #: historical unlabeled replica, which serves any request.
        self.model: str | None = None
        self.version: str | None = None
        if model is not None:
            self.model, self.version = str(model[0]), str(model[1])
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

    def accepts(self, kind: str) -> bool:
        """Whether this replica may take a ``"gen"`` dispatch (unified
        or prefill role) or an ``"adopt"`` one (decode role only)."""
        if kind == "adopt":
            return self.role == "decode"
        return self.role in (None, "prefill")

    def accepts_model(self, model: str | None) -> bool:
        """Whether this replica may serve a request for ``model`` — an
        unlabeled request or replica matches anything (single-model
        tiers keep the historical behavior exactly)."""
        return model is None or self.model is None or self.model == model


class ReplicaScheduler:
    """Routes generate requests over a cluster of ContinuousBatcher
    replicas (see module docstring for policy)."""

    def __init__(self, cluster, *, slots_per_replica: int,
                 overcommit: int = 2, max_queue_depth: int | None = None,
                 poll_interval: float = 0.25, requeue_limit: int = 1,
                 client_factory=None, event_log=None,
                 tenants: dict | None = None, gang_size: int = 1,
                 roles: dict | None = None,
                 model: tuple | None = None,
                 journal=None):
        self.cluster = cluster
        feedable = sorted(
            (n for n in cluster.cluster_info
             if n.get("job_name", "worker") in ("worker", "chief", "master")),
            key=lambda n: n["executor_id"])
        if not feedable:
            raise ValueError("serving cluster has no feedable replicas")
        max_inflight = max(1, int(slots_per_replica) * int(overcommit))
        self._max_inflight = max_inflight  # replicas added live inherit it
        #: processes per routable replica (docs/serving.md "Sharded
        #: replicas"): with gang_size > 1 the workers partition into
        #: contiguous, aligned blocks — block head = the gang LEADER
        #: (the only eid the scheduler routes to / connects queues to),
        #: the rest are shard members whose deaths resolve to the whole
        #: gang.  A gang's weight is its device count, the unit the
        #: autoscaler's device-weighted signals count in; a port process
        #: drives one device, so that is ``gang_size``.
        self.gang_size = max(1, int(gang_size))
        self._weight = self.gang_size
        if len(feedable) % self.gang_size:
            raise ValueError(
                f"serving cluster has {len(feedable)} workers, not a "
                f"multiple of gang_size={self.gang_size}")
        #: role-aware (disaggregated) tier: ``roles`` maps every gang
        #: LEADER eid to ``"prefill"`` or ``"decode"`` (docs/serving.md
        #: "Disaggregated prefill/decode").  Prompts route only to
        #: prefill-capable replicas; handed-off sessions only to decode
        #: gangs.  A plain tier passes no roles and keeps the unified
        #: behavior exactly.
        roles = {int(k): v for k, v in (roles or {}).items()}
        for eid, role in roles.items():
            if role not in ("prefill", "decode"):
                raise ValueError(f"replica {eid}: unknown role {role!r} "
                                 "(want 'prefill' or 'decode')")
        self._has_roles = bool(roles)
        self.replicas: dict[int, _Replica] = {}
        self._gang_leader: dict[int, int] = {}  # every gang eid -> leader
        for i in range(0, len(feedable), self.gang_size):
            block = feedable[i:i + self.gang_size]
            ids = [int(n["executor_id"]) for n in block]
            if ids != list(range(ids[0], ids[0] + self.gang_size)) \
                    or ids[0] % self.gang_size:
                raise ValueError(
                    f"gang block {ids} is not a contiguous, "
                    f"gang_size-aligned executor range "
                    f"(gang_size={self.gang_size})")
            if self._has_roles and ids[0] not in roles:
                raise ValueError(
                    f"role-aware tier: replica {ids[0]} has no role "
                    f"(roles cover {sorted(roles)})")
            self.replicas[ids[0]] = _Replica(
                block[0], max_inflight, members=tuple(ids[1:]),
                weight=self._weight, role=roles.get(ids[0]), model=model)
            for e in ids:
                self._gang_leader[e] = ids[0]
        #: default model id (multi-model tiers): requests that name no
        #: ``model`` resolve to the founding replicas' label
        self.default_model = None if model is None else str(model[0])
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
        #: write-ahead control-plane journal (``serving/journal.py``):
        #: the recovery source of truth a resumed driver replays — every
        #: admission/route/commit/membership/split transition appends an
        #: fsync'd record BEFORE (admissions) or as (the rest) it becomes
        #: observable.  None keeps the historical non-durable behavior.
        self.journal = journal
        if journal is not None:
            for jeid, jrep in sorted(self.replicas.items()):
                journal.record("replica_added", replica=jeid,
                               members=list(jrep.members), role=jrep.role,
                               model=jrep.model, version=jrep.version)
        self._pending = _PendingQueue()
        #: sessions a prefill gang handed back, awaiting their adopt
        #: dispatch onto a decode gang (FIFO; dispatched ahead of new
        #: prompts — their prefill compute is already spent)
        self._pending_handoff: collections.deque = collections.deque()
        self.handoffs = 0
        #: in-flight replacements by pool (role, or None for unified):
        #: while a heal is pending, dispatch QUEUES that pool's work
        #: instead of fail-fasting on "no survivor" (expect_replica)
        self._expected_roles: dict = {}
        #: seconds dispatch keeps a pool's work queued after its LAST
        #: acceptor dies, bridging death-detection (the recv loop's
        #: requeue fires sub-second) to the tier's heal announcing
        #: itself via :meth:`expect_replica` (the monitor classifies the
        #: crash on its poll cadence).  0 = shed immediately (tiers with
        #: no heal path keep the typed fail-fast); tiers that configure
        #: heals (warm standbys / replace_failed) set this.
        self.heal_grace = 0.0
        self._pool_lost_at: dict = {}
        #: model id -> monotonic time its LAST hosting replica died —
        #: the per-model heal-grace clock (a multi-model tier healing
        #: one model's gang must queue, not shed, that model's traffic)
        self._model_lost_at: dict[str, float] = {}
        #: model id -> {"shares": [(version, pct)], "credit": {version:
        #: float}} — smooth weighted round-robin state (set_traffic_
        #: split): exact proportions over any window, evenly interleaved
        self._traffic: dict[str, dict] = {}
        #: per-(model, version) live stats — the rollout gate's feedback
        #: signal (completed/failed counts + ttft/e2e histograms)
        self._mv_stats: dict[tuple, dict] = {}
        #: eid -> waiter record for an in-flight model hot swap
        self._swap_waiters: dict[int, dict] = {}
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
        # the ``model`` label keeps two hosted models' series apart
        # (bounded cardinality: label values come from the registered
        # model set; single-model tiers collapse to model="default")
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
        self._g_handoff_depth = reg.gauge(
            "tfos_serving_handoff_queue_depth_count",
            "Handed-off sessions awaiting their decode-gang adopt "
            "dispatch (disaggregated tiers; 0 otherwise).")
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
        self._g_capacity = reg.gauge(
            "tfos_serving_capacity_devices_count",
            "Device-weighted routable capacity: sum of alive, "
            "non-draining replica gang weights.")
        reg.add_collect_hook(self._collect_gauges)
        # audit events are enqueued (GIL-atomic append) and written by a
        # dedicated thread: a stalled disk must never block the request
        # path, which emits under the global scheduler lock
        self._event_q: collections.deque = collections.deque()
        self._event_wake = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaScheduler":
        self._emit("scheduler_started", replicas=sorted(self.replicas),
                   max_queue_depth=self.max_queue_depth,
                   roles={eid: rep.role
                          for eid, rep in self.replicas.items()
                          if rep.role is not None} or None)
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
            leftovers = list(self._pending) \
                + list(self._pending_handoff) + [
                r for rep in self.replicas.values()
                for r in rep.outstanding.values()]
            self._pending.clear()
            self._pending_handoff.clear()
            for rep in self.replicas.values():
                rep.outstanding.clear()
            for req in leftovers:
                if not req.finished:
                    self._finish_err(req, "shutdown",
                                     "scheduler stopped before completion")
            for rec in self._swap_waiters.values():
                rec["error"] = "scheduler stopped mid-swap"
                rec["event"].set()
            self._swap_waiters.clear()
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
        self._g_handoff_depth.remove()
        self._g_alive.remove()
        self._g_capacity.remove()
        for rep in self.replicas.values():
            self._close_clients(rep)
        self._drain_events()     # anything emitted after the writer exited
        if self._own_events and self.events is not None:
            self.events.close()
            self.events = None
            self._own_events = False

    def crash(self) -> None:
        """Hard-stop the control plane WITHOUT the shutdown courtesies —
        the in-process equivalent of SIGKILLing a standalone driver
        (driver-scope chaos; docs/robustness.md "Control-plane
        failover").  Queued and in-flight requests are NOT failed,
        drained, or journaled, and the journal handle is dropped FIRST
        so nothing the crash path does is ever recorded: what the
        journal already holds is exactly what a real kill would leave
        behind, and ``serving.failover.resume_driver`` replays it."""
        self.journal = None      # a dying driver writes nothing more
        with self._lock:
            self._stop.set()
            self._work.notify_all()
            # release swap waiters so tier threads blocked in wait_swap
            # observe the death instead of hanging a full timeout
            for rec in self._swap_waiters.values():
                rec["error"] = "driver crashed mid-swap"
                rec["event"].set()
            self._swap_waiters.clear()
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        _metrics.get_registry().remove_collect_hook(self._collect_gauges)
        for eid in self.replicas:
            self._g_outstanding.remove(replica=str(eid))
            self._g_load.remove(replica=str(eid))
        self._g_depth.remove()
        self._g_handoff_depth.remove()
        self._g_alive.remove()
        self._g_capacity.remove()
        for rep in self.replicas.values():
            self._close_clients(rep)
        # pending/outstanding/_requests stay AS-IS: a killed process
        # fails no one — the obligations live in the journal now
        if self._own_events and self.events is not None:
            self.events.close()
            self.events = None
            self._own_events = False

    # -- driver failover (serving/failover.py) -----------------------------
    def adopt(self, state) -> dict:
        """Apply a replayed :class:`~tensorflowonspark_tpu_torch.serving.
        journal.JournalState` to this freshly constructed, NOT yet
        started scheduler — the driver half of the PR-12 heal
        discipline (``serving.failover.resume_driver``).

        Journal-dead/retired gangs never route again, hot-swap labels
        survive, traffic splits restore, and every accepted-but-
        uncommitted admission re-queues as a NEW request under the
        requeue-once discipline.  The replay deliberately mints FRESH
        rids: a surviving replica may still be streaming the OLD rid,
        and those stale messages must miss ``outstanding`` and drop
        (the replica-death requeue's exact discipline) instead of
        interleaving with the replay — a ``requeue {rid, as}`` alias
        record ties the new rid back to the original admission, so
        zero-loss accounting and a SECOND failover both resolve commits
        through the chain.  Corrective ``replica_model``/dead/retired
        records are re-journaled because this constructor just appended
        founding ``replica_added`` lines with its default labels; a
        second replay must not resurrect those.

        Returns ``{"requeued": {trace: ServeRequest}, "done": {trace:
        n_tokens}}`` — what the frontend needs to re-attach
        reconnecting clients (mid-stream resumes, and streams whose
        commit landed just before the kill)."""
        with self._lock:
            # never reuse a journaled rid: a fresh admission sharing an
            # old rid would collide with its alias/commit history
            top = max((int(r) for r in (*state.admitted, *state.aliases,
                                        *state.committed)), default=-1)
            self._ids = itertools.count(top + 1)
            for eid, ent in sorted(state.replicas.items()):
                rep = self.replicas.get(int(eid))
                if rep is None:
                    logger.warning(
                        "journal replica %s has no reservation in the "
                        "resumed cluster; skipping", eid)
                    continue
                if "model" in ent:
                    rep.model = ent.get("model")
                    rep.version = (None if ent.get("version") is None
                                   else str(ent["version"]))
                if ent.get("retired"):
                    rep.alive = False
                    rep.retired = True
                elif ent.get("alive") is False:
                    rep.alive = False
                if self.journal is not None:
                    self.journal.record("replica_model", replica=int(eid),
                                        model=rep.model,
                                        version=rep.version)
                    if rep.retired:
                        self.journal.record("replica_retired",
                                            replica=int(eid))
                    elif not rep.alive:
                        self.journal.record("replica_dead",
                                            replica=int(eid))
            for model_id, split in state.traffic.items():
                if split:
                    items = [(str(v), float(p)) for v, p in split.items()]
                    self._traffic[str(model_id)] = {
                        "shares": items,
                        "credit": {v: 0.0 for v, _ in items}}
            done: dict[str, int] = {}
            for orig, rec in state.committed.items():
                trace = (state.admitted.get(orig) or {}).get("trace")
                if trace and rec.get("outcome") == "done":
                    done[trace] = int(rec.get("tokens") or 0)
            requeued: dict[str, ServeRequest] = {}
            for orig, rec in sorted(state.unfinished.items()):
                rid = next(self._ids)
                prio = rec.get("priority")
                req = ServeRequest(
                    rid, rec.get("prompt") or [],
                    int(rec.get("max_new_tokens") or 1),
                    float(rec.get("temperature") or 0.0),
                    float(rec.get("top_p") or 1.0),
                    int(rec.get("seed") or 0),
                    # the wall-clock budget died with the old driver;
                    # the frontend's resume path re-bounds the wait
                    deadline=None,
                    trace=rec.get("trace"),
                    tenant=str(rec.get("tenant") or "default"),
                    priority=(prio if prio in PRIORITIES else "normal"),
                    model=rec.get("model"))
                self._requests[rid] = req
                self._pending.append(req)
                self.requeued += 1
                self._m_requests.inc(outcome="requeued",
                                     model=req.model or "default")
                if self.journal is not None:
                    self.journal.record("requeue",
                                        **{"rid": int(orig), "as": rid})
                self._emit("request_requeued", rid=rid, trace=req.trace,
                           from_replica=None, delivered=0,
                           orig_rid=int(orig), failover=True)
                if req.trace:
                    requeued[req.trace] = req
            self._work.notify_all()
            return {"requeued": requeued, "done": done}

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait for the queue and every replica's in-flight set to empty;
        False if ``timeout`` elapses first."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._pending) or bool(self._pending_handoff) \
                    or any(rep.outstanding
                           for rep in self.replicas.values())
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
        requests into the high band.  ``model`` routes the request to
        the replicas hosting that model on a multi-model tier (None =
        the tier's default model); an unhosted model is rejected typed
        ``unknown_model``."""
        with self._lock:
            if self._stop.is_set():
                raise RequestRejected("shutdown", "serving tier is stopping")
            if not any(rep.alive for rep in self.replicas.values()):
                raise RequestRejected("no_replica", "no replica alive")
            if self._has_roles and not any(
                    rep.alive and not rep.draining and rep.accepts("gen")
                    for rep in self.replicas.values()):
                # fail typed at ADMISSION, not after a silent queue on a
                # decode-only gang that will never prefill the prompt
                raise RequestRejected(
                    "role_mismatch",
                    "no prefill-capable replica is routable: refusing to "
                    "queue a bare prompt on a decode-only gang")
            model = self._resolve_model(model)
            mdl = model or "default"
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
                self._m_requests.inc(outcome="shed", model=mdl)
                self._m_tenant.inc(tenant=ten.name, outcome="queue_full")
                raise RequestRejected(
                    "queue_full",
                    f"serving queue full ({depth} >= "
                    f"{self.max_queue_depth} queued+in-flight)")
            if ten.bucket is not None and not ten.bucket.try_take():
                ten.shed += 1
                self.shed += 1
                self._m_requests.inc(outcome="shed", model=mdl)
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
                tenant=ten.name, priority=eff_priority, model=model)
            # WRITE-AHEAD: the zero-loss contract attaches at admission,
            # so the accept is durable BEFORE it is observable anywhere
            # (queue entry, counters, the caller's return) — a driver
            # killed one instruction later still owes this request, and
            # journal replay re-queues it
            if self.journal is not None:
                self.journal.record(
                    "admit", rid=rid,
                    prompt=[int(t) for t in req.prompt.tolist()],
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_p=req.top_p,
                    seed=req.seed, tenant=ten.name,
                    priority=eff_priority, model=model, trace=req.trace)
            self._requests[rid] = req
            self._pending.append(req)
            self.accepted += 1
            ten.accepted += 1
            self._m_requests.inc(outcome="accepted", model=mdl)
            self._m_tenant.inc(tenant=ten.name, outcome="accepted")
            self._emit("request_admitted", rid=rid, trace=req.trace,
                       depth=depth, tenant=ten.name, priority=eff_priority,
                       model=model)
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
            with contextlib.suppress(ValueError):
                self._pending_handoff.remove(req)
            req.session = None
            if req.replica is not None:
                rep = self.replicas.get(req.replica)
                if rep is not None:
                    rep.outstanding.pop(req.rid, None)
                    self._work.notify_all()
            if reason == "expired":
                self.expired += 1
                self._m_requests.inc(outcome="expired",
                                     model=req.model or "default")
            else:
                self.abandoned += 1
                self._m_requests.inc(outcome="abandoned",
                                     model=req.model or "default")
            self._emit("request_failed", rid=req.rid, trace=req.trace,
                       reason=reason)
            if self.journal is not None:
                self.journal.record("commit", rid=req.rid, outcome=reason,
                                    tokens=len(req.tokens))

    # -- failure intake ----------------------------------------------------
    def on_cluster_failure(self, failure) -> None:
        """`ClusterMonitor` subscriber: classified crash/hang/preemption.
        A gang SHARD's death resolves to its leader — killing one shard
        of a tp=4 gang kills the whole routable replica, once."""
        with self._lock:
            for eid in getattr(failure, "failed_workers", ()):  # noqa: B007
                eid = int(eid)
                leader = self._gang_leader.get(eid, eid)
                shard = "" if leader == eid else f" (gang shard {eid})"
                self._mark_dead(leader,
                                f"{getattr(failure, 'kind', 'failure')}"
                                f"{shard}: {failure}")

    def resolve_gang(self, executor_id: int) -> int:
        """The gang LEADER (= routable replica id) owning ``executor_id``
        — identity for non-gang members/unknown ids."""
        with self._lock:
            return self._gang_leader.get(int(executor_id), int(executor_id))

    def gang_members(self, executor_id: int) -> tuple[int, ...]:
        """Every executor id in ``executor_id``'s gang, leader first
        (``(executor_id,)`` when unknown)."""
        with self._lock:
            leader = self._gang_leader.get(int(executor_id),
                                           int(executor_id))
            rep = self.replicas.get(leader)
            if rep is None:
                return (int(executor_id),)
            return (leader, *rep.members)

    def peer_replica_info(self, exclude=(),
                          model: tuple | None = None) -> dict | None:
        """Reservation info of the least-loaded alive, non-draining
        replica — the clone SOURCE a promoted warm standby pulls weights
        from; None when no healthy peer exists (the promotion then falls
        back to checkpoint restore via the model builder).  ``model``
        restricts the peer to replicas serving that exact ``(model_id,
        version)`` — weights cloned across versions would silently serve
        the wrong model under the new label."""
        with self._lock:
            best = None
            for eid, rep in self.replicas.items():
                if not rep.alive or rep.draining or eid in exclude:
                    continue
                if model is not None and (rep.model, rep.version) \
                        != (str(model[0]), str(model[1])):
                    continue
                if best is None \
                        or len(rep.outstanding) < len(best.outstanding):
                    best = rep
            return None if best is None else dict(best.info)

    def _resolve_model(self, model) -> str | None:
        """Admission-time model resolution (lock held): None falls back
        to the tier's default model; a named model must be hosted by at
        least one ALIVE replica (draining included — it still finishes
        work) or be inside its heal-grace window (a dead-but-healing
        model's traffic queues rather than shedding).  A model whose
        last gang died with no heal coming rejects typed — admitting it
        would burn queue depth and tenant tokens on requests that can
        only ever fail ``no_replica``."""
        if model is None:
            return self.default_model
        model = str(model)
        hosted = {rep.model for rep in self.replicas.values()
                  if rep.model is not None and rep.alive}
        if model not in hosted and not self._model_heal_active(model):
            raise RequestRejected(
                "unknown_model",
                f"model {model!r} is not (or no longer) hosted by this "
                f"tier (hosted: {sorted(hosted) or 'none'})")
        return model

    def _model_heal_active(self, model: str | None) -> bool:
        """True while a just-lost model's last hosting gang may still be
        healing (lock held by caller) — the per-model twin of
        :meth:`_heal_grace_active`, cleared when a fresh replica of the
        model registers."""
        if model is None or self.heal_grace <= 0:
            return False
        t0 = self._model_lost_at.get(model)
        return t0 is not None and (time.monotonic() - t0) < self.heal_grace

    # -- multi-model hosting (docs/serving.md "Multi-model serving") ------
    def model_versions(self, model_id: str) -> dict[str, list[int]]:
        """``{version: [leader eids]}`` of the ALIVE replicas hosting
        ``model_id`` (draining included — they still finish work)."""
        with self._lock:
            out: dict[str, list[int]] = {}
            for eid, rep in self.replicas.items():
                if rep.alive and not rep.retired \
                        and rep.model == str(model_id):
                    out.setdefault(rep.version or "", []).append(eid)
            return {v: sorted(e) for v, e in out.items()}

    def replicas_of(self, model_id: str,
                    version: str | None = None) -> list[int]:
        """Routable (alive, non-draining) leader eids hosting
        ``model_id`` (optionally one version)."""
        with self._lock:
            return sorted(
                eid for eid, rep in self.replicas.items()
                if rep.alive and not rep.draining
                and rep.model == str(model_id)
                and (version is None or (rep.version or "")
                     == str(version)))

    def replica_model_version(self, eid: int) -> tuple | None:
        """The ``(model_id, version)`` replica ``eid`` registered with
        (None for unlabeled/unknown) — replacement spawns re-arm the
        SAME model."""
        with self._lock:
            rep = self.replicas.get(int(eid))
            if rep is None or rep.model is None:
                return None
            return (rep.model, rep.version)

    def replica_info(self, eid: int) -> dict | None:
        """The reservation info dict of replica ``eid`` (None when
        unknown) — the address a prefix-page donation replies to."""
        with self._lock:
            rep = self.replicas.get(int(eid))
            return None if rep is None else dict(rep.info)

    def prefix_donor(self, exclude=(),
                     model: tuple | None = None) -> int | None:
        """The least-outstanding alive PREFILL gang eligible to donate
        its prefix-cache pages (docs/serving.md "Prefix-page donation"):
        prefill pools hold the hottest prompt prefixes, and donated
        pages must come from a replica serving the SAME (model, version)
        — KV computed under other weights would decode wrong tokens."""
        with self._lock:
            best = None
            for eid, rep in self.replicas.items():
                if not rep.alive or rep.draining or eid in exclude \
                        or rep.role != "prefill":
                    continue
                if model is not None and (rep.model, rep.version) \
                        != (str(model[0]), str(model[1])):
                    continue
                if best is None \
                        or len(rep.outstanding) < len(best.outstanding):
                    best = rep
            return None if best is None else best.eid

    def model_version_stats(self, model_id: str,
                            base: dict | None = None) -> dict:
        """Per-version live snapshot for one model — completed/failed
        counts (cumulative) plus ttft/e2e percentile summaries, the
        rollout gate's feedback signal.  With ``base`` (a PRIOR return
        value of this method), the latency summaries cover only the
        samples recorded since the base — windowed percentiles, so a
        canary gate compares the bake window on BOTH sides instead of a
        fresh canary histogram vs the incumbent's warm-up-polluted
        history (``RolloutController._bake_and_gate``)."""
        model_id = str(model_id)
        with self._lock:
            for rep in self.replicas.values():
                if rep.model == model_id:
                    self._mv(rep)           # materialize hosted versions
            out = {}
            for (mid, ver), mv in self._mv_stats.items():
                if mid != model_id:
                    continue
                b = (base or {}).get(ver) or {}
                out[ver] = {
                    "completed": mv["completed"],
                    "failed": mv["failed"],
                    "ttft": mv["ttft"].summary() if base is None
                    else mv["ttft"].window_summary(
                        (b.get("ttft") or {}).get("count", 0)),
                    "e2e": mv["e2e"].summary() if base is None
                    else mv["e2e"].window_summary(
                        (b.get("e2e") or {}).get("count", 0)),
                }
            return out

    def _mv(self, rep) -> dict | None:
        """The (model, version) stats bucket for ``rep``'s label (lock
        held by caller); None for unlabeled replicas."""
        if rep is None or rep.model is None:
            return None
        key = (rep.model, rep.version or "")
        mv = self._mv_stats.get(key)
        if mv is None:
            mv = self._mv_stats[key] = {
                "completed": 0, "failed": 0,
                "ttft": observability.LatencyHistogram(),
                "e2e": observability.LatencyHistogram()}
        return mv

    def set_traffic_split(self, model_id: str, split: dict) -> None:
        """Declarative per-model version split: ``{version: percent}``
        (positive percents summing to 100).  Dispatch runs smooth
        weighted round-robin over the versions — deterministic AND
        evenly interleaved, so a 10% canary sees every ~10th dispatched
        request (exact proportions over any 100-dispatch window), not a
        coin flip and not the first 10 of each 100 — falling back
        across the model's other versions when the target has no spare
        capacity (availability over split fidelity).
        :meth:`clear_traffic_split` restores pure least-outstanding
        routing."""
        model_id = str(model_id)
        items = [(str(v), float(p)) for v, p in dict(split).items()]
        if not items or any(p <= 0 for _, p in items) \
                or abs(sum(p for _, p in items) - 100.0) > 1e-6:
            raise ValueError(f"traffic split must be positive percents "
                             f"summing to 100, got {split!r}")
        with self._work:
            self._traffic[model_id] = {
                "shares": items, "credit": {v: 0.0 for v, _ in items}}
            self._emit("traffic_split", model=model_id,
                       split={v: p for v, p in items})
            if self.journal is not None:
                self.journal.record("traffic_split", model=model_id,
                                    split={v: p for v, p in items})
            self._work.notify_all()

    def clear_traffic_split(self, model_id: str) -> None:
        with self._work:
            if self._traffic.pop(str(model_id), None) is not None:
                self._emit("traffic_split", model=str(model_id),
                           split=None)
                if self.journal is not None:
                    self.journal.record("traffic_split",
                                        model=str(model_id), split=None)
                self._work.notify_all()

    def resume_replica(self, eid: int) -> bool:
        """Clear a replica's draining flag and resume routing to it —
        the model-swap path un-drains after a completed (or failed,
        still-serving-the-old-version) swap.  Retired/dead replicas
        never resume."""
        with self._work:
            rep = self.replicas.get(int(eid))
            if rep is None or not rep.alive or rep.retired:
                return False
            rep.draining = False
            self._work.notify_all()
            return True

    def expect_swap(self, eid: int, token: str | None = None) -> dict:
        """Register a waiter for replica ``eid``'s next hot-swap ack
        (``model_swapped`` / ``model_swap_failed`` on its response
        channel); a death mid-swap or scheduler stop releases the waiter
        with an error.  ``token`` (echoed by the worker as
        ``swap_token``) pins the waiter to ONE swap message: a late ack
        from a PREVIOUS timed-out swap relabels the replica but cannot
        release a retry's waiter.  Pair with :meth:`wait_swap`."""
        rec = {"event": threading.Event(), "ok": False, "error": None,
               "eid": int(eid), "token": token}
        with self._lock:
            self._swap_waiters[int(eid)] = rec
        return rec

    def wait_swap(self, rec: dict, timeout: float) -> tuple[bool, str]:
        rec["event"].wait(timeout)
        if not rec["event"].is_set():
            # unregister THIS waiter: a stale entry would let the
            # timed-out swap's late ack release a later retry's waiter
            with self._lock:
                if self._swap_waiters.get(rec["eid"]) is rec:
                    del self._swap_waiters[rec["eid"]]
            return False, f"no swap ack within {timeout:.0f}s"
        return bool(rec["ok"]), rec.get("error") or ""

    def dead_replicas(self) -> set[int]:
        """Every executor id lost to FAILURE — for a dead gang that is
        the leader AND its shard members, so shutdown's handled-worker
        tolerance covers the whole gang's corpses (cleanly retired
        members excluded)."""
        with self._lock:
            return {e for eid, rep in self.replicas.items()
                    if not rep.alive and not rep.retired
                    for e in (eid, *rep.members)}

    def alive_replicas(self) -> set[int]:
        with self._lock:
            return {eid for eid, rep in self.replicas.items() if rep.alive}

    def replica_role(self, eid: int) -> str | None:
        """The registered role of replica ``eid`` (None for unified or
        unknown) — replacement spawns re-arm the SAME pool."""
        with self._lock:
            rep = self.replicas.get(int(eid))
            return None if rep is None else rep.role

    def draining_replicas(self) -> set[int]:
        with self._lock:
            return {eid for eid, rep in self.replicas.items()
                    if rep.alive and rep.draining}

    # -- elastic membership ------------------------------------------------
    def expect_replica(self, role: str | None = None) -> None:
        """Announce an in-flight replacement for ``role``'s pool (warm
        promotion or cold spawn; ``None`` = unified tier).  Until the
        matching :meth:`expect_done`, the dispatch loop QUEUES work for
        that pool instead of fail-fasting on "no survivor" — a heal
        window must not shed the very requests it exists to save.
        Deadlines and client timeouts still bound the wait."""
        with self._work:
            self._expected_roles[role] = \
                self._expected_roles.get(role, 0) + 1

    def expect_done(self, role: str | None = None) -> None:
        """The announced replacement registered — or the heal gave up;
        either way dispatch resumes its normal no-survivor handling."""
        with self._work:
            n = self._expected_roles.get(role, 0) - 1
            if n > 0:
                self._expected_roles[role] = n
            else:
                self._expected_roles.pop(role, None)
            self._work.notify_all()

    def _expecting(self, kind: str) -> bool:
        # under the lock; dispatch kind -> the pool that serves it
        role = "decode" if kind == "adopt" else "prefill"
        return bool(self._expected_roles.get(role)
                    or self._expected_roles.get(None))

    def _heal_grace_active(self, kind: str) -> bool:
        """True while a just-lost pool's work should stay queued awaiting
        the heal's ``expect_replica`` — bounded by ``heal_grace`` so a
        heal that never comes still fails typed (lock held by caller).
        The clock is anchored at the DEATH that emptied the pool
        (``_mark_dead``), not at the first dispatch attempt — a request
        arriving minutes after a heal already gave up must fail fast,
        not stall a full grace window."""
        if self.heal_grace <= 0:
            return False
        t0 = self._pool_lost_at.get(kind)
        return t0 is not None and (time.monotonic() - t0) < self.heal_grace

    def add_replica(self, info: dict, members: tuple = (),
                    role: str | None = None,
                    model: tuple | None = None) -> None:
        """Register a freshly reserved replica worker and start routing
        to it (live scale-up / preemption replacement).  ``info`` is the
        node's reservation dict, exactly as ``cluster_info`` carries it;
        ``members`` the shard workers of a gang replica (their deaths
        resolve to this endpoint, like the founding gangs').  In a
        role-aware (disaggregated) tier ``role`` is mandatory — an
        unspecialized replica cannot join specialized pools.  ``model``
        labels the newcomer with the ``(model_id, version)`` it serves
        (multi-model tiers; deploys and re-armed heals pass it)."""
        eid = int(info["executor_id"])
        members = tuple(int(m) for m in members)
        if len(members) != self.gang_size - 1:
            raise ValueError(
                f"replica {eid} registered with {len(members)} gang "
                f"member(s); this tier's gang_size={self.gang_size} "
                f"needs {self.gang_size - 1}")
        if members != tuple(range(eid + 1, eid + self.gang_size)) or eid % self.gang_size:
            raise ValueError(
                f"gang block {[eid, *members]} is not a contiguous, "
                f"gang_size-aligned executor range (gang_size={self.gang_size})")
        if role is not None and role not in ("prefill", "decode"):
            raise ValueError(f"unknown role {role!r} "
                             "(want 'prefill' or 'decode')")
        if self._has_roles and role is None:
            raise ValueError(
                f"role-aware tier: add_replica({eid}) needs role= "
                "('prefill' or 'decode')")
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("scheduler is stopping")
            existing = self.replicas.get(eid)
            if existing is not None and existing.alive:
                raise ValueError(f"replica {eid} already registered")
            rep = _Replica(info, self._max_inflight, members=members,
                           weight=self._weight, role=role, model=model)
            self.replicas[eid] = rep
            for e in (eid, *members):
                self._gang_leader[e] = eid
            self._has_roles = self._has_roles or role is not None
            # a fresh acceptor resets the lost-pool clock for every
            # dispatch kind it serves (unified replicas serve both)
            if role in (None, "decode"):
                self._pool_lost_at.pop("adopt", None)
            if role in (None, "prefill"):
                self._pool_lost_at.pop("gen", None)
            if rep.model is not None:
                # the model is hosted again: its heal-grace clock stops
                self._model_lost_at.pop(rep.model, None)
            self._m_scale.inc(change="added")
            self._emit("replica_added", replica=eid,
                       members=list(members), weight=rep.weight,
                       role=role, model=rep.model, version=rep.version,
                       alive=sum(1 for r in self.replicas.values()
                                 if r.alive))
            if self.journal is not None:
                self.journal.record("replica_added", replica=eid,
                                    members=list(members), role=role,
                                    model=rep.model, version=rep.version)
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
            if self.journal is not None:
                self.journal.record("replica_retired", replica=eid)
            for req in stranded:
                if req.finished:
                    continue
                self.requeued += 1
                self._m_requests.inc(outcome="requeued",
                                     model=req.model or "default")
                req.attempts = max(0, req.attempts - 1)
                req.replica = None
                req.session = None
                req.session_version = None
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
            self._g_handoff_depth.set(len(self._pending_handoff))
            alive = 0
            capacity = 0
            for eid, rep in self.replicas.items():
                if rep.alive:
                    self._g_outstanding.set(len(rep.outstanding),
                                            replica=str(eid))
                    self._g_load.set(rep.reported_load, replica=str(eid))
                    alive += 1
                    if not rep.draining:
                        capacity += rep.weight
                else:
                    # a retired replica must stop being reported, not
                    # freeze at its last values
                    self._g_outstanding.remove(replica=str(eid))
                    self._g_load.remove(replica=str(eid))
            self._g_alive.set(alive)
            self._g_capacity.set(capacity)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "accepted": self.accepted, "completed": self.completed,
                "shed": self.shed, "expired": self.expired,
                "abandoned": self.abandoned,
                "failed": self.failed, "requeued": self.requeued,
                "queued": len(self._pending),
                "handoffs": self.handoffs,
                "queued_handoffs": len(self._pending_handoff),
                "ttft": self.ttft.summary(), "e2e": self.e2e.summary(),
                "gang_size": self.gang_size,
                # device-weighted capacity: what the autoscaler's
                # queue-pressure signal divides by — a tp=4 gang counts
                # 4 capacity units, not 1 and not 4 replicas
                "capacity_devices": sum(
                    rep.weight for rep in self.replicas.values()
                    if rep.alive and not rep.draining),
                "replicas": {
                    eid: {"alive": rep.alive, "draining": rep.draining,
                          "retired": rep.retired,
                          "outstanding": len(rep.outstanding),
                          "reported_load": rep.reported_load,
                          "weight": rep.weight,
                          "members": list(rep.members),
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
                          "role": rep.role,
                          "model": rep.model,
                          "version": rep.version,
                          "served": rep.served}
                    for eid, rep in self.replicas.items()},
                # multi-model hosting view: per-(model, version) request
                # counts + the replicas serving each (the rollout gate
                # reads the richer model_version_stats())
                "models": {
                    mid: {ver: {"completed": mv["completed"],
                                "failed": mv["failed"]}
                          for (m, ver), mv in self._mv_stats.items()
                          if m == mid}
                    for mid in {m for m, _ in self._mv_stats}},
                "traffic": {
                    mid: {v: p for v, p in split["shares"]}
                    for mid, split in self._traffic.items()},
                "tenants": {
                    name: {"accepted": t.accepted, "shed": t.shed,
                           "priority": t.priority,
                           "rate": None if t.bucket is None
                           else t.bucket.rate}
                    for name, t in self.tenants.items()},
            }

    def emit_event(self, kind: str, **fields) -> None:
        """Public audit-event hook for tier components that share this
        scheduler's ``serving_events.jsonl`` (the autoscaler's scale
        events ride here so one log tells the whole membership story)."""
        with self._lock:
            self._emit(kind, **fields)

    def journal_record(self, kind: str, **fields) -> None:
        """None-safe write-ahead journal append — tier components whose
        state must survive a driver failover (the registry, the rollout
        controller's step intents) record through here."""
        if self.journal is not None:
            self.journal.record(kind, **fields)

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

    def _pick_replica(self, kind: str = "gen",
                      model: str | None = None,
                      version: str | None = None) -> _Replica | None:
        """Least-outstanding alive replica with spare in-flight capacity
        (ties by last self-reported batcher load, then by KV-page
        pressure — MORE free pages wins, so long prompts stop landing
        on memory-starved replicas, and a handed-off session seats on
        the decode gang with the most page headroom); None when
        saturated.  Draining replicas take no new work.  ``kind``
        selects the pool in a role-aware tier: ``"gen"`` considers
        unified/prefill replicas, ``"adopt"`` decode gangs only.
        ``model`` restricts to replicas hosting that model and
        ``version`` (adopt dispatches: the version whose weights
        computed the handed-off KV) to that exact version; an active
        traffic split additionally targets the version smooth-weighted-
        round-robin picks next (deterministic, evenly interleaved
        canary proportions), falling back to the model's other versions
        when the target has no spare capacity."""
        split = (self._traffic.get(model)
                 if model is not None and kind == "gen" else None)
        target = None
        if split:
            # tentative SWRR pick — committed only on a real dispatch
            credit = split["credit"]
            target = max(split["shares"],
                         key=lambda vp: credit[vp[0]] + vp[1])[0]
        best = best_key = None
        best_t = best_t_key = None
        for rep in self.replicas.values():
            if not rep.alive or rep.draining or not rep.accepts(kind) \
                    or not rep.accepts_model(model) \
                    or (version is not None and rep.version != version) \
                    or len(rep.outstanding) >= rep.max_inflight:
                continue
            key = (len(rep.outstanding), rep.reported_load,
                   -rep.reported_free_pages)
            if best is None or key < best_key:
                best, best_key = rep, key
            if target is not None and (rep.version or "") == target \
                    and (best_t is None or key < best_t_key):
                best_t, best_t_key = rep, key
        chosen = best_t if best_t is not None else best
        if chosen is not None and split:
            # commit the SWRR step, charging the version that actually
            # serves (a saturated target's unspent credit accumulates,
            # so it catches up as soon as capacity frees)
            credit = split["credit"]
            for v, p in split["shares"]:
                # clamp at one full round: normal SWRR never exceeds
                # it, and a version with NO routable replica (dead
                # canary awaiting its heal) cannot bank unbounded
                # credit that would burst all traffic onto it the
                # moment capacity returns
                credit[v] = min(credit[v] + p, 100.0)
            charged = (chosen.version
                       if chosen.version in credit else target)
            credit[charged] -= 100.0
        return chosen

    # -- dispatch ----------------------------------------------------------
    def _scan_queue(self, queue_, kind: str):
        """First dispatchable request in ``queue_`` (lock held): scans
        PAST work whose model/pool is merely saturated or healing —
        one saturated model must never head-of-line block another's
        traffic — while expiring deadline-passed requests and failing
        (typed) work with no surviving acceptor and no heal in flight.
        FIFO within a (priority, model) class is preserved: every
        request of a class sees the same candidate set, so the head
        dispatches first.  A class found saturated is probed ONCE per
        scan (``stuck`` memo) — a deep backlog costs O(classes x
        replicas) per scan under the lock, not O(pending x replicas).
        Returns ``(req, rep)`` or None."""
        stuck: set = set()
        for req in list(queue_):
            if req.finished:
                with contextlib.suppress(ValueError):
                    queue_.remove(req)
                continue
            if req.deadline is not None \
                    and time.monotonic() > req.deadline:
                with contextlib.suppress(ValueError):
                    queue_.remove(req)
                self._expire(req)
                continue
            pin = req.session_version if kind == "adopt" else None
            if (req.model, pin) in stuck:
                continue        # this class already probed saturated
            rep = self._pick_replica(kind, model=req.model, version=pin)
            if rep is not None:
                with contextlib.suppress(ValueError):
                    queue_.remove(req)
                return req, rep
            # no capacity right now: does ANY acceptor for this work
            # survive?  Fail typed if not — UNLESS a heal is in flight
            # (expect_replica) or recent enough that its announcement
            # may still be coming (heal_grace / the model's own clock),
            # in which case the work stays queued
            if not any(r.alive and r.accepts(kind)
                       and r.accepts_model(req.model)
                       and (pin is None or r.version == pin)
                       for r in self.replicas.values()) \
                    and not self._expecting(kind) \
                    and not self._heal_grace_active(kind) \
                    and not self._model_heal_active(req.model):
                with contextlib.suppress(ValueError):
                    queue_.remove(req)
                if kind == "adopt":
                    self._finish_err(
                        req, "no_replica",
                        "no decode gang survives to adopt the "
                        "handed-off session"
                        + (f" (version {pin})" if pin else ""))
                elif req.model is not None and any(
                        r.alive for r in self.replicas.values()):
                    self._finish_err(
                        req, "no_replica",
                        f"no replica hosting model {req.model!r} "
                        "survives to run the request")
                elif self._has_roles:
                    self._finish_err(
                        req, "no_replica",
                        "no prefill-capable replica survives to "
                        "run the prompt")
                else:
                    self._finish_err(req, "no_replica",
                                     "no replica alive")
                continue
            # saturated (or healing): stays queued; later requests of
            # the same class face the identical candidate set
            stuck.add((req.model, pin))
        return None

    def _next_dispatch(self):
        """The next (req, rep, is_handoff) to dispatch, or None when
        everything queued is waiting on capacity or a heal (lock held).
        Handed-off sessions go first — their prefill compute is already
        spent, and seating them frees prefill-pool pages — unless the
        decode pool is dead-but-healing, in which case prompts a live
        prefill gang could overlap with the heal are not blocked."""
        decode_dead_healing = self._pending and not any(
            r.alive and r.accepts("adopt")
            for r in self.replicas.values()) \
            and (self._expecting("adopt")
                 or self._heal_grace_active("adopt"))
        if self._pending_handoff and not decode_dead_healing:
            got = self._scan_queue(self._pending_handoff, "adopt")
            if got is not None:
                return (*got, True)
        if self._pending:
            got = self._scan_queue(self._pending, "gen")
            if got is not None:
                return (*got, False)
        return None

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._work:
                while not (self._pending or self._pending_handoff) \
                        and not self._stop.is_set():
                    self._work.wait(0.2)
                if self._stop.is_set():
                    return
                got = self._next_dispatch()
                if got is None:
                    # every queued piece of work is waiting on capacity
                    # or a heal window
                    self._work.wait(0.05)
                    continue
                req, rep, handoff = got
                req.replica = rep.eid
                rep.outstanding[req.rid] = req
                if self.journal is not None:
                    self.journal.record("route", rid=req.rid,
                                        replica=rep.eid)
                if handoff:
                    # the adopt hop CONTINUES the same attempt — only gen
                    # dispatches charge the requeue-once failover budget,
                    # so a death on either side of the handoff boundary
                    # leaves exactly one replay
                    session, req.session = req.session, None
                    msg = {"op": "adopt", "rid": req.rid,
                           "trace": req.trace, "session": session}
                    self._emit("request_handoff_routed", rid=req.rid,
                               trace=req.trace, replica=rep.eid,
                               pages=int((session or {}).get("pages", 0)))
                else:
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
        self._m_requests.inc(outcome="expired",
                             model=req.model or "default")
        req.finished = True
        self._requests.pop(req.rid, None)
        self._emit("request_failed", rid=req.rid, trace=req.trace,
                   reason="deadline")
        if self.journal is not None:
            self.journal.record("commit", rid=req.rid, outcome="expired",
                                tokens=len(req.tokens))
        req.events.put(("err", "deadline",
                        f"deadline exceeded after "
                        f"{time.monotonic() - req.created:.2f}s in queue"))

    def _finish_err(self, req: ServeRequest, reason: str, msg: str) -> None:
        """Fail ``req`` with a typed error (lock held by caller)."""
        self.failed += 1
        self._m_requests.inc(outcome="failed",
                             model=req.model or "default")
        # per-version failure attribution: the replica last serving the
        # request (the rollout gate's error-rate signal); unattributable
        # failures (never routed) only count at the model level
        mv = self._mv(self.replicas.get(req.replica)
                      if req.replica is not None else None)
        if mv is not None:
            mv["failed"] += 1
        req.finished = True
        self._requests.pop(req.rid, None)
        self._emit("request_failed", rid=req.rid, trace=req.trace,
                   reason=reason)
        if self.journal is not None:
            self.journal.record("commit", rid=req.rid, outcome="failed",
                                reason=reason, tokens=len(req.tokens))
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
            role = msg.get("role")
            if role is not None and role != rep.role:
                # a replica serving a different specialization than it
                # registered with would silently break the pools — keep
                # serving (the stream is still exact) but say so loudly
                logger.error(
                    "replica %d reports role %r but registered as %r",
                    rep.eid, role, rep.role)
                self._emit("role_mismatch", replica=rep.eid,
                           reported=role, registered=rep.role)
            if event == "model_swapped":
                # the replica finished its hot swap: update its label,
                # resume routing, release the tier's waiter
                model, version = msg.get("model"), msg.get("version")
                rep.model = None if model is None else str(model)
                rep.version = None if version is None else str(version)
                if rep.model is not None:
                    self._model_lost_at.pop(rep.model, None)
                rec = self._swap_waiters.get(rep.eid)
                if rec is None or rec["token"] in (
                        None, msg.get("swap_token")):
                    # the ack belongs to the active swap (or no swap is
                    # in flight): resume routing.  A LATE ack racing a
                    # retry's drain still relabels above, but must not
                    # clear the drain the retry owns.
                    rep.draining = False
                if rec is not None and rec["token"] in (
                        None, msg.get("swap_token")):
                    self._swap_waiters.pop(rep.eid, None)
                    rec["ok"] = True
                    rec["event"].set()
                self._emit("model_swapped", replica=rep.eid, model=model,
                           version=version)
                if self.journal is not None:
                    self.journal.record("replica_model", replica=rep.eid,
                                        model=rep.model,
                                        version=rep.version)
                self._work.notify_all()
                return
            if event == "model_swap_failed":
                # the replica kept (or restored) its OLD params — it is
                # still routable; the tier's swap call raises
                rec = self._swap_waiters.get(rep.eid)
                err = str(msg.get("error", "swap failed"))
                if rec is not None and rec["token"] in (
                        None, msg.get("swap_token")):
                    self._swap_waiters.pop(rep.eid, None)
                    rec["error"] = err
                    rec["event"].set()
                logger.error("replica %d model swap failed: %s",
                             rep.eid, err)
                self._emit("model_swap_failed", replica=rep.eid, error=err)
                return
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
            if event == "handoff":
                # the prefill gang finished the prompt: the request's
                # session (KV pages + first token + sampler state) moves
                # to the driver, awaiting its decode-gang adopt dispatch.
                # The outstanding guard above makes this race-safe: a
                # handoff from a replica _mark_dead already swept is
                # dropped here, and the requeued gen replay wins.
                rep.outstanding.pop(rid, None)
                session = msg.get("session") or {}
                req.replica = None
                req.session = session
                req.session_version = rep.version
                self.handoffs += 1
                self._m_requests.inc(outcome="handoff",
                                     model=req.model or "default")
                self._pending_handoff.append(req)
                self._emit(
                    "request_handoff", rid=rid, trace=req.trace,
                    from_replica=rep.eid,
                    pages=int(session.get("pages", 0)),
                    bytes=int(sum(getattr(a, "nbytes", 0)
                                  for a in session.get("kv", ()))))
                self._work.notify_all()
                return
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
                    self._m_ttft.record(ttft, model=req.model or "default")
                    mv = self._mv(rep)
                    if mv is not None:
                        mv["ttft"].record(ttft)
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
                self._m_requests.inc(outcome="completed",
                                     model=req.model or "default")
                e2e = time.monotonic() - req.created
                self.e2e.record(e2e)
                self._m_e2e.record(e2e, model=req.model or "default")
                mv = self._mv(rep)
                if mv is not None:
                    mv["completed"] += 1
                    mv["e2e"].record(e2e)
                self._emit("request_done", rid=rid, trace=req.trace,
                           replica=rep.eid, tokens=len(req.tokens),
                           e2e_secs=round(e2e, 6))
                req.events.put(("done", len(req.tokens)))
                if self.journal is not None:
                    self.journal.record("commit", rid=rid, outcome="done",
                                        tokens=len(req.tokens))
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
                    if not rep.alive:
                        continue
                    # a gang is only as alive as its weakest shard: any
                    # member's nonzero exit fails the whole endpoint
                    dead = next((m for m in (eid, *rep.members)
                                 if codes.get(m) not in (0, None)), None)
                    if dead is not None:
                        shard = "" if dead == eid else f"gang shard {dead} "
                        self._mark_dead(
                            eid, f"{shard}process exited "
                                 f"(code {codes[dead]})")

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
                   shards=list((eid, *rep.members)),
                   inflight=len(rep.outstanding))
        if self.journal is not None:
            self.journal.record("replica_dead", replica=eid)
        stranded = list(rep.outstanding.values())
        rep.outstanding.clear()
        self._close_clients(rep)
        # a death mid-hot-swap releases the tier's waiter with an error
        # (the swap call fails; normal death handling replaces the gang)
        rec = self._swap_waiters.pop(eid, None)
        if rec is not None:
            rec["error"] = f"replica died mid-swap: {reason}"
            rec["event"].set()
        survivors = any(r.alive for r in self.replicas.values())
        # anchor the lost-pool clock for every dispatch kind this death
        # left without an acceptor: the heal-grace window runs from HERE
        # (a fresh acceptor pops the clock in add_replica)
        now = time.monotonic()
        for kind in ("gen", "adopt"):
            if not any(r.alive and r.accepts(kind)
                       for r in self.replicas.values()):
                self._pool_lost_at.setdefault(kind, now)
        # and per model: the heal window for a multi-model tier that
        # just lost a model's LAST hosting gang
        if rep.model is not None and not any(
                r.alive and r.model == rep.model
                for r in self.replicas.values()):
            self._model_lost_at.setdefault(rep.model, now)
        # while a heal is announced (or recent enough that its
        # announcement may still be coming), stranded/pending work is
        # HELD instead of shed — the heal window must not lose the very
        # requests it exists to save
        hold_gen = self._expecting("gen") or self._heal_grace_active("gen")
        for req in stranded:
            if req.finished:
                continue
            if not survivors and not hold_gen \
                    and not self._model_heal_active(req.model):
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
                # + the skip counter make the client's stream exact.  A
                # request lost POST-HANDOFF replays the same way: the
                # gen replay re-prefills (on a prefill gang in a
                # disaggregated tier), hands off again, and the skip
                # counter dedups everything already delivered — the
                # requeue-once budget spans the whole pipeline
                self.requeued += 1
                self._m_requests.inc(outcome="requeued",
                                     model=req.model or "default")
                req.replica = None
                req.session = None
                req.session_version = None
                req.skip = len(req.tokens)
                self._pending.appendleft(req)
                self._emit("request_requeued", rid=req.rid, trace=req.trace,
                           from_replica=eid, delivered=len(req.tokens))
        if not survivors:
            if not hold_gen:
                for req in list(self._pending):
                    if self._model_heal_active(req.model):
                        continue        # held for the model's heal window
                    self._finish_err(req, "no_replica", "no replica alive")
                    with contextlib.suppress(ValueError):
                        self._pending.remove(req)
            if not (self._expecting("adopt")
                    or self._heal_grace_active("adopt")):
                for req in list(self._pending_handoff):
                    self._finish_err(req, "no_replica", "no replica alive")
                self._pending_handoff.clear()
        self._work.notify_all()
