"""Online serving frontend: the TCP edge + the cluster composition.

Port of ``tensorflowonspark_tpu/serving/frontend.py``.  The tier, its
edge, membership, warm standbys and drain-and-replace are the JAX
package's; the replicas' batchers run on the card (``run(device=None)``)
or, when asked, on the CPU.  The options that need modules not ported
yet raise ``NotImplementedError`` naming their ROADMAP item: the
autoscaler, the model registry and rollout, disaggregated pools and the
control-plane journal (A8c), mesh-sharded gangs (A6).

:class:`ServeFrontend` is the process boundary of the serving tier: it
listens on a TCP port, authenticates clients with the same mutual-HMAC
authkey handshake the rest of the stack uses
(:class:`~tensorflowonspark_tpu_torch.reservation.MessageSocket`), and turns
each ``generate`` op into a :meth:`ReplicaScheduler.submit` — typed
load-shed rejections and deadline expiries travel back as ``("ERR",
reason, message)`` frames, streamed tokens as ``("TOK", [deltas])``.

:class:`ServingCluster` composes the whole tier::

    serving = ServingCluster.run(model_builder, num_replicas=2,
                                 max_batch=4, eos_id=50256)
    client = serving.client()
    tokens = client.generate(prompt, max_new_tokens=64)
    for delta in client.generate_stream(prompt, 64):
        ...
    serving.shutdown()

Wiring (docs/serving.md has the picture):

- replicas are ordinary cluster workers running
  :func:`~tensorflowonspark_tpu_torch.serving.replica.serve_replica`
  (``TPUCluster.run`` with ``InputMode.SPARK``), so bootstrap,
  reservation, heartbeats, crash files and shutdown all reuse the
  training-path machinery;
- the cluster's fail-fast monitor is replaced by a serving-mode
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor`
  (``abort_on_failure=False, keep_polling=True``) whose classified
  failures feed :meth:`ReplicaScheduler.on_cluster_failure` — a replica
  death triggers failover, not teardown;
- ``shutdown`` drains the scheduler, stops the edge, then runs the
  normal cluster shutdown; worker exits caused by replica deaths the
  scheduler already failed over are tolerated (they were *handled*, and
  every accepted request completed or got a typed error), anything else
  re-raises.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import socket
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch import observability
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.health import PREEMPTION, ClusterMonitor
from tensorflowonspark_tpu_torch.marker import EndOfFeed
from tensorflowonspark_tpu_torch.reservation import (FrameFormatError,
                                               MessageSocket, _peer_name)
from tensorflowonspark_tpu_torch.serving.scheduler import (REQUEST_QUEUE,
                                                     ReplicaScheduler,
                                                     RequestRejected,
                                                     ServingError)

logger = logging.getLogger(__name__)


class ServeFrontend(MessageSocket):
    """TCP edge of the serving tier (one thread per client connection).

    Client protocol (after the authkey handshake), all frames pickled
    through the shared ``MessageSocket`` wire format:

    - ``{"op": "generate", "prompt", "max_new_tokens", "temperature",
      "top_p", "seed", "stream", "timeout"}`` → a sequence of
      ``("TOK", [tokens])`` frames (``stream=True`` only) terminated by
      ``("DONE", payload)`` — payload is the full generated token array
      for ``stream=False``, the total token count for streams — or
      ``("ERR", reason, message)``;
    - ``{"op": "stats"}`` → ``("OK", metrics_dict)``;
    - ``{"op": "ping"}`` → ``"OK"``;
    - ``{"op": "resume", ...}`` → ``("ERR", "unknown_request", ...)``:
      no frontend of the port replays a stream after a driver failover
      (the journal waits for ROADMAP A8c), so a client armed with
      ``failover_wait`` falls back to re-submitting its request.
    """

    def __init__(self, scheduler: ReplicaScheduler, authkey: bytes,
                 mode: str = "local", default_timeout: float = 600.0,
                 port: int = 0):
        self.scheduler = scheduler
        self.authkey = bytes(authkey)
        self.mode = mode
        self.default_timeout = float(default_timeout)
        self._port = int(port)
        self.done = threading.Event()
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.connections = 0
        self._m_ops = tpu_metrics.get_registry().counter(
            "tfos_frontend_requests_total",
            "Frontend operations received, by op.", labelnames=("op",))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> tuple[str, int]:
        host = "127.0.0.1" if self.mode == "local" else "0.0.0.0"
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, self._port))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, name="serve-frontend",
                         daemon=True).start()
        from tensorflowonspark_tpu_torch.reservation import get_ip_address

        self.addr = ("127.0.0.1" if self.mode == "local"
                     else get_ip_address(), self.port)
        logger.info("serving frontend listening at %s", self.addr)
        return self.addr

    def stop(self) -> None:
        self.done.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        # close established connections too: their threads block in
        # receive() and would otherwise linger past the tier's life
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            with contextlib.suppress(OSError):
                conn.close()

    # -- serving -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self.done.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            self.connections += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            nonce = self.auth_challenge(conn)
            if not self.auth_verify(conn, self.authkey, nonce):
                return
            while not self.done.is_set():
                msg = self.receive(conn)
                op = msg.get("op") if isinstance(msg, dict) else None
                # label only the known op set — a client-controlled label
                # value must not mint unbounded counter series
                self._m_ops.inc(op=op if op in ("generate", "stats",
                                                "ping", "resume")
                                else "other")
                if op == "generate":
                    self._handle_generate(conn, msg)
                elif op == "resume":
                    self.send(conn, ("ERR", "unknown_request",
                                     "no replayed request: driver failover "
                                     "waits for ROADMAP A8c"))
                elif op == "stats":
                    self.send(conn, ("OK", self.scheduler.metrics()))
                elif op == "ping":
                    self.send(conn, "OK")
                else:
                    self.send(conn, ("ERR", "bad_request",
                                     f"unknown op {op!r}"))
        except FrameFormatError as e:
            logger.error("dropping serve peer %s: %s", _peer_name(conn), e)
        except (EOFError, OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            with contextlib.suppress(OSError):
                conn.close()

    def _handle_generate(self, conn: socket.socket, msg: dict) -> None:
        stream = bool(msg.get("stream"))
        # clients send an explicit "timeout": None for "no deadline asked";
        # the tier's default_timeout must still apply then, or a saturated
        # tier would hold this connection thread forever
        timeout = msg.get("timeout")
        if timeout is None:
            timeout = self.default_timeout
        try:
            # the edge stamps the trace id (honoring a client-supplied
            # one): every downstream event for this request carries it
            req = self.scheduler.submit(
                msg["prompt"], int(msg["max_new_tokens"]),
                temperature=float(msg.get("temperature", 0.0)),
                top_p=float(msg.get("top_p", 1.0)),
                seed=int(msg.get("seed", 0)), timeout=timeout,
                trace=msg.get("trace"),
                tenant=str(msg.get("tenant") or "default"),
                priority=msg.get("priority"),
                model=msg.get("model"))
        except (RequestRejected, ServingError) as e:
            self.send(conn, ("ERR", getattr(e, "reason", "rejected"), str(e)))
            return
        except (ValueError, TypeError, KeyError) as e:
            self.send(conn, ("ERR", "bad_request", str(e)))
            return
        self._pump_request(conn, req, stream)

    def _pump_request(self, conn: socket.socket, req, stream: bool) -> None:
        """Drain ``req``'s event queue onto ``conn`` until terminal."""
        try:
            while True:
                remaining = (None if req.deadline is None
                             else req.deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.scheduler.abandon(req)
                    self.send(conn, ("ERR", "deadline",
                                     "deadline exceeded mid-request"))
                    return
                try:
                    ev = req.events.get(timeout=remaining)
                except queue.Empty:
                    continue        # loop re-checks remaining (<= 0 now)
                if ev[0] == "tok":
                    if stream and ev[1]:
                        self.send(conn, ("TOK", ev[1]))
                elif ev[0] == "done":
                    self.send(conn, ("DONE",
                                     ev[1] if stream
                                     else np.asarray(req.tokens, np.int32)))
                    return
                else:  # ("err", reason, message)
                    self.send(conn, ("ERR", ev[1], ev[2]))
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-request: stop tracking so replica
            # output for it is dropped instead of queuing forever
            self.scheduler.abandon(req, reason="disconnect")
            raise


class ServingCluster:
    """A running online-serving tier: cluster + monitor + scheduler +
    frontend, shut down as one unit (see module docstring)."""

    def __init__(self, cluster: TPUCluster, scheduler: ReplicaScheduler,
                 monitor: ClusterMonitor | None, frontend: ServeFrontend,
                 address: tuple[str, int]):
        self.cluster = cluster
        self.scheduler = scheduler
        self.monitor = monitor
        self.frontend = frontend
        self.address = address
        self.metrics_http = None
        #: ``(host, port)`` of the /metrics + /statusz endpoint, or None
        self.metrics_address: tuple[str, int] | None = None
        self._shutdown_done = False
        self._replace_preempted = True
        self._drain_timeout = 60.0
        self._membership_lock = threading.Lock()
        self._replaced: set[int] = set()  # preempted eids already replaced
        self._reaped: set[int] = set()    # replicas already stopped
        #: the warm-standby pool (:class:`~tensorflowonspark_tpu_torch.serving.
        #: standby.StandbyPool`) when ``run(warm_standbys=N)``, else None
        self.standbys = None
        self._serve_args: dict = {}       # standbys re-use the args
        self._standby_clone = True
        self._replace_failed = False
        #: promoted standby -> (decision monotonic, source,
        #: ready event) until its ``standby_ready`` ack closes the heal
        #: measurement — the event also gates the pool's deferred
        #: backfill (heal first, restock second).  Own leaf lock (never
        #: wraps scheduler/membership calls): the ack path reads it
        #: UNDER the scheduler lock
        self._promotions: dict[int, tuple] = {}
        self._promotions_lock = threading.Lock()
        self._promoted: dict[str, int] = {}   # source -> promotions
        #: decision-to-restored-capacity latencies of warm promotions
        self.heal = observability.LatencyHistogram()
        reg = tpu_metrics.get_registry()
        self._m_promotions = reg.counter(
            "tfos_serving_promotions_total",
            "Warm-standby promotions by trigger "
            "(failure/preemption/scale_up).", labelnames=("source",))
        self._h_heal = reg.histogram(
            "tfos_serving_heal_seconds",
            "Heal-decision to restored-capacity latency of warm "
            "promotions (standby_ready ack).")

    # ------------------------------------------------------------------ run
    @classmethod
    def run(cls, model_builder, num_replicas: int, *, max_batch: int = 4,
            eos_id: int | None = None, batcher_kwargs: dict | None = None,
            replica_args: dict | None = None, overcommit: int = 2,
            max_queue_depth: int | None = None, requeue_limit: int = 1,
            hang_timeout: float = 120.0, step_timeout: float | None = None,
            monitor: bool = True, frontend_mode: str = "local",
            client_timeout: float = 600.0,
            metrics_port: int | None = 0, tenants: dict | None = None,
            autoscale=None, replace_preempted: bool = True,
            replace_failed: bool = False,
            drain_timeout: float = 60.0, mesh: dict | None = None,
            gang_size: int | None = None, shard_params=None,
            warm_standbys: int = 0, standby_clone: bool = True,
            compile_cache=None, aot_cache=None, draft_model=None,
            disagg: dict | None = None,
            model: tuple | None = None, registry=None, device=None,
            **cluster_kwargs) -> "ServingCluster":
        """Boot ``num_replicas`` serving workers and the driver-side tier.

        ``model_builder(args) -> (cfg, params)`` must be a picklable
        top-level callable (it runs inside each worker process).
        ``cluster_kwargs`` pass through to :meth:`TPUCluster.run`
        (``backend=``, ``worker_env=``, ``working_dir=``, ``queue_shm=``,
        ``queue_depth=``, ``reservation_timeout=``...).

        ``metrics_port`` binds the Prometheus ``/metrics`` + JSON
        ``/statusz`` endpoint next to the frontend (0 = an ephemeral
        port, surfaced as ``serving.metrics_address``; ``None``
        disables it).

        ``tenants`` configures per-tenant admission (token buckets +
        priority classes — see :class:`~tensorflowonspark_tpu_torch.serving.
        scheduler.ReplicaScheduler`).  With ``replace_preempted``
        (default), a replica whose host is reclaimed (SIGTERM / heartbeat
        phase ``preempted``) is drained and REPLACED instead of counting
        as a failure.

        Not ported yet, each raising ``NotImplementedError`` with its
        ROADMAP item: ``autoscale`` (the autoscaler), ``disagg``
        (disaggregated prefill/decode pools), ``model``/``registry`` and a
        ``(model_id, version)`` ``draft_model`` (multi-model hosting and
        rollout) — all A8c — and ``mesh``/``gang_size``/``shard_params``
        (mesh-sharded gangs, A6).

        ``warm_standbys`` keeps N fully-initialized spare replicas
        (process up, serve steps run — captured, with ``aot_cache`` — params UNLOADED,
        heartbeat phase ``standby``) that heal paths PROMOTE instead of
        cold-spawning — replica deaths, preemption drain-and-replace,
        and scale-ups all consume the pool first, and the
        pool backfills itself in the background (docs/robustness.md
        "Warm standbys").  ``standby_clone`` (default) lets a promoted
        standby pull weights from a live peer replica over the queue/shm
        data plane instead of re-running the model builder (the
        checkpoint-restore fallback).  ``replace_failed`` spawns a
        replacement for CRASH/HANG deaths too (cold when no pool), so
        the tier never shrinks by failure; with a warm pool, crash heals
        promote regardless.  ``compile_cache`` has no counterpart here
        and raises if given: the JAX package's fleet-wide persistent XLA
        cache saves compiles, and eager PyTorch compiles nothing.

        ``aot_cache`` arms the tier's compile-site cache
        (``serving/aot.py``): every replica and warm standby captures
        each serve-step site as a CUDA graph at its first call (a warm
        standby in its warm-up sweep, ahead of traffic) and replays it
        after (``True``; nothing is written to disk: a graph cannot be
        serialized).

        ``device`` is where the replicas' batchers run: None means the
        card (a worker without one raises), ``"cpu"`` the CPU.

        ``draft_model`` arms DRAFT-MODEL SPECULATIVE DECODING on every
        replica: a picklable ``builder(args) -> (cfg, params)`` for the
        small draft.  Each decode step then runs one draft forward
        proposing ``serve_draft_k`` (replica_args; default 4) tokens per
        eligible greedy row and one verify call on the target —
        output-exact by construction (the verify only commits tokens the
        target's own argmax agrees with; sampled rows keep the
        single-token path).  Tune via ``replica_args``:
        ``serve_draft_window`` (draft context, default 64),
        ``serve_draft_k``.  The draft vocab must match the target's
        (validated at boot, typed).
        """
        from tensorflowonspark_tpu_torch.serving.replica import serve_replica

        for name, value, item in (("autoscale", autoscale, "A8c: autoscaler"),
                                  ("disagg", disagg, "A8c: disagg"),
                                  ("model", model, "A8c: rollout"),
                                  ("registry", registry, "A8c: rollout"),
                                  ("mesh", mesh, "A6: sharded"),
                                  ("gang_size", gang_size, "A6: sharded"),
                                  ("shard_params", shard_params, "A6: sharded")):
            if value is not None:
                raise NotImplementedError(
                    f"ServingCluster.run({name}=...) needs a module not ported yet "
                    f"(ROADMAP {item})")
        if isinstance(draft_model, tuple):
            raise NotImplementedError(
                "draft_model=(model_id, version) needs the model registry, not ported "
                "yet (ROADMAP A8c: rollout) — pass the draft's builder callable")
        if compile_cache is not None:
            raise ValueError(
                "compile_cache has no counterpart in the port: eager PyTorch compiles "
                "nothing to cache (aot_cache= captures the serve steps as CUDA graphs)")
        args = dict(replica_args or {})
        args.update({
            "serve_model_builder": model_builder,
            "serve_max_batch": int(max_batch),
            "serve_eos_id": eos_id,
            "serve_batcher_kwargs": dict(batcher_kwargs or {}),
            "serve_device": None if device is None else str(device),
        })
        if args.get("serve_model_builder") is None:
            raise ValueError("no model builder: pass model_builder=")
        if aot_cache:
            args["serve_aot_cache"] = True
        if draft_model is not None:
            if not callable(draft_model):
                raise ValueError(
                    "draft_model must be a builder callable, got "
                    f"{type(draft_model).__name__}")
            args["serve_draft_builder"] = draft_model
        if warm_standbys < 0:
            raise ValueError(f"warm_standbys must be >= 0, "
                             f"got {warm_standbys}")
        # monitor=False: the training monitor's fail-fast abort is the
        # wrong policy here — a serving-mode monitor is attached below
        cluster = TPUCluster.run(serve_replica, args, num_replicas,
                                 input_mode=InputMode.SPARK, monitor=False,
                                 **cluster_kwargs)
        scheduler = mon = frontend = tier = None
        try:
            scheduler = ReplicaScheduler(
                cluster, slots_per_replica=max_batch, overcommit=overcommit,
                max_queue_depth=max_queue_depth, requeue_limit=requeue_limit,
                tenants=tenants)
            if monitor:
                mon = ClusterMonitor(
                    cluster, hang_timeout=hang_timeout,
                    step_timeout=step_timeout, abort_on_failure=False,
                    keep_polling=True,
                    on_failure=scheduler.on_cluster_failure)
                mon.start()
            scheduler.start()
            frontend = ServeFrontend(
                scheduler, authkey=cluster.cluster_meta["authkey"],
                mode=frontend_mode, default_timeout=client_timeout)
            address = frontend.start()
            tier = cls(cluster, scheduler, mon, frontend, address)
            tier._replace_preempted = bool(replace_preempted)
            tier._replace_failed = bool(replace_failed)
            if warm_standbys or replace_failed or replace_preempted:
                # this tier HEALS lost replicas: when the last one dies,
                # dispatch holds its requeued work briefly (until the
                # heal's expect_replica announcement, or this bound)
                # instead of shedding it sub-second as no_replica
                scheduler.heal_grace = 30.0
            tier._drain_timeout = float(drain_timeout)
            tier._serve_args = args
            tier._standby_clone = bool(standby_clone)
            scheduler.on_replica_ready = tier._on_standby_ready
            if mon is not None:
                # re-point the monitor's hooks at the tier: classified
                # failures still retire replicas in the scheduler, but
                # preemptions (exit-shape OR live grace-window phase
                # flips) now ALSO drive drain-and-replace
                mon.on_failure = tier._on_cluster_failure
                mon.on_phase = tier._on_phase
            if warm_standbys:
                from tensorflowonspark_tpu_torch.serving.standby import \
                    StandbyPool

                tier.standbys = StandbyPool(tier, int(warm_standbys))
                tier.standbys.fill()
            if metrics_port is not None:
                tier.metrics_http = tpu_metrics.MetricsHTTPServer(
                    tier.metrics_text, statusz=tier.metrics,
                    host="127.0.0.1" if frontend_mode == "local"
                    else "0.0.0.0", port=metrics_port)
                bound = tier.metrics_http.start()
                # surface a connectable address, not the wildcard bind:
                # remote mode advertises the same host the frontend does
                tier.metrics_address = (
                    (address[0], bound[1]) if bound[0] == "0.0.0.0"
                    else bound)
        except Exception:
            # a late failure (e.g. the metrics port is taken) must tear
            # down everything already live: the frontend's accept thread
            # and bound port, the scheduler's threads AND its registry
            # collect hook (scheduler.stop unhooks it), the monitor
            standbys = tier.standbys if tier is not None else None
            for part in (standbys, frontend, scheduler, mon):
                if part is not None:
                    with contextlib.suppress(Exception):
                        part.stop()
            cluster._abort()
            raise
        return tier

    # -------------------------------------------------------------- clients
    @property
    def authkey(self) -> bytes:
        return self.cluster.cluster_meta["authkey"]

    def client(self, **kwargs):
        """A connected :class:`~tensorflowonspark_tpu_torch.serving.client.
        ServeClient` for this tier (one per concurrent request stream)."""
        from tensorflowonspark_tpu_torch.serving.client import ServeClient

        return ServeClient(self.address, self.authkey, **kwargs)

    # ----------------------------------------------------- live membership
    def add_replicas(self, n: int = 1, timeout: float | None = None) -> list[int]:
        """Grow the tier by ``n`` replicas, live: the cluster re-opens
        its reservation path and spawns fresh serving workers (same
        model builder/args the tier booted with), the scheduler
        registers each as it reserves, and queued requests start
        dispatching to the newcomers immediately.  Returns the new
        replicas' executor ids."""
        if self._shutdown_done:
            raise RuntimeError("serving tier is shut down")
        with self._membership_lock:
            added = self.cluster.add_workers(n, timeout=timeout)
            for info in added:
                self.scheduler.add_replica(info)
        eids = [int(info["executor_id"]) for info in added]
        logger.info("serving tier grew by %d replica(s): %s", n, eids)
        return eids

    def scale_up(self, n: int = 1, timeout: float | None = None,
                 source: str = "scale_up") -> list[int]:
        """Grow the tier by ``n`` replicas, consuming the warm-standby
        pool FIRST (promotion: control message + weight clone, capacity
        restored in well under a cold boot) and cold-spawning only the
        remainder through :meth:`add_replicas`.  Returns the new
        replicas' executor ids."""
        added: list[int] = []
        for _ in range(int(n)):
            eid = self.promote_standby(source)
            if eid is None:
                break
            added.append(eid)
        remaining = int(n) - len(added)
        if remaining:
            added.extend(self.add_replicas(remaining, timeout=timeout))
        return added

    def promote_standby(self, source: str = "scale_up") -> int | None:
        """Promote one warm standby into a routable replica: pop it from
        the pool (atomic — a concurrent failure + scale decision can
        never double-promote the same standby), send it the promote
        control message naming a live CLONE PEER (or None → it restores
        through the model builder), register it with the scheduler, and
        backfill the pool in the background.  Returns the promoted
        standby's executor id, or None when the pool is empty/absent
        (callers fall back to a cold spawn)."""
        pool = self.standbys
        if pool is None or self._shutdown_done:
            return None
        got = pool.acquire()
        if got is None:
            return None
        eid, info = got
        peer = self.scheduler.peer_replica_info() if self._standby_clone else None
        ready = threading.Event()
        with self._promotions_lock:
            self._promotions[eid] = (time.monotonic(), source, ready)
        # register FIRST: if the promote message were sent and the
        # registration then failed, the standby would clone weights and
        # serve unregistered forever (early-routed requests just queue
        # on its plane until the post-promote serve loop drains them)
        try:
            self.scheduler.add_replica(info)
        except Exception:
            # scheduler stopping / registration guard: the caller
            # cold-spawns instead; the pool backfills
            logger.exception("promotion of standby %d failed to "
                             "register", eid)
            with self._promotions_lock:
                self._promotions.pop(eid, None)
            self.scheduler.emit_event("promote_failed", replica=eid,
                                      source=source)
            pool.backfill_async()
            return None
        try:
            self.cluster._client_for(eid).put(
                REQUEST_QUEUE,
                {"op": "standby", "event": "promote", "source": source,
                 "peer": peer}, timeout=10)
        except Exception:
            # the standby died under us: roll the registration back as
            # a planned departure (anything already routed re-queues
            # without charging its failover budget)
            logger.exception("promotion of standby %d failed", eid)
            with self._promotions_lock:
                self._promotions.pop(eid, None)
            self.scheduler.retire_replica(eid, reason="promote_failed")
            self.scheduler.emit_event("promote_failed", replica=eid,
                                      source=source)
            pool.backfill_async()
            return None
        with self._promotions_lock:
            self._promoted[source] = self._promoted.get(source, 0) + 1
        self._m_promotions.inc(source=source)
        self.scheduler.emit_event(
            "standby_promoted", replica=eid, source=source,
            peer=None if peer is None else int(peer["executor_id"]))
        logger.info("promoted warm standby %d (source=%s, clone peer %s)",
                    eid, source,
                    "none" if peer is None else peer["executor_id"])

        def _backfill_after_ready():
            # restock AFTER the promotion restores capacity (or a grace
            # timeout): a fresh standby's boot and warm-up must not
            # compete with the heal it was triggered by
            ready.wait(30.0)
            pool.backfill_async()

        threading.Thread(target=_backfill_after_ready,
                         name=f"standby-restock-{eid}",
                         daemon=True).start()
        return eid

    def wait_standbys(self, timeout: float = 120.0) -> bool:
        """Block until every pooled standby is WARM (serve step
        run, params unloaded, heartbeating phase ``standby``) —
        what a bench/test gates on before injecting the failure it wants
        healed warm.  False on timeout or when no pool/monitor exists."""
        return (self.standbys is not None
                and self.standbys.wait_warm(timeout))

    def _on_standby_ready(self, eid: int) -> dict | None:
        """Scheduler ``on_replica_ready`` hook (runs under the scheduler
        lock — no re-entry): close the heal-time measurement for a
        promotion this tier initiated."""
        with self._promotions_lock:
            rec = self._promotions.pop(eid, None)
        if rec is None:
            return None
        t0, source, ready = rec
        secs = time.monotonic() - t0
        self._h_heal.record(secs)
        self.heal.record(secs)
        ready.set()     # capacity restored: the deferred backfill may go
        return {"heal_secs": round(secs, 6), "promote_source": source}

    def retire_replica(self, executor_id: int,
                       drain_timeout: float | None = None) -> bool:
        """Drain-based scale-down of one replica: stop routing to it,
        wait out its in-flight requests (``drain_timeout``, default the
        tier's), remove it from the scheduler as a CLEAN departure (it
        never shows in ``dead_replicas``), then stop the worker with an
        ``EndOfFeed``.  Returns True when the drain emptied within the
        timeout; on False the leftovers were re-queued to the survivors
        (exactness preserved by the failover skip-dedup), so zero
        accepted requests are lost either way."""
        eid = int(executor_id)
        dt = self._drain_timeout if drain_timeout is None else drain_timeout
        self.scheduler.mark_draining(eid, reason="scale_down")
        drained = self.scheduler.drain_replica(eid, timeout=dt)
        # retire BEFORE EndOfFeed: alive goes False first, so the recv
        # loop sees a planned departure, not a dead response channel
        self.scheduler.retire_replica(
            eid, reason="scale_down" if drained else "drain_timeout")
        self._stop_worker(eid)
        return drained

    def _stop_worker(self, eid: int) -> None:
        """Stop a replica that LEFT the scheduler (retired): an
        ``EndOfFeed`` (best-effort), monitor retirement so a late exit
        is never classified, and cluster retirement so shutdown skips
        the slot.  Idempotent."""
        with self._membership_lock:
            if eid in self._reaped:
                return
            self._reaped.add(eid)
        if self.monitor is not None:
            self.monitor.ignore_workers((eid,))
        with contextlib.suppress(Exception):
            self.cluster._client_for(eid).put(REQUEST_QUEUE,
                                              EndOfFeed(), timeout=5)
        self.cluster.retire_worker(eid)

    # ------------------- multi-model hosting & live rollout, cross-pool
    # prefix donation: the JAX package's, waiting for the registry,
    # rollout and disagg modules (ROADMAP A8c)
    def deploy_model(self, model_id: str, version: str, **kwargs) -> list[int]:
        raise NotImplementedError("deploy_model needs the model registry (ROADMAP A8c: rollout)")

    def swap_replica_model(self, executor_id: int, model_id: str, version: str,
                           timeout: float | None = None) -> None:
        raise NotImplementedError(
            "swap_replica_model needs the model registry (ROADMAP A8c: rollout)")

    def rollout(self, model_id: str, version: str, policy=None, block: bool = True):
        raise NotImplementedError("rollout needs the rollout module (ROADMAP A8c)")

    def donate_prefix_pages(self, to_replica: int, from_replica: int | None = None) -> bool:
        raise NotImplementedError(
            "prefix-page donation is a disaggregated tier's (ROADMAP A8c: disagg)")

    # ------------------------------------------------ preemption handling
    def _on_phase(self, eid: int, phase: str) -> None:
        """Monitor ``on_phase`` hook: a live replica flipping to
        ``preempted`` is in its reclaim grace window — drain and replace
        it NOW instead of waiting for the exit."""
        if phase == "preempted" and not self._shutdown_done:
            self._handle_preempted(int(eid))

    def _on_cluster_failure(self, failure) -> None:
        """Monitor ``on_failure`` hook: absorb UNPROMOTED-standby deaths
        into the pool (shrink + backfill — the scheduler never knew
        them), then always fail over via the scheduler, requeueing the
        dead replicas' in-flight work once.  A PREEMPTION-classified
        exit (the replica died before or during its grace drain)
        additionally spawns a replacement; with a warm pool (or
        ``replace_failed``), CRASH/HANG deaths heal the same way —
        membership flexes, the tier never shrinks."""
        failed = [int(e) for e in getattr(failure, "failed_workers", ())]
        standby_owned: set[int] = set()
        if self.standbys is not None and not self._shutdown_done:
            standby_owned = self.standbys.handle_failure(failed)
        self.scheduler.on_cluster_failure(failure)
        failed = [e for e in failed if e not in standby_owned]
        if self._shutdown_done:
            return
        kind = getattr(failure, "kind", None)
        if self._replace_preempted and kind == PREEMPTION:
            for eid in failed:
                self._spawn_replacement(eid, source="exit")
        elif kind != PREEMPTION and (self.standbys is not None
                                     or self._replace_failed):
            # crash/hang heal: only replicas the scheduler actually lost
            # (a failure naming an unknown worker must not grow the tier)
            dead = self.scheduler.dead_replicas()
            for eid in failed:
                if eid in dead:
                    self._spawn_replacement(eid, source="failure",
                                            promote_source="failure")

    def _handle_preempted(self, eid: int) -> None:
        # mark_draining is the dedup: False when already draining/dead,
        # so repeated phase reports (or the exit racing the drain) start
        # exactly one drain-and-replace
        if not self.scheduler.mark_draining(eid, reason="preempted"):
            return
        threading.Thread(target=self._drain_and_replace, args=(eid,),
                         name=f"serve-preempt-{eid}", daemon=True).start()

    def _drain_and_replace(self, eid: int) -> None:
        try:
            self.scheduler.drain_replica(eid, timeout=self._drain_timeout)
            # the worker exits by itself after its grace drain; if it
            # died mid-drain the recv loop's _mark_dead already re-queued
            # the leftovers and this retire is a no-op
            self.scheduler.retire_replica(eid, reason="preempted")
        except Exception:
            logger.exception("preemption drain of replica %d failed", eid)
        if self._replace_preempted:
            self._spawn_replacement(eid, source="drain")

    def _spawn_replacement(self, eid: int, source: str,
                           promote_source: str = "preemption") -> None:
        if self._shutdown_done:
            return
        with self._membership_lock:
            if eid in self._replaced:
                return   # phase path and exit path both fired; one spawn
            self._replaced.add(eid)
        # the heal clock starts at the DECISION, before any boot/promote
        # work — bench_serving's heal-time rows measure from this event
        self.scheduler.emit_event("heal_started", replica=eid,
                                  source=source)
        # the expectation makes dispatch QUEUE the work for the heal
        # window — when the dead replica was the LAST, its requeued
        # prompts must wait for the replacement, not shed as no_replica
        self.scheduler.expect_replica()

        def _go():
            try:
                if self._shutdown_done:
                    return
                promoted = self.promote_standby(promote_source)
                if promoted is not None:
                    self.scheduler.emit_event(
                        "replica_replaced", replica=eid,
                        replacement=promoted, source=source, mode="warm")
                    return
                new = self.add_replicas(1)
                self.scheduler.emit_event(
                    "replica_replaced", replica=eid, replacement=new[0],
                    source=source, mode="cold")
            except Exception:
                logger.exception("replacement for lost replica %d "
                                 "failed", eid)
                self.scheduler.emit_event("replace_failed", replica=eid,
                                          source=source)
            finally:
                self.scheduler.expect_done()

        threading.Thread(target=_go, name=f"serve-replace-{eid}",
                         daemon=True).start()

    def metrics(self) -> dict:
        """The scheduler's counters/latency view, plus ``"nodes"``: the
        heartbeat-carried per-replica registry snapshots and goodput
        aggregated by the serving-mode monitor (docs/observability.md)."""
        m = self.scheduler.metrics()
        m["nodes"] = (self.monitor.node_metrics()
                      if self.monitor is not None else {})
        if self.standbys is not None:
            with self._promotions_lock:
                promotions = dict(self._promoted)
            m["standby"] = {**self.standbys.stats(),
                            "promotions": promotions,
                            "heal": self.heal.summary()}
        return m

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole tier: the driver
        registry (scheduler queue depth, per-replica outstanding, TTFT/
        e2e histograms, shed/requeue counters, frontend ops) merged with
        every replica's heartbeat-carried snapshot, samples labeled by
        ``node``."""
        return tpu_metrics.render_cluster_text(
            tpu_metrics.get_registry().snapshot(),
            self.monitor.node_metrics() if self.monitor is not None else {})

    # ------------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 600.0,
                 drain_timeout: float = 60.0) -> None:
        """Drain in-flight requests, stop the tier, shut the cluster down.

        Worker failures the scheduler already failed over (dead replicas
        whose requests were re-queued or given typed errors) are
        tolerated — a serving tier that survived a replica death must not
        fail its own shutdown over the corpse.  Unhandled failures
        re-raise as usual.
        """
        if self._shutdown_done:
            return
        self._shutdown_done = True
        if self.standbys is not None:
            # no backfills may race the teardown; unpromoted standbys
            # exit on the cluster shutdown's EndOfFeed like replicas
            with contextlib.suppress(Exception):
                self.standbys.stop()
        if not self.scheduler.drain(drain_timeout):
            logger.warning("serving scheduler still busy after %.0fs drain; "
                           "remaining requests get typed shutdown errors",
                           drain_timeout)
        handled = self.scheduler.dead_replicas()
        if self.standbys is not None:
            # dead UNPROMOTED standbys were handled too (pool backfilled)
            handled |= self.standbys.dead
        if self.metrics_http is not None:
            with contextlib.suppress(Exception):
                self.metrics_http.stop()
            self.metrics_http = None
        self.frontend.stop()
        self.scheduler.stop()
        if self.monitor is not None:
            self.monitor.stop()
        try:
            self.cluster.shutdown(timeout=timeout)
        except Exception as e:
            failed = set()
            with contextlib.suppress(Exception):
                failed = set(self.cluster.backend.failed())
            if handled and failed and failed <= handled:
                logger.warning(
                    "tolerating worker exit(s) %s already failed over by "
                    "the serving tier: %s", sorted(failed), e)
            else:
                raise
