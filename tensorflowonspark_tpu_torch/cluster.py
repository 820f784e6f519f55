"""Driver-side cluster orchestration: ``TPUCluster``.

Port of ``tensorflowonspark_tpu/cluster.py``, itself the equivalent of the
reference's ``tensorflowonspark/TFCluster.py``.  :class:`LocalProcessBackend`
spawns N worker processes on this machine (``multiprocessing`` spawn), one
per card; each runs the node harness (``node.run``) and the user's
``map_fun``.  The user-facing contract is the reference's:

    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=...)
    cluster.train(data, num_epochs)      # InputMode.SPARK feeding
    preds = cluster.inference(data)
    cluster.shutdown(grace_secs=0)

The driver never initialises CUDA: workers are spawned (not forked) and
each applies its ``worker_env`` (``CUDA_VISIBLE_DEVICES`` for instance)
before its ``map_fun`` first touches ``torch.cuda``.

:func:`run_with_recovery` is the driver loop that relaunches the whole
job after a worker failure; the user's ``map_fun`` resumes from its
latest checkpoint.

Live membership (``add_workers``/``retire_worker``, which the serving
tier grows and shrinks by) and the ``/metrics`` HTTP endpoint
(``metrics_text``/``serve_metrics``) are the JAX package's.  Not ported
yet (ROADMAP A2r): the agent backend, TensorBoard and the submit-time
payload preflight.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import multiprocessing as mp
import os
import secrets
import tempfile
import threading
import time

from tensorflowonspark_tpu_torch import health as tpu_health
from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch import node as tpu_node, util
from tensorflowonspark_tpu_torch.marker import EndOfFeed, EndPartition
from tensorflowonspark_tpu_torch.queues import DEFAULT_QUEUES, QueueClient
from tensorflowonspark_tpu_torch.reservation import Server

logger = logging.getLogger(__name__)


class InputMode:
    """Reference: ``TFCluster.py::InputMode``."""

    SPARK = 0        # driver pushes data partitions into node queues
    TENSORFLOW = 1   # nodes read their own data


def _worker_entry(executor_id: int, env: dict, fn, tf_args, cluster_meta: dict,
                  queues) -> None:
    """Top-level child-process entry (must be picklable for mp 'spawn').

    Sets per-worker env before anything in this process initialises CUDA,
    so visibility flags take effect, then runs the node harness
    (``node.run``), mirroring how a Spark task process executes
    ``TFSparkNode._mapfn``.
    """
    os.environ.update({k: str(v) for k, v in env.items()})
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s [node {executor_id}] %(message)s")
    mapfn = tpu_node.run(fn, tf_args, cluster_meta, queues=queues)
    mapfn(executor_id)


class LocalProcessBackend:
    """Spawn N worker processes on this host (the 'local-cluster' analogue)."""

    def __init__(self, worker_env: dict | None = None):
        self.worker_env = worker_env or {}
        self.procs: list[mp.Process] = []

    def start(self, num_workers: int, fn, tf_args, cluster_meta: dict, queues) -> None:
        self.procs = []  # restartable: a relaunch must not index old procs
        for i in range(num_workers):
            self._spawn(i, fn, tf_args, cluster_meta, queues)

    def _spawn(self, executor_id: int, fn, tf_args, cluster_meta: dict,
               queues) -> None:
        ctx = mp.get_context("spawn")  # fork is unsafe once CUDA is initialised
        p = ctx.Process(
            target=_worker_entry,
            args=(executor_id, self.worker_env, fn, tf_args, cluster_meta,
                  queues),
            name=f"tfos-node-{executor_id}", daemon=False)
        p.start()
        self.procs.append(p)

    def add_workers(self, executor_ids, fn, tf_args, cluster_meta: dict,
                    queues) -> None:
        """Live membership expansion: spawn additional workers mid-flight
        (``TPUCluster.add_workers``).  ``executor_ids`` must continue the
        existing contiguous id range — ``alive()``/``exitcodes()`` index
        by executor id, and retired workers keep their slot."""
        for i in executor_ids:
            if i != len(self.procs):
                raise ValueError(
                    f"non-contiguous executor id {i} (next slot is "
                    f"{len(self.procs)})")
            self._spawn(i, fn, tf_args, cluster_meta, queues)

    def alive(self) -> list[bool]:
        return [p.is_alive() for p in self.procs]

    def failed(self) -> list[int]:
        return [i for i, p in enumerate(self.procs)
                if (not p.is_alive()) and p.exitcode not in (0, None)]

    def exitcodes(self) -> dict[int, int | None]:
        """Exit codes by executor id (None while alive) — the monitor's
        crash-vs-preemption classifier reads the signal number from here."""
        return {i: p.exitcode for i, p in enumerate(self.procs)}

    def join(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in self.procs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            p.join(remaining)
        return all(not p.is_alive() for p in self.procs)

    def terminate(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)


class TPUCluster:
    """Handle for a running cluster.  Reference: ``TFCluster.py::TFCluster``.

    The name is kept from the JAX package so driver scripts port unchanged;
    here the workers drive GPUs."""

    # how long shutdown waits for active feeder threads to notice the stop
    # before closing their QueueClients out from under them
    FEEDER_JOIN_SECS = 30.0

    def __init__(self, backend, server: Server, cluster_info: list[dict],
                 cluster_meta: dict, input_mode: int, working_dir: str,
                 queues=DEFAULT_QUEUES):
        self.backend = backend
        self.server = server
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.input_mode = input_mode
        self.working_dir = working_dir
        self.queues = queues
        self._clients: dict[int, QueueClient] = {}
        self._feed_qnames: set[str] = {"input"}
        self._shutdown_done = False
        self._stop_feed = threading.Event()  # one-shot for the cluster's life
        self._active_feeders: set = set()
        self._monitor: "tpu_health.ClusterMonitor | None" = None
        self._metrics_http = None
        # elastic membership (docs/serving.md): the payload that booted the
        # cluster, re-used by add_workers; retired ids are excluded from
        # feeding/shutdown markers but keep their backend slot
        self._payload: tuple | None = None  # (map_fun, tf_args)
        self._retired: set[int] = set()
        self._membership_lock = threading.Lock()

    @property
    def monitor(self):
        """The steady-state :class:`~tensorflowonspark_tpu_torch.health.
        ClusterMonitor`, or None when disabled (``monitor=False``)."""
        return self._monitor

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Aggregated cluster telemetry.

        ``{"driver": <this process's metrics-registry snapshot>,
        "nodes": {eid: {"metrics", "goodput", "step", "phase",
        "age_secs"}}}`` — the per-node view is whatever each worker's
        :class:`~tensorflowonspark_tpu_torch.health.HeartbeatReporter` last
        carried in its heartbeat payload, read from the running
        monitor's cache (empty with ``monitor=False``)."""
        nodes = (self._monitor.node_metrics()
                 if self._monitor is not None else {})
        return {"driver": tpu_metrics.get_registry().snapshot(),
                "nodes": nodes}

    # ------------------------------------------------------------------ run
    def metrics_text(self) -> str:
        """The merged cluster view in Prometheus text exposition format
        (driver samples labeled ``node="driver"``, worker samples by
        executor id)."""
        m = self.metrics()
        return tpu_metrics.render_cluster_text(m["driver"], m["nodes"])

    def serve_metrics(self, host: str = "127.0.0.1",
                      port: int = 0) -> tuple[str, int]:
        """Start (or return) this cluster's ``/metrics`` + ``/statusz``
        HTTP endpoint — the standalone exposition server for
        training-only jobs (the serving tier hangs its own off the
        frontend).  Returns the bound ``(host, port)``."""
        if self._metrics_http is None:
            server = tpu_metrics.MetricsHTTPServer(
                self.metrics_text, statusz=self.metrics,
                host=host, port=port)
            server.start()
            # cache only a server that actually bound — a failed start
            # (port taken) must stay retryable
            self._metrics_http = server
        return self._metrics_http.address

    # ------------------------------------------------------------------ run
    @classmethod
    def run(cls, map_fun, tf_args, num_workers: int, num_ps: int = 0,
            input_mode: int = InputMode.SPARK,
            master_node: str | None = None, eval_node: bool = False,
            driver_ps_nodes: bool = False, reservation_timeout: float = 600.0,
            queues=DEFAULT_QUEUES, backend=None, worker_env: dict | None = None,
            working_dir: str | None = None, queue_depth: int = 64,
            default_fs: str = "", queue_shm: bool | None = None,
            queue_bulk: bool | None = None, monitor: bool = True,
            hang_timeout: float = 120.0, step_timeout: float | None = None,
            heartbeat_interval: float = 1.0) -> "TPUCluster":
        """Boot the cluster and block until every node has registered.

        Mirrors ``TFCluster.py::run``'s signature and behavior: build the
        job-name template, start the reservation server, launch workers,
        await reservations, return the handle.

        Once every node has registered, a steady-state
        :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` takes
        over from the bootstrap crash watcher for the cluster's whole life
        (``monitor=False`` disables it): crashes are detected from process
        exit within a poll interval, and a worker whose heartbeat goes
        stale for ``hang_timeout`` seconds is treated as hung and the
        cluster is aborted instead of wedging until the shutdown timeout.
        """
        assert num_workers > 0, "need at least one worker"
        if driver_ps_nodes:
            # Reference semantics (TFCluster.py::run): host the gRPC ps
            # servers in the driver instead of executors.  No node runs a
            # parameter server here ('ps' is a role label; DDP replicates
            # the parameters), so there is nothing to move onto the driver.
            raise ValueError(
                "driver_ps_nodes=True has no equivalent here: 'ps' nodes are a "
                "role label and parameters are replicated by the data-parallel "
                "strategy, so ps processes cannot be hosted on the driver.  "
                "Drop the flag.")
        cluster_template = _build_cluster_template(
            num_workers, num_ps, master_node, eval_node)
        logger.info("cluster template: %s", cluster_template)

        working_dir = working_dir or tempfile.mkdtemp(prefix="tfos_torch_")
        for i in range(num_workers):  # stale crash files from a reused dir
            with contextlib.suppress(OSError):
                os.remove(os.path.join(working_dir, f"error.{i}"))
        authkey = secrets.token_bytes(16)
        server = Server(num_workers, authkey=authkey)
        server_addr = server.start()

        cluster_meta = {
            "id": secrets.token_hex(4),
            "cluster_template": cluster_template,
            "num_workers": num_workers,
            "server_addr": server_addr,
            "authkey": authkey,
            "default_fs": default_fs,
            "working_dir": working_dir,
            "queue_mode": "remote",
            "queue_depth": queue_depth,
            # None = auto: each feeder↔node connection negotiates the
            # zero-copy shm transport when it proves same-host (shm.py),
            # falling back to the chunked bulk transport (transport.py)
            # cross-host; False pins the tier off for every connection.
            "queue_shm": queue_shm,
            "queue_bulk": queue_bulk,
            "reservation_timeout": reservation_timeout,
            "heartbeat_interval": heartbeat_interval,
        }

        backend = backend or LocalProcessBackend(worker_env=worker_env)
        try:
            backend.start(num_workers, map_fun, tf_args, cluster_meta, queues)
        except Exception:
            server.stop()
            raise

        status: dict = {}
        boot_watch = threading.Thread(
            target=_watch_for_crashes, args=(backend, server, status), daemon=True)
        boot_watch.start()
        try:
            cluster_info = server.await_reservations(
                timeout=reservation_timeout, status=status)
        except Exception:
            backend.terminate()
            server.stop()
            _raise_worker_errors(working_dir, num_workers)
            raise
        logger.info("all %d nodes registered", num_workers)
        cluster = cls(backend, server, cluster_info, cluster_meta, input_mode,
                      working_dir, queues)
        cluster._payload = (map_fun, tf_args)
        if monitor:
            cluster._monitor = tpu_health.ClusterMonitor(
                cluster, hang_timeout=hang_timeout, step_timeout=step_timeout)
            cluster._monitor.start()
        return cluster

    # ----------------------------------------------------- live membership
    def add_workers(self, n: int = 1, *, map_fun=None, tf_args=None,
                    timeout: float | None = None) -> list[dict]:
        """Grow a RUNNING cluster by ``n`` workers (elastic membership).

        Re-opens the reservation path (the rendezvous server listens for
        the cluster's whole life — :meth:`Server.open_for`), extends the
        ``worker`` role in the cluster template, spawns the newcomers
        through the backend, and blocks until each has registered.  The
        new nodes run ``map_fun`` (default: the same payload the cluster
        was booted with) and join ``cluster_info`` in place, so a live
        :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` starts
        watching them as soon as they register.  Returns the new nodes'
        info dicts.

        Built for the serving tier (``ServingCluster.add_replicas``):
        workers added here are pure queue-served roles — they are NOT
        part of any ``torch.distributed`` process group the original
        members may have formed (a late joiner cannot enter it).
        """
        if self._shutdown_done:
            raise RuntimeError("cluster is shut down")
        if n < 1:
            raise ValueError("add_workers needs n >= 1")
        spawn = getattr(self.backend, "add_workers", None)
        if spawn is None:
            raise RuntimeError(
                f"backend {type(self.backend).__name__} does not support "
                "live worker addition (no add_workers method)")
        if map_fun is None or tf_args is None:
            if self._payload is None:
                raise RuntimeError("no stored payload to relaunch; pass "
                                   "map_fun and tf_args explicitly")
            map_fun = self._payload[0] if map_fun is None else map_fun
            tf_args = self._payload[1] if tf_args is None else tf_args
        timeout = (self.cluster_meta.get("reservation_timeout", 600.0)
                   if timeout is None else float(timeout))
        with self._membership_lock:
            if self._shutdown_done:
                # checked again under the lock: shutdown sends its
                # end-of-feed markers under it, so a newcomer either
                # registered before them or is never spawned
                raise RuntimeError("cluster is shut down")
            first = self.cluster_meta["num_workers"]
            new_ids = list(range(first, first + n))
            # template first: the newcomers' _role_for reads it from the
            # pickled cluster_meta; reservation re-open before spawn so a
            # fast-booting worker can never observe the stale required
            # count
            self.cluster_meta["cluster_template"].setdefault(
                "worker", []).extend(new_ids)
            self.cluster_meta["num_workers"] = first + n
            self.server.open_for(n)
            for i in new_ids:  # stale crash files from a reused dir
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.working_dir, f"error.{i}"))
            spawn(new_ids, map_fun, tf_args, self.cluster_meta, self.queues)
            deadline = time.monotonic() + timeout
            while True:
                regs = {r["executor_id"]: r
                        for r in self.server.reservations.get()}
                if all(i in regs for i in new_ids):
                    break
                # fail fast on a newcomer that died during ITS bootstrap —
                # previously-failed (e.g. preempted-and-replaced) workers
                # must not be re-read as a fresh bootstrap failure
                dead = [i for i in self.backend.failed() if i in new_ids]
                if dead:
                    # scope the crash-file read to the NEWCOMERS: a stale
                    # error.{i} from a previously failed-over member must
                    # not be re-raised over the real bootstrap failure
                    _raise_worker_errors(self.working_dir,
                                         self.cluster_meta["num_workers"],
                                         ids=new_ids)
                    raise RuntimeError(
                        f"new worker(s) {dead} exited during bootstrap")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"timed out awaiting {n} new reservation(s); got "
                        f"{sorted(i for i in new_ids if i in regs)}")
                # membership mutation is one atomic section by design:
                # scale/retire/heal must serialize behind the grow, and
                # the poll is deadline-bounded a few lines up
                time.sleep(0.1)  # tfos: ignore[blocking-under-lock]
            added = [regs[i] for i in new_ids]
            self.cluster_info.extend(added)
        logger.info("cluster grew by %d worker(s): %s", n, new_ids)
        return added

    def retire_worker(self, executor_id: int) -> None:
        """Record a clean, driver-initiated departure: the worker keeps
        its backend slot (ids stay contiguous) but is excluded from
        feeding and from shutdown's end-of-feed markers, and its cached
        queue client is closed.  The caller is responsible for actually
        stopping the worker (e.g. the serving tier's drain + EndOfFeed)."""
        with self._membership_lock:
            self._retired.add(int(executor_id))
            cli = self._clients.pop(int(executor_id), None)
        if cli is not None:
            with contextlib.suppress(Exception):
                cli.close()

    # ---------------------------------------------------------------- feed
    def _feedable_nodes(self) -> list[dict]:
        """Nodes that consume the input queue: workers/chief/master, not
        ps/evaluator (reference: ``TFCluster.py::train`` targets workers)
        or retired members."""
        feedable = [n for n in self.cluster_info
                    if n["job_name"] in ("worker", "chief", "master")
                    and n["executor_id"] not in self._retired]
        return sorted(feedable, key=lambda n: n["executor_id"])

    def _client_for(self, executor_id: int) -> QueueClient:
        if executor_id not in self._clients:
            info = next(n for n in self.cluster_info if n["executor_id"] == executor_id)
            self._clients[executor_id] = QueueClient(
                info["addr"], info["authkey"],
                shm=self.cluster_meta.get("queue_shm"),
                bulk=self.cluster_meta.get("queue_bulk"))
        return self._clients[executor_id]

    def train(self, data, num_epochs: int = 1, qname: str = "input",
              feed_timeout: float = 600.0, chunk_size: int = 256,
              num_partitions: int | None = None) -> None:
        """Feed ``data`` to the cluster (InputMode.SPARK path).

        Reference: ``TFCluster.py::train`` — unions the RDD ``num_epochs``
        times (``num_epochs=0`` streams forever) and pushes every partition
        into whichever executor Spark scheduled; here partitions are routed
        round-robin over feedable nodes and items travel in ``chunk_size``
        chunks.  Aborts when a node sets state ``'terminating'``.
        """
        assert self.input_mode == InputMode.SPARK, \
            "train() feeds data only in InputMode.SPARK"
        self._feed_qnames.add(qname)
        # _stop_feed is one-shot for the cluster's life, so a stop_feed()/
        # shutdown() issued before a background feeder thread reaches this
        # line still takes effect.
        nodes = self._feedable_nodes()
        partitions = _partition(data, num_partitions or len(nodes))

        epoch_iter = itertools.count() if num_epochs == 0 else range(num_epochs)
        self._active_feeders.add(threading.current_thread())
        try:
            for epoch in epoch_iter:
                for pidx, part in enumerate(partitions):
                    if self._stop_feed.is_set():
                        logger.info("feed: stop_feed() requested; stopping")
                        return
                    target = nodes[pidx % len(nodes)]
                    client = self._client_for(target["executor_id"])
                    if client.kv_get("state") == "terminating":
                        logger.info("feed: node requested termination; stopping")
                        return
                    _feed_partition(client, part, qname, chunk_size,
                                    feed_timeout, stop_event=self._stop_feed)
                logger.info("feed: epoch %d delivered", epoch)
        except (ConnectionError, EOFError, OSError) as e:
            if isinstance(e, TimeoutError):  # a full queue, not a dead worker
                raise
            if self._stop_feed.is_set():
                return  # orderly stop racing a socket close is not an error
            self._reraise_worker_error(e)
        finally:
            self._active_feeders.discard(threading.current_thread())

    def stop_feed(self) -> None:
        """Stop an in-flight (possibly unbounded) ``train()`` feed from the
        driver side; ``shutdown()`` then delivers the end-of-feed markers so
        workers drain what was already queued and exit cleanly."""
        self._stop_feed.set()

    def inference(self, data, qname: str = "input", qname_out: str = "output",
                  feed_timeout: float = 600.0, chunk_size: int = 256) -> list:
        """Push data, collect an equal number of results.

        Reference: ``TFCluster.py::inference`` → ``TFSparkNode._inference``
        (push n items + EndPartition, pull exactly n results).  Results keep
        partition order; ordering across nodes follows partition index.
        """
        assert self.input_mode == InputMode.SPARK
        nodes = self._feedable_nodes()
        partitions = _partition(data, len(nodes))
        results: list = []
        lock = threading.Lock()
        errors: list = []

        # One thread per *node* (not per partition): a node has a single
        # input/output queue pair, so its partitions must be fed and
        # collected sequentially or chunks from different partitions would
        # interleave and threads would steal each other's results.
        by_node: dict[int, list[tuple[int, list]]] = {}
        for pidx, part in enumerate(partitions):
            by_node.setdefault(pidx % len(nodes), []).append((pidx, part))

        def _feed_and_collect(node_idx: int, parts: list[tuple[int, list]]) -> None:
            try:
                target = nodes[node_idx]
                client = QueueClient(target["addr"], target["authkey"],
                                     shm=self.cluster_meta.get("queue_shm"),
                                     bulk=self.cluster_meta.get("queue_bulk"))
                try:
                    for pidx, part in parts:
                        # Interleave feeding with result collection: with
                        # bounded queues, pushing a whole partition before
                        # draining results deadlocks once the output queue
                        # fills (worker blocked on put, feeder blocked on
                        # put).  _feed_partition drains via the callback both
                        # between chunk puts and *while* a put is blocked.
                        got: list = []

                        def _drain():
                            for _ in range(client.qsize(qname_out)):
                                chunk = client.queue_get(qname_out, timeout=feed_timeout)
                                got.extend(chunk if isinstance(chunk, list) else [chunk])

                        _feed_partition(client, part, qname, chunk_size,
                                        feed_timeout, on_progress=_drain)
                        while len(got) < len(part):
                            chunk = client.queue_get(qname_out, timeout=feed_timeout)
                            got.extend(chunk if isinstance(chunk, list) else [chunk])
                        with lock:
                            results.append((pidx, got))
                finally:
                    client.close()
            except Exception as e:  # surface feeder errors to caller
                with lock:
                    errors.append(e)

        threads = [threading.Thread(target=_feed_and_collect, args=(n, ps), daemon=True)
                   for n, ps in by_node.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            e = errors[0]
            if (isinstance(e, (ConnectionError, EOFError, OSError))
                    and not isinstance(e, TimeoutError)):
                self._reraise_worker_error(e)
            raise e
        out: list = []
        for _, got in sorted(results, key=lambda r: r[0]):
            out.extend(got)
        return out

    def _reraise_worker_error(self, exc: BaseException) -> None:
        """A feeder-side socket failure usually means the worker died; prefer
        its traceback over the raw connection error.  Polls briefly because
        the crash file is written by the dying worker concurrently with the
        connection reset."""
        deadline = time.monotonic() + 5.0
        while True:
            try:
                _raise_worker_errors(self.working_dir,
                                     self.cluster_meta["num_workers"])
            except Exception as worker_err:
                raise worker_err from exc
            if time.monotonic() >= deadline:
                raise exc
            time.sleep(0.25)

    # ------------------------------------------------------------ shutdown
    def shutdown(self, grace_secs: float = 0.0, timeout: float = 259200.0) -> None:
        """End feeding, join workers, re-raise the first worker error.

        Reference: ``TFCluster.py::shutdown`` (push end-of-feed sentinels →
        join the node RDD → re-raise worker exceptions → stop the reservation
        server; default hard timeout 3 days).
        """
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self._stop_feed.set()  # unblock any background train() thread first
        for t in list(self._active_feeders):
            # wait for feeders to notice the stop before we close the
            # QueueClients they are using (~2 s put attempts, see _put_chunk)
            if t is threading.current_thread():
                continue
            t.join(timeout=self.FEEDER_JOIN_SECS)
            if t.is_alive():
                logger.warning(
                    "feeder thread %r still running after %.0fs; its "
                    "QueueClient will be closed out from under it",
                    t.name, self.FEEDER_JOIN_SECS)
        if grace_secs:
            time.sleep(grace_secs)
        if self.input_mode == InputMode.SPARK:
            # under the membership lock: a worker add_workers is spawning
            # (a serving tier's standby backfill) registers first and gets
            # its marker too, where it would otherwise wait forever
            with self._membership_lock:
                for n in self._feedable_nodes():
                    for qn in self._feed_qnames:
                        try:
                            self._client_for(n["executor_id"]).put(qn, EndOfFeed(), timeout=5)
                        except Exception:
                            logger.warning("could not send EndOfFeed('%s') to node %d",
                                           qn, n["executor_id"])
        finished = self.backend.join(timeout)
        monitor_failure = None
        if self._monitor is not None:
            # keep the monitor alive THROUGH the join above — a crash or
            # hang mid-drain aborts the join instead of wedging it.  A death
            # that unblocked the join between monitor polls still needs
            # classifying: poll once more, synchronously, then stop.  After
            # a join TIMEOUT, stop before terminate() so those
            # self-inflicted exits are not read back as failures.
            if finished:
                self._monitor.poll_now()
            self._monitor.stop()
            monitor_failure = self._monitor.failure
        if not finished:
            logger.warning("workers still alive after %.0fs; terminating", timeout)
            self.backend.terminate()
        if self._metrics_http is not None:
            with contextlib.suppress(Exception):
                self._metrics_http.stop()
            self._metrics_http = None
        for c in self._clients.values():
            c.close()
        self.server.stop()
        _raise_worker_errors(self.working_dir, self.cluster_meta["num_workers"])
        if monitor_failure is not None:
            # no crash file (SIGKILL / hang) but the monitor classified the
            # failure: surface it, with the implicated workers' log tails
            # when the backend can serve them
            raise _with_log_tails(monitor_failure, self.backend)
        failed = self.backend.failed() if finished else []
        if failed:
            detail = _log_tail_detail(self.backend, failed) or "<no logs>"
            raise RuntimeError(
                f"worker(s) {failed} exited with nonzero status:\n{detail}")
        if not finished:
            raise TimeoutError(f"cluster shutdown timed out after {timeout}s")

    def _abort(self) -> None:
        """Hard teardown after a classified failure (the health monitor's
        fail-fast path): terminate stragglers and release sockets and the
        reservation server."""
        self._stop_feed.set()
        if self._monitor is not None:
            self._monitor.stop()  # no-op join when called from its thread
        if self._metrics_http is not None:
            with contextlib.suppress(Exception):
                self._metrics_http.stop()
            self._metrics_http = None
        with contextlib.suppress(Exception):
            self.backend.terminate()
        for c in self._clients.values():
            with contextlib.suppress(Exception):
                c.close()
        with contextlib.suppress(Exception):
            self.server.stop()


def run_with_recovery(map_fun, tf_args, num_workers: int, *,
                      max_restarts: int = 2, data=None, num_epochs: int = 1,
                      input_mode: int = InputMode.TENSORFLOW,
                      shutdown_timeout: float = 259200.0,
                      backoff_base: float = 1.0, backoff_cap: float = 30.0,
                      restart_budget: tuple[int, float] | None = None,
                      retry_policy=None, on_restart=None, driver_fn=None,
                      **run_kwargs) -> None:
    """Run a cluster job to completion, relaunching after worker failures.

    The reference has NO elasticity (SURVEY.md §5): a retried TF node cannot
    rejoin a wedged cluster, so its documented recovery model is whole-job
    restart + resume from checkpoints — which Spark's driver performed by
    rerunning the job.  This is that driver loop: on worker failure the
    whole cluster is torn down and relaunched, and the user's ``map_fun``
    resumes from its latest checkpoint exactly as it would after a
    preemption (the ``CheckpointManager.latest_step()``-then-``restore``
    pattern, see ``resnet_train.py``).

    Failure *detection* comes from the per-cluster
    :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` (on by default via
    ``TPUCluster.run``): crashes and stale-heartbeat hangs abort the attempt
    within seconds and arrive here as classified
    :class:`~tensorflowonspark_tpu_torch.health.ClusterFailure` s.  The restart
    decision then follows ``health.classify_restart`` — deterministic user
    errors (e.g. a ``ValueError`` out of the map_fun's first step) are NOT
    retried, infra failures (crash/hang/preemption/socket/timeout) always
    are — overridable via ``retry_policy(exc, kind) -> bool``.  Relaunches
    wait ``health.backoff_delay`` (exponential from ``backoff_base`` capped
    at ``backoff_cap``, with jitter), and ``restart_budget=(R, T)`` bounds
    the restart *rate* to R per sliding T seconds on top of the per-job
    ``max_restarts``.  Exhausting the budget emits a classified
    ``budget_exhausted`` event to the job's health ``EventLog`` and a
    ``tfos_restarts_total{kind="budget_exhausted"}`` count before
    re-raising, so "gave up" is observable as distinct from "still
    retrying".  ``on_restart(attempt, exc, kind)`` runs before each
    relaunch (metrics, cache-warming, paging).

    ``data``/``num_epochs`` replay the InputMode.SPARK feed on every
    attempt (idempotence is the map_fun's contract, as it was with Spark
    task retries); TENSORFLOW mode needs neither.

    ``driver_fn(cluster)`` replaces the built-in feed as each attempt's
    driver phase: it runs after every node registered and before
    ``shutdown``, and its exceptions are classified for the restart
    decision like any other failure.  It may return a set of executor
    ids whose failures it already handled in-flight (e.g. a dead
    worker whose shards were reassigned to survivors): those workers'
    nonzero exits are then tolerated at shutdown instead of burning a
    restart on an already-healed death.

    Raises the final failure once retries are exhausted or a failure
    classifies as no-retry.
    """
    budget = None
    if restart_budget is not None:
        budget = tpu_health.RestartBudget(*restart_budget)
    # one working dir for ALL attempts: chaos once-per-job sentinels, the
    # health event log, and post-mortem crash files must survive relaunches
    # (TPUCluster.run would otherwise mkdtemp a fresh dir per attempt; it
    # already clears stale error files when reusing a dir)
    if run_kwargs.get("working_dir") is None:
        run_kwargs["working_dir"] = tempfile.mkdtemp(prefix="tfos_torch_job_")
    restarts_total = tpu_metrics.get_registry().counter(
        "tfos_restarts_total",
        "Cluster relaunches performed by run_with_recovery, by failure "
        "kind.", labelnames=("kind",))
    attempt = 0
    while True:
        cluster = None
        try:
            # inside the try: a relaunch's BOOTSTRAP can fail too (agents
            # still re-provisioning after a preemption) and must be retried
            cluster = TPUCluster.run(map_fun, tf_args, num_workers,
                                     input_mode=input_mode, **run_kwargs)
            handled = None
            if driver_fn is not None:
                handled = driver_fn(cluster)
            elif input_mode == InputMode.SPARK and data is not None:
                cluster.train(data, num_epochs)
            try:
                cluster.shutdown(timeout=shutdown_timeout)
            except Exception as shutdown_exc:
                # the driver_fn handled-workers contract (see docstring):
                # a death it already healed must not fail the attempt at
                # shutdown — but only when EVERY failed worker was handled
                failed: set[int] = set()
                with contextlib.suppress(Exception):
                    failed = set(cluster.backend.failed())
                if not (handled and failed and failed <= set(handled)):
                    raise
                logger.warning(
                    "tolerating worker exit(s) %s already handled by "
                    "driver_fn: %s", sorted(failed), shutdown_exc)
            return
        except Exception as e:
            if cluster is not None:
                cluster._abort()
            kind = tpu_health.classify_failure(e)
            retry = (retry_policy(e, kind) if retry_policy is not None
                     else tpu_health.classify_restart(kind))
            if not retry:
                logger.error(
                    "cluster failed with a no-retry %s error (%s); a restart "
                    "would fail identically — raising", kind, type(e).__name__)
                raise
            attempt += 1
            if attempt > max_restarts:
                logger.error("giving up after %d restart(s)", max_restarts)
                raise
            if budget is not None and not budget.allow():
                # "gave up" must be tellable from "still retrying": a
                # classified event in the job's health log + a terminal
                # restart-counter kind, BEFORE the re-raise
                logger.error(
                    "restart budget exhausted (%d restarts within %.0fs); "
                    "raising", restart_budget[0], restart_budget[1])
                restarts_total.inc(kind=tpu_health.BUDGET_EXHAUSTED)
                _emit_health_event(
                    run_kwargs.get("working_dir"),
                    tpu_health.BUDGET_EXHAUSTED,
                    failure_kind=kind, attempt=attempt,
                    max_restarts=restart_budget[0],
                    window_secs=restart_budget[1])
                raise
            restarts_total.inc(kind=kind)
            delay = tpu_health.backoff_delay(attempt, backoff_base, backoff_cap)
            logger.warning(
                "cluster attempt %d/%d failed [%s] (%s: %s); relaunching in "
                "%.1fs — map_fun resumes from its latest checkpoint",
                attempt, max_restarts, kind, type(e).__name__,
                str(e).splitlines()[0] if str(e) else "", delay)
            if on_restart is not None:
                on_restart(attempt, e, kind)
            time.sleep(delay)


# -- helpers ---------------------------------------------------------------

def _emit_health_event(working_dir, kind: str, **fields) -> None:
    """Append one classified event to the job's ``health_events.jsonl``
    from the DRIVER loop (the per-cluster monitor that usually owns the
    log is already torn down when run_with_recovery gives up)."""
    if not working_dir:
        return
    with contextlib.suppress(Exception):
        from tensorflowonspark_tpu_torch import observability

        log = observability.EventLog(
            os.path.join(working_dir, "health_events.jsonl"))
        try:
            log.emit(kind, **fields)
        finally:
            log.close()


def _log_tail_detail(backend, failed: list) -> str:
    """The implicated workers' captured log tails, formatted for an error
    message (''/empty when the backend cannot serve logs)."""
    fetch = getattr(backend, "fetch_logs", None)
    if not failed or fetch is None:
        return ""
    try:
        logs = fetch(failed)
    except Exception:
        logger.debug("could not fetch worker log tails from backend",
                     exc_info=True)
        return ""
    if not logs:
        return ""
    return "\n".join(
        f"--- executor {i} log tail ---\n"
        f"{logs.get(i, '<no log available on driver>')}" for i in failed)


def _with_log_tails(failure: "tpu_health.ClusterFailure", backend):
    """Append the implicated workers' captured log tails to a classified
    failure, keeping its kind/workers/detected_at intact."""
    detail = _log_tail_detail(backend, list(failure.failed_workers))
    if not detail:
        return failure
    enriched = tpu_health.ClusterFailure(
        failure.kind, f"{failure}\n{detail}", failure.failed_workers)
    enriched.detected_at = failure.detected_at
    return enriched


def _build_cluster_template(num_workers: int, num_ps: int,
                            master_node: str | None, eval_node: bool) -> dict:
    """Map job names to executor-id lists.

    Reference: the template logic at the top of ``TFCluster.py::run``
    (ps nodes first, then chief/master, evaluator last, workers in between).
    """
    assert num_ps < num_workers, "num_ps must leave at least one worker"
    executors = list(range(num_workers))
    template: dict[str, list[int]] = {}
    if num_ps:
        template["ps"] = executors[:num_ps]
        executors = executors[num_ps:]
    if eval_node:
        assert len(executors) > 1, "eval_node needs a spare executor"
        template["evaluator"] = [executors[-1]]
        executors = executors[:-1]
    if master_node:
        template[master_node] = [executors[0]]
        executors = executors[1:]
    if executors:
        template["worker"] = executors
    return template


def _partition(data, n: int) -> list[list]:
    """Split data into n contiguous partitions (RDD-partition stand-in).

    Accepts a list of pre-made partitions (list of lists) via
    ``Partitioned`` or splits a flat sequence evenly.
    """
    if isinstance(data, Partitioned):
        return [list(p) for p in data.partitions]
    return util.split_evenly(list(data), n)


class Partitioned:
    """Explicitly pre-partitioned data (the RDD-with-partitions analogue)."""

    def __init__(self, partitions):
        self.partitions = list(partitions)


def _feed_partition(client: QueueClient, part: list, qname: str,
                    chunk_size: int, feed_timeout: float,
                    on_progress=None, stop_event=None) -> None:
    """Push one partition as chunks + EndPartition marker.

    Reference hot loop: ``TFSparkNode.py::_train`` (per-item ``q.put`` with
    ``feed_timeout``; aborts on state ``'terminating'``) — here chunked.
    ``on_progress`` (used by inference) is invoked between chunks *and*
    whenever a put is blocked on a full queue, so the caller can drain the
    output queue instead of deadlocking against a blocked worker.
    ``stop_event`` (driver-side ``stop_feed``) aborts between chunks and
    while a put is blocked.
    """
    for i, start in enumerate(range(0, len(part), chunk_size)):
        if stop_event is not None and stop_event.is_set():
            return
        # poll 'state' every 16 chunks, not per chunk — the kv round trip
        # would otherwise double the driver's per-chunk latency
        if i % 16 == 0 and client.kv_get("state") == "terminating":
            return
        _put_chunk(client, qname, part[start:start + chunk_size],
                   feed_timeout, on_progress, stop_event)
        if on_progress is not None:
            on_progress()
    if stop_event is not None and stop_event.is_set():
        return
    _put_chunk(client, qname, EndPartition(), feed_timeout, on_progress,
               stop_event)


def _put_chunk(client: QueueClient, qname: str, item, feed_timeout: float,
               on_progress=None, stop_event=None) -> None:
    """Blocking put that keeps draining via ``on_progress`` while full and
    gives up promptly when ``stop_event`` fires."""
    deadline = time.monotonic() + feed_timeout
    attempt_timeout = (2.0 if (on_progress is not None or stop_event is not None)
                       else feed_timeout)
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"queue '{qname}' full after {feed_timeout}s "
                               "(feed_timeout)")
        try:
            client.put(qname, item, timeout=min(attempt_timeout, remaining))
            return
        except TimeoutError:
            if stop_event is not None and stop_event.is_set():
                return  # streaming stop: abandoning the chunk is fine
            if on_progress is None and stop_event is None:
                raise
            if on_progress is not None:
                on_progress()  # free worker-side backpressure, then retry


def _watch_for_crashes(backend, server: Server, status: dict) -> None:
    """Fail-fast bootstrap monitor: if a worker dies before registering,
    surface it so ``await_reservations`` raises instead of hanging (the
    reference gets this from Spark job failure + ``spark.task.maxFailures=1``)."""
    while not server.done.is_set() and not server.reservations.done():
        failed = backend.failed()
        if failed:
            status["error"] = (
                f"worker(s) {failed} exited during bootstrap. If this driver "
                "script runs at module top level, wrap it in `if __name__ == "
                "'__main__':` — worker processes re-import the main module "
                "(multiprocessing 'spawn'), like PySpark driver scripts."
            )
            return
        time.sleep(0.25)


def _raise_worker_errors(working_dir: str, num_workers: int,
                         ids=None) -> None:
    """Re-raise worker tracebacks found in crash files — ALL of them.

    Reference: ``TFCluster.py::shutdown`` re-raising errors drained from the
    per-node ``'error'`` queues.  Every crashed worker's traceback is
    aggregated into the one ``RuntimeError``, so a multi-worker failure is
    diagnosed in one read.  ``ids`` restricts the sweep (``add_workers``
    scopes it to the newcomers).
    """
    found: list[tuple[int, str]] = []
    for i in (range(num_workers) if ids is None else ids):
        crash = os.path.join(working_dir, f"error.{i}")
        if os.path.exists(crash):
            with open(crash) as f:
                found.append((i, f.read()))
    if not found:
        return
    if len(found) == 1:
        i, tb = found[0]
        raise RuntimeError(f"worker {i} failed:\n{tb}")
    detail = "\n".join(f"--- worker {i} failed ---\n{tb}" for i, tb in found)
    raise RuntimeError(
        f"{len(found)} workers failed "
        f"({', '.join(str(i) for i, _ in found)}):\n{detail}")
