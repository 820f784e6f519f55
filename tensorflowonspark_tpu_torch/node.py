"""Per-worker node runtime: bootstrap, context, and the user-fn harness.

Port of ``tensorflowonspark_tpu/node.py`` — the code that runs once inside
every worker process.  It

1. starts this node's :class:`~tensorflowonspark_tpu_torch.queues.QueueServer`
   (reference: ``TFManager.start``),
2. registers with the driver's reservation server and waits for the full
   cluster spec (reference: ``reservation.Client.register`` /
   ``await_reservations`` inside ``TFSparkNode.py::run``),
3. exports the coordination env (``TFOS_COORDINATOR`` /
   ``TFOS_NUM_PROCESSES`` / ``TFOS_PROCESS_ID``) that
   :meth:`NodeContext.initialize_distributed` hands to
   ``torch.distributed.init_process_group``,
4. builds a :class:`NodeContext` and invokes the user's ``map_fun(args, ctx)``,
5. traps exceptions into the ``error`` queue + a crash file so the driver can
   re-raise them (reference: the ``'error'`` queue consumed by
   ``TFCluster.shutdown``).

``map_fun`` runs in the worker process itself, one process per card: the
driver feeds over TCP/shm directly, so no second process per executor is
needed.  A latched SIGTERM (``preemption.py``) flips the heartbeat's phase
to ``preempted``, as in the JAX package's harness, and a ``TFOS_CHAOS``
plan (``chaos.py``) mounts on the heartbeat reporter.  With
``tensorboard=True`` the chief-designate node spawns TensorBoard on the
cluster's logdir before it registers and carries ``(tb_pid, tb_port)`` in
its reservation, as the reference's ``TFSparkNode.py::run`` does.
"""

from __future__ import annotations

import logging
import os
import time
import traceback

from tensorflowonspark_tpu_torch import chaos as chaos_mod
from tensorflowonspark_tpu_torch import preemption, util
from tensorflowonspark_tpu_torch.datafeed import DataFeed
from tensorflowonspark_tpu_torch.health import HeartbeatReporter
from tensorflowonspark_tpu_torch.queues import DEFAULT_QUEUES, QueueServer
from tensorflowonspark_tpu_torch.reservation import Client, get_ip_address

logger = logging.getLogger(__name__)


class NodeContext:
    """Context object passed to the user's ``map_fun(args, ctx)``.

    Equivalent of ``TFSparkNode.py::TFNodeContext`` (executor_id, job_name,
    task_index, cluster_spec, defaultFS, working_dir, mgr) plus the
    coordination parameters for ``torch.distributed``.
    """

    def __init__(self, executor_id: int, job_name: str, task_index: int,
                 cluster_info: list[dict], default_fs: str = "",
                 working_dir: str | None = None, mgr: QueueServer | None = None,
                 tensorboard_logdir: str | None = None):
        self.executor_id = self.worker_num = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_info = cluster_info
        self.default_fs = self.defaultFS = default_fs
        self.working_dir = working_dir or os.getcwd()
        self.mgr = mgr
        self.num_workers = len(cluster_info)
        self.tensorboard_logdir = tensorboard_logdir or os.path.join(
            self.working_dir, "tensorboard")
        self._heartbeat = None  # HeartbeatReporter, attached by node.run
        self._goodput = None    # GoodputRecorder, created by ctx.goodput()

    # -- cluster spec ------------------------------------------------------
    @property
    def cluster_spec(self) -> dict:
        """``{job_name: [host:port, ...]}``, the reference's ClusterSpec shape."""
        spec: dict[str, list[str]] = {}
        for node in sorted(self.cluster_info, key=lambda n: (n["job_name"], n["task_index"])):
            spec.setdefault(node["job_name"], []).append(f"{node['host']}:{node['port']}")
        return spec

    def nodes_with_job(self, job_name: str) -> list[dict]:
        return sorted((n for n in self.cluster_info if n["job_name"] == job_name),
                      key=lambda n: n["task_index"])

    @property
    def is_chief(self) -> bool:
        """True on the node that should export/checkpoint (reference: the
        ``chief``/``master`` role, else worker:0)."""
        chiefs = [n for n in self.cluster_info if n["job_name"] in ("chief", "master")]
        if chiefs:
            return (self.job_name, self.task_index) == (
                chiefs[0]["job_name"], chiefs[0]["task_index"])
        return self.job_name == "worker" and self.task_index == 0

    @property
    def num_hosts(self) -> int:
        return len({n["host"] for n in self.cluster_info})

    # -- torch.distributed coordination ------------------------------------
    def distributed_env(self) -> dict:
        """Process 0's coordinator address plus this node's rank (the
        reference's ``TF_CONFIG``)."""
        ordered = sorted(self.cluster_info, key=lambda n: n["executor_id"])
        coord = ordered[0]
        return {
            "coordinator_address": f"{coord['host']}:{coord['coordinator_port']}",
            "num_processes": len(ordered),
            "process_id": self.executor_id,
        }

    def initialize_distributed(self, device=None, backend: str | None = None) -> None:
        """Join this process to the cluster's ``torch.distributed`` group.

        ``backend`` as the caller names it; by default ``nccl`` when
        ``device`` is a CUDA device (the default), ``gloo`` for the CPU.  A
        caller whose ranks share one card passes ``backend="gloo"`` (NCCL
        takes one rank a device); nothing switches backends on a failure.
        Skipped for a single-process cluster, as the reference skips
        ``jax.distributed.initialize`` there.
        """
        env = self.distributed_env()
        if env["num_processes"] <= 1:
            return
        import torch.distributed as dist

        dev = util.resolve_device(device)
        dist.init_process_group(
            backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{env['coordinator_address']}",
            world_size=env["num_processes"], rank=env["process_id"])

    # -- user conveniences -------------------------------------------------
    def get_data_feed(self, train_mode: bool = True, qname_in: str = "input",
                      qname_out: str = "output",
                      input_mapping: dict | None = None) -> DataFeed:
        """The reference's ``TFNode.DataFeed(ctx.mgr, ...)``."""
        if self.mgr is None:
            raise RuntimeError("no queue manager on this node (InputMode.TENSORFLOW?)")
        return DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping)

    def absolute_path(self, path: str) -> str:
        """The reference's ``TFNode.hdfs_path(ctx, path)``."""
        return util.hdfs_path(self, path)

    def tensorboard_url(self) -> str | None:
        """URL of the cluster's TensorBoard, if one was spawned
        (reference: ``TFCluster.tensorboard_url`` — same data, node side)."""
        from tensorflowonspark_tpu_torch import observability

        return observability.tensorboard_url(self.cluster_info)

    def profile_trace(self, logdir: str | None = None):
        """Profiler trace context for a block of this node's training
        (``torch.profiler`` into the cluster's TensorBoard logdir by
        default, so the spawned TensorBoard's profile plugin sees it)."""
        from tensorflowonspark_tpu_torch import observability

        return observability.profile_trace(logdir or self.tensorboard_logdir)

    def export_dir(self, subdir: str = "export") -> str:
        return self.absolute_path(subdir)

    def report_step(self, step: int, phase: str = "step") -> None:
        """Report progress to the driver's health monitor.

        Publishes ``step`` into this node's heartbeat payload immediately
        (``health.HeartbeatReporter.report_step``), arming the driver-side
        hang watchdog (it stays unarmed until a node reports step ≥ 1, so a
        long first kernel build is never mistaken for a wedge).  A no-op
        when no reporter is attached (a NodeContext built outside the node
        harness)."""
        if self._heartbeat is not None:
            self._heartbeat.report_step(step, phase)

    def goodput(self):
        """This node's :class:`~tensorflowonspark_tpu_torch.observability.
        GoodputRecorder`, wired into the heartbeat payload.

        Created on first call (idempotent).  Once attached, every beat
        carries ``recorder.summary()`` so per-node goodput shows up in
        the driver's aggregated ``TPUCluster.metrics()`` view live::

            rec = ctx.goodput()
            with rec.time("data"):  batch = feed.next_batch(...)
            with rec.time("step"):  out = model(batch)
        """
        if self._goodput is None:
            from tensorflowonspark_tpu_torch.observability import GoodputRecorder

            self._goodput = GoodputRecorder()
            if self._heartbeat is not None:
                self._heartbeat.attach_goodput(self._goodput)
        return self._goodput


def start_cluster_server(ctx: NodeContext, num_devices: int = 1, rdma: bool = False,
                         device=None):
    """API-parity shim for the reference's TF1-era
    ``TFNode.py::start_cluster_server`` (built a ``tf.train.Server`` with
    protocol ``grpc``/``grpc+verbs``).  Here it joins the node to the
    cluster's ``torch.distributed`` group on ``device`` (the card unless the
    caller passes the CPU); ``rdma`` is advisory (NCCL picks its transport).
    Returns the context so legacy call sites keep working."""
    if rdma:
        logger.info("rdma=True is advisory (NCCL picks its own transport)")
    ctx.initialize_distributed(device=device)
    return ctx


def run(fn, tf_args, cluster_meta: dict, queues=DEFAULT_QUEUES):
    """Build the per-worker harness: ``_mapfn(executor_id)``.

    Reference: ``TFSparkNode.py::run`` returning ``_mapfn(iter)`` for
    ``foreachPartition``.  The returned callable is executed once in each
    worker process by the cluster backend.  The queue server is started in
    both input modes: SPARK mode feeds through it; TENSORFLOW mode still
    uses its ``error`` queue and ``state`` kv for failure propagation.
    """

    def _mapfn(executor_id: int):
        crash_file = None
        if cluster_meta.get("working_dir"):
            crash_file = os.path.join(cluster_meta["working_dir"], f"error.{executor_id}")
        mgr = None
        client = None
        reporter = None
        on_preempt = None
        tb_proc = None
        try:
            job_name, task_index = _role_for(cluster_meta["cluster_template"], executor_id)
            host = get_ip_address()

            # 1. data-plane queue server (TFManager.start equivalent);
            #    same-host feeders negotiate the zero-copy shm transport
            #    per connection (queues.py/shm.py), cross-host feeders keep
            #    the socket protocol automatically.
            mgr = QueueServer(authkey=cluster_meta["authkey"], qnames=queues,
                              mode=cluster_meta.get("queue_mode", "remote"),
                              maxsize=cluster_meta.get("queue_depth", 64),
                              shm=cluster_meta.get("queue_shm"),
                              bulk=cluster_meta.get("queue_bulk"))
            addr = mgr.start()

            # 1b. liveness: publish heartbeat/step/phase into this node's kv
            #     from the moment the queue server exists (health.py).
            reporter = HeartbeatReporter(
                mgr, interval=float(cluster_meta.get("heartbeat_interval", 1.0)))
            reporter.start()

            # 2. ports: one for the server slot, one that process 0 will use
            #    as the torch.distributed rendezvous.
            port = util.get_free_port()
            coordinator_port = util.get_free_port()

            # 2b. tensorboard on the chief-designate, like the reference's
            #     worker:0/chief spawn in TFSparkNode.py::run; (tb_pid,
            #     tb_port) travel in the reservation → tensorboard_url().
            tb_port = 0
            chief_designate = job_name in ("chief", "master") or (
                job_name == "worker" and task_index == 0
                and not any(j in ("chief", "master")
                            for j in cluster_meta["cluster_template"]))
            if cluster_meta.get("tensorboard") and chief_designate:
                from tensorflowonspark_tpu_torch import observability

                logdir = cluster_meta.get("tensorboard_logdir") or os.path.join(
                    cluster_meta.get("working_dir") or os.getcwd(), "tensorboard")
                # wait_secs>0: don't broadcast a tb_port for a process that
                # died at boot (port collision etc.) — the URL must work
                tb = observability.start_tensorboard(logdir, wait_secs=2.0)
                if tb is not None:
                    tb_proc, tb_port = tb

            # 3. rendezvous
            client = Client(cluster_meta["server_addr"],
                            timeout=cluster_meta.get("reservation_timeout", 600),
                            authkey=cluster_meta["authkey"])
            client.register({
                "executor_id": executor_id,
                "host": host,
                "job_name": job_name,
                "task_index": task_index,
                "port": port,
                "coordinator_port": coordinator_port,
                "addr": addr,
                "authkey": cluster_meta["authkey"],
                # the owning node stops TB in its finally; the driver also
                # kills via tb_pid when it terminates workers (reference:
                # TFCluster.py::shutdown kills TB from the driver).
                "tb_pid": tb_proc.pid if tb_proc else 0,
                "tb_port": tb_port,
            })
            cluster_info = client.await_reservations()
            reporter.set_phase("init")

            # 4. context + user function
            ctx = NodeContext(executor_id, job_name, task_index, cluster_info,
                              default_fs=cluster_meta.get("default_fs", ""),
                              working_dir=cluster_meta.get("working_dir"),
                              mgr=mgr,
                              tensorboard_logdir=cluster_meta.get("tensorboard_logdir"))
            ctx._heartbeat = reporter
            # a latched SIGTERM surfaces as phase 'preempted' so the driver
            # classifies this exit as a preemption, not a crash.
            # note_preempted, not set_phase: the callback runs inside the
            # signal handler and must not touch the kv lock (health.py)
            on_preempt = reporter.note_preempted
            preemption.on_preempted(on_preempt)
            # chaos self-injection (TFOS_CHAOS): deterministic kill/stall/
            # drop faults ride the heartbeat/report_step hooks (chaos.py)
            chaos_agent = chaos_mod.from_env(
                executor_id, state_dir=cluster_meta.get("working_dir"),
                node_ctx=ctx)
            if chaos_agent is not None:
                reporter.attach_chaos(chaos_agent)
            env = ctx.distributed_env()
            os.environ["TFOS_COORDINATOR"] = env["coordinator_address"]
            os.environ["TFOS_NUM_PROCESSES"] = str(env["num_processes"])
            os.environ["TFOS_PROCESS_ID"] = str(env["process_id"])

            logger.info("node %d starting map_fun as %s:%d", executor_id, job_name, task_index)
            reporter.set_phase("run")
            fn(tf_args, ctx)
            _drain_publish_queue(mgr, executor_id)
            mgr.kv_set("state", "finished")
            reporter.set_phase("finished")
            logger.info("node %d map_fun finished", executor_id)
        except Exception:
            tb = traceback.format_exc()
            logger.error("node %d failed:\n%s", executor_id, tb)
            if crash_file:
                try:
                    with open(crash_file, "w") as f:
                        f.write(tb)
                except OSError:
                    pass
            if mgr is not None:
                try:
                    mgr.queue_put("error", tb, timeout=1)
                    mgr.kv_set("state", "failed")
                # tfos: ignore[broad-except] — best-effort crash reporting:
                # the traceback is already logged above and lands in the
                # crash file; a dead queue server must not mask it
                except Exception:
                    pass
            if reporter is not None:
                reporter.set_phase("failed")
            raise
        finally:
            if on_preempt is not None:
                preemption.remove_on_preempted(on_preempt)
            if reporter is not None:
                reporter.stop()
            if tb_proc is not None:
                from tensorflowonspark_tpu_torch import observability

                observability.stop_tensorboard(tb_proc)
            if client is not None:
                client.close()

    return _mapfn


def _drain_publish_queue(mgr, executor_id: int,
                         qname: str = "publish") -> None:
    """Linger until the continual loop's ``publish`` queue is drained
    before a CLEAN worker exit: the queue server dies with this process,
    so a candidate published moments before ``map_fun`` returned (the
    final checkpoint's publication) would be lost mid-wire while the
    driver's collector is still polling.  Bounded by
    ``TFOS_PUBLISH_DRAIN_SECS`` (default 60) so a cluster booted with a
    ``publish`` queue but no collector cannot hang its workers; a crash
    exit skips this — a torn publication is the collector's
    whole-or-nothing problem."""
    q = getattr(mgr, "queues", {}).get(qname)
    if q is None or q.qsize() == 0:
        return
    deadline = time.monotonic() + float(
        os.environ.get("TFOS_PUBLISH_DRAIN_SECS", "60"))
    logger.info("node %d waiting for %d pending publication(s) to drain",
                executor_id, q.qsize())
    while q.qsize() > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    if q.qsize() > 0:
        logger.warning(
            "node %d exiting with %d undrained publication(s) on %r — "
            "no collector picked them up within TFOS_PUBLISH_DRAIN_SECS",
            executor_id, q.qsize(), qname)
    else:
        # the last get left the server's reply in flight; give the
        # socket a beat so the payload clears this process's buffers
        time.sleep(0.1)


def _role_for(cluster_template: dict[str, list[int]], executor_id: int) -> tuple[str, int]:
    """Map an executor id to (job_name, task_index) via the driver's template.

    Reference: the ``cluster_template`` built in ``TFCluster.py::run`` mapping
    job names (ps/chief/master/worker/evaluator) to executor-index lists.
    """
    for job_name, ids in cluster_template.items():
        if executor_id in ids:
            return job_name, ids.index(executor_id)
    raise ValueError(f"executor {executor_id} not in cluster template {cluster_template}")
