"""Driver-side bulk predict: ``BatchJob`` — assignment, progress, resume.

A :class:`BatchJob` scores a :class:`~tensorflowonspark_tpu_torch.batch.manifest.
ShardManifest` through a cluster of :func:`~tensorflowonspark_tpu_torch.batch.
worker.batch_worker` processes:

- **assignment** — the dispatcher keeps up to ``prefetch`` shards
  outstanding per worker over the node queue/shm plane (one collector
  thread per worker, the ``inference()`` topology), so a slow shard never
  idles the rest of the fleet and inline array shards ride the zero-copy
  transport;
- **progress** — every transition lands in the fsync'd
  :class:`~tensorflowonspark_tpu_torch.batch.ledger.ProgressLedger`
  (``<output_dir>/progress.jsonl``), and drives the ``tfos_batch_*``
  metrics (shards-remaining gauge on ``/metrics`` via
  ``TPUCluster.serve_metrics``);
- **dead-worker reassignment** — a serving-mode
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` classifies the
  death (crash/hang/preemption) and the dispatcher requeues the corpse's
  outstanding shards to the survivors, no restart needed
  (``reassign_dead=True``, the default);
- **resume** — under :func:`~tensorflowonspark_tpu_torch.cluster.
  run_with_recovery` (which :meth:`BatchJob.run` wraps via its
  ``driver_fn`` hook), a relaunched attempt replays the ledger and skips
  every committed shard: zero reprocessing, and the merged output
  (:func:`~tensorflowonspark_tpu_torch.batch.writer.read_results`) is identical
  to an uninterrupted run's.

Usage::

    manifest = ShardManifest.from_tfrecords("gs://bucket/part-*.tfrecord")
    job = BatchJob(manifest, "/out", predict_fn=my_predict,
                   model_builder=my_builder)
    summary = job.run(num_workers=4, max_restarts=2)
    results = job.results()          # merged, manifest order
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque

from tensorflowonspark_tpu_torch import health as tpu_health
from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch.batch.ledger import ProgressLedger
from tensorflowonspark_tpu_torch.batch.manifest import ShardManifest
from tensorflowonspark_tpu_torch.batch.writer import ShardWriter, read_results
from tensorflowonspark_tpu_torch.queues import QueueClient

logger = logging.getLogger(__name__)


class BatchJob:
    """One resumable bulk-predict job (see module docstring).

    Args:
      manifest: the input :class:`ShardManifest` (its order is the output
        order).
      output_dir: where parts, the progress ledger, and the saved
        manifest descriptors live.  Reusing a dir RESUMES the job:
        committed shards are skipped.  Must be a local path (atomic
        rename is the commit primitive).
      predict_fn: ``(model, records, trial_params) -> iterable`` —
        picklable top-level callable shipped to workers.
      model_builder: optional picklable ``(args) -> model``, built once
        per worker process.
      batch_size: records per ``predict_fn`` call.
      prefetch: shards kept outstanding per worker (pipeline depth).
      shard_timeout: max silence (secs) while a worker has outstanding
        shards before the dispatcher declares it stuck.
      trial_params: ``{trial_id: params-dict}`` for grid-search manifests
        (plain jobs leave it None).
      predict_args: extra user keys merged into the worker ``args``.
    """

    def __init__(self, manifest: ShardManifest, output_dir: str,
                 predict_fn, *, model_builder=None, batch_size: int = 256,
                 prefetch: int = 2, shard_timeout: float = 600.0,
                 trial_params: dict | None = None,
                 predict_args: dict | None = None):
        self.manifest = manifest
        self.output_dir = output_dir
        self.predict_fn = predict_fn
        self.model_builder = model_builder
        self.batch_size = int(batch_size)
        self.prefetch = max(1, int(prefetch))
        self.shard_timeout = float(shard_timeout)
        self.trial_params = dict(trial_params or {})
        self.predict_args = dict(predict_args or {})
        self.reassign_dead = True
        self._last_summary: dict | None = None
        reg = tpu_metrics.get_registry()
        self._m_shards = reg.counter(
            "tfos_batch_shards_total",
            "Shard dispatch outcomes (done / requeued / skipped-committed).",
            labelnames=("outcome",))
        self._g_remaining = reg.gauge(
            "tfos_batch_shards_remaining_count",
            "Shards not yet committed in the running batch job.")
        self._h_shard = reg.histogram(
            "tfos_batch_shard_seconds",
            "Assignment-to-commit latency per shard.")

    # ---------------------------------------------------------------- run
    def worker_args(self) -> dict:
        """The ``tf_args`` payload for :func:`~tensorflowonspark_tpu_torch.
        batch.worker.batch_worker` workers."""
        return {**self.predict_args,
                "batch_predict_fn": self.predict_fn,
                "batch_model_builder": self.model_builder,
                "batch_output_dir": self.output_dir,
                "batch_size": self.batch_size}

    def run(self, num_workers: int = 2, *, max_restarts: int = 2,
            reassign_dead: bool = True, **run_kwargs) -> dict:
        """Score the whole manifest, restarting the cluster on failure.

        Wraps :func:`~tensorflowonspark_tpu_torch.cluster.run_with_recovery`
        with this job's dispatcher as the ``driver_fn``: every attempt
        replays the ledger and processes only uncommitted shards.  With
        ``reassign_dead`` (default) a single worker death is healed
        in-flight by the serving-mode monitor instead of costing a
        restart; the corpse's nonzero exit is tolerated at shutdown.
        ``run_kwargs`` pass through to ``TPUCluster.run``
        (``worker_env=``, ``working_dir=``, ``queue_shm=``, ...).

        Returns the final attempt's dispatch summary (also via
        :attr:`last_summary`).
        """
        from tensorflowonspark_tpu_torch.batch.worker import batch_worker
        from tensorflowonspark_tpu_torch.cluster import InputMode, run_with_recovery

        self.reassign_dead = bool(reassign_dead)
        if self.reassign_dead:
            # the fail-fast training monitor would abort the whole job on
            # one death; the dispatcher attaches its own serving-mode
            # monitor (keep_polling + requeue) instead
            run_kwargs.setdefault("monitor", False)
        run_with_recovery(batch_worker, self.worker_args(), num_workers,
                          input_mode=InputMode.SPARK, driver_fn=self.dispatch,
                          max_restarts=max_restarts, **run_kwargs)
        return self._last_summary or {}

    @property
    def last_summary(self) -> dict | None:
        return self._last_summary

    def results(self, decode: bool = False) -> list:
        """Merged output records in manifest order (see
        :func:`~tensorflowonspark_tpu_torch.batch.writer.read_results`)."""
        return read_results(self.output_dir, self.manifest, decode=decode)

    # ----------------------------------------------------------- dispatch
    def dispatch(self, cluster) -> set[int]:
        """Drive one attempt over a RUNNING cluster of batch workers.

        Replays the ledger, assigns the remaining shards, collects
        commits, requeues on worker death.  Returns the executor ids
        whose failures were already handled in-flight (the
        ``driver_fn`` handled-workers contract: ``run_with_recovery``
        tolerates exactly those nonzero exits at shutdown).  Raises on
        lost capacity it could not heal — classified for the restart
        decision when a monitor saw the failure.
        """
        replay = ProgressLedger.replay(self.output_dir)
        committed = set(replay.committed)
        writer = ShardWriter(self.output_dir)
        swept = writer.sweep_temps()
        if swept:
            logger.info("batch: swept %d orphan temp part(s)", swept)
        # trust-but-verify the ledger against the filesystem: a 'done' line
        # can outlive its part (the rename is not directory-fsync'd, so an
        # OS crash can keep the fsync'd ledger and lose the file; or the
        # part was deleted by hand) — skipping it forever would wedge the
        # job at read_results.  Demote to pending and re-score.
        lost = {s.key for s in self.manifest
                if s.key in committed
                and not os.path.exists(writer.part_path(s.key))}
        if lost:
            committed -= lost
            logger.warning("batch: %d ledger-committed shard(s) missing "
                           "their part file; re-scoring: %s",
                           len(lost), sorted(lost))
        # best-effort descriptor persistence (manifest.json); the ledger,
        # not this file, is the resume source of truth
        with contextlib.suppress(OSError):
            self.manifest.save(self.output_dir)
        todo = [s for s in self.manifest if s.key not in committed]
        skipped = len(self.manifest) - len(todo)
        if skipped:
            self._m_shards.inc(skipped, outcome="skipped_committed")
            logger.info("batch: resume skips %d committed shard(s), "
                        "%d remain", skipped, len(todo))

        st = _DispatchState(todo)
        self._g_remaining.set(len(todo))
        ledger = ProgressLedger(self.output_dir)
        ledger.attempt(total=len(self.manifest), remaining=len(todo),
                       committed=skipped)
        nodes = cluster._feedable_nodes()
        if not nodes:
            ledger.close()
            raise RuntimeError("batch dispatch: no feedable workers")

        own_monitor = None
        if self.reassign_dead and cluster.monitor is None:
            own_monitor = tpu_health.ClusterMonitor(
                cluster, abort_on_failure=False, keep_polling=True,
                on_failure=lambda f: self._on_failure(st, ledger, f))
            own_monitor.start()
        try:
            threads = [
                threading.Thread(
                    target=self._collect, name=f"batch-collect-{n['executor_id']}",
                    args=(st, ledger, cluster, n), daemon=True)
                for n in nodes]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            with st.cv:
                leftover = len(st.pending) + st.total_outstanding()
                errors = list(st.errors)
                handled = set(st.dead)
            if leftover:
                # lost all capacity (or a stuck worker): surface the most
                # precise failure we have — the monitor's classified one
                # beats a raw socket error beats a generic message
                failure = None
                if cluster.monitor is not None:
                    failure = cluster.monitor.failure
                if failure is None and own_monitor is not None \
                        and own_monitor.failures:
                    failure = own_monitor.failures[-1]
                if failure is not None:
                    raise failure
                if errors:
                    raise errors[0]
                survivors = (own_monitor.live_unhandled()
                             if own_monitor is not None else [])
                raise RuntimeError(
                    f"batch dispatch stalled with {leftover} shard(s) "
                    f"unfinished (live workers: {survivors or 'none'})")
            if errors:
                raise errors[0]
        finally:
            if own_monitor is not None:
                own_monitor.stop()
            ledger.close()
        self._last_summary = {
            "shards": len(self.manifest), "skipped_committed": skipped,
            "scored": st.done_count, "requeued": st.requeue_count,
            "records": st.record_count, "handled_workers": sorted(handled),
            "output_dir": self.output_dir,
        }
        logger.info("batch dispatch complete: %s", self._last_summary)
        return handled

    # -- dispatcher internals ----------------------------------------------
    def _on_failure(self, st: "_DispatchState", ledger: ProgressLedger,
                    failure) -> None:
        """Serving-mode monitor subscriber: requeue a dead worker's
        outstanding shards and retire it from assignment."""
        for eid in getattr(failure, "failed_workers", ()):
            self._retire_node(st, ledger, int(eid),
                              reason=getattr(failure, "kind", "failure"))

    def _retire_node(self, st: "_DispatchState", ledger: ProgressLedger,
                     eid: int, reason: str) -> None:
        with st.cv:
            if eid in st.dead:
                return
            st.dead.add(eid)
            taken = st.outstanding.pop(eid, {})
            for key, (shard, _t0) in taken.items():
                st.pending.appendleft(shard)
            st.requeue_count += len(taken)
            st.cv.notify_all()
        for key in taken:
            ledger.requeued(key, worker=eid)
            self._m_shards.inc(outcome="requeued")
        if taken:
            logger.warning("batch: worker %d lost (%s); requeued %d "
                           "shard(s): %s", eid, reason, len(taken),
                           sorted(taken))
        else:
            logger.warning("batch: worker %d lost (%s); nothing outstanding",
                           eid, reason)

    def _task_for(self, shard) -> dict:
        return {"op": "shard", "key": shard.key, "kind": shard.kind,
                "path": shard.path, "data": shard.data, "trial": shard.trial,
                "trial_params": self.trial_params.get(shard.trial)
                if shard.trial else None}

    def _collect(self, st: "_DispatchState", ledger: ProgressLedger,
                 cluster, node: dict) -> None:
        """One worker's feed-and-collect loop (runs in its own thread)."""
        eid = node["executor_id"]
        client = None
        try:
            client = QueueClient(node["addr"], node["authkey"],
                                 shm=cluster.cluster_meta.get("queue_shm"))
            last_heard = time.monotonic()
            while True:
                to_send = []
                with st.cv:
                    if eid in st.dead:
                        return
                    mine = st.outstanding.setdefault(eid, {})
                    while len(mine) < self.prefetch and st.pending:
                        shard = st.pending.popleft()
                        mine[shard.key] = (shard, time.monotonic())
                        to_send.append(shard)
                    if not mine and not st.pending:
                        if st.total_outstanding() == 0:
                            st.cv.notify_all()
                            return  # job drained everywhere
                        # idle but others still in flight: a late death
                        # could requeue work for us — stay parked
                        st.cv.wait(0.5)
                        last_heard = time.monotonic()
                        continue
                for shard in to_send:
                    ledger.assigned(shard.key, worker=eid)
                    client.put("input", self._task_for(shard), timeout=60)
                try:
                    msg = client.queue_get("output", timeout=2.0)
                except TimeoutError:
                    if time.monotonic() - last_heard > self.shard_timeout:
                        raise TimeoutError(
                            f"batch worker {eid} silent for "
                            f"{self.shard_timeout:.0f}s with shard(s) "
                            f"{sorted(st.outstanding.get(eid, {}))} "
                            "outstanding (shard_timeout)")
                    continue
                last_heard = time.monotonic()
                if not (isinstance(msg, dict)
                        and msg.get("event") == "shard_done"):
                    logger.warning("batch: ignoring unexpected output item "
                                   "%r from worker %d", type(msg), eid)
                    continue
                key = msg["key"]
                with st.cv:
                    entry = st.outstanding.get(eid, {}).pop(key, None)
                    if entry is None:
                        # raced a monitor-driven requeue (worker died right
                        # AFTER committing and sending done): the part is on
                        # disk — pull the shard back off pending so no
                        # survivor re-scores a committed shard
                        for i, sh in enumerate(st.pending):
                            if sh.key == key:
                                del st.pending[i]
                                st.requeue_count -= 1
                                break
                    st.done_count += 1
                    st.record_count += int(msg.get("count", 0))
                    # set under the lock: two collectors setting it after
                    # could leave an older count last
                    self._g_remaining.set(len(st.pending) + st.total_outstanding())
                    st.cv.notify_all()
                ledger.done(key, worker=eid, count=int(msg.get("count", 0)),
                            path=msg.get("path", ""))
                self._m_shards.inc(outcome="done")
                if entry is not None:
                    self._h_shard.record(time.monotonic() - entry[1])
        except TimeoutError as e:
            # shard_timeout stall (TimeoutError IS an OSError — must be
            # caught before the dead-socket clause): a stuck worker is an
            # error, not a clean death; requeue AND record it
            with st.cv:
                st.errors.append(e)
            self._retire_node(st, ledger, eid, reason="stuck")
        except (ConnectionError, EOFError, OSError) as e:
            # the worker's queue server died under us — requeue and let
            # the survivors (or the restart) finish its shards
            self._retire_node(st, ledger, eid,
                              reason=f"{type(e).__name__}: {e}")
        except Exception as e:
            with st.cv:
                st.errors.append(e)
            self._retire_node(st, ledger, eid, reason=type(e).__name__)
        finally:
            if client is not None:
                with contextlib.suppress(Exception):
                    client.close()


class _DispatchState:
    """Shared dispatcher state (collector threads + monitor callback).
    All fields are guarded by ``cv``'s lock except the three counters,
    which are only written under it."""

    def __init__(self, todo):
        self.pending = deque(todo)
        self.outstanding: dict[int, dict] = {}  # eid -> key -> (shard, t0)
        self.dead: set[int] = set()
        self.errors: list = []
        self.done_count = 0
        self.requeue_count = 0
        self.record_count = 0
        self.cv = threading.Condition()

    def total_outstanding(self) -> int:
        """(cv held by caller)"""
        return sum(len(m) for m in self.outstanding.values())
