"""Worker-side batch scoring: the ``batch_worker`` map_fun.

Launched through the ordinary cluster runtime (``TPUCluster.run`` /
``node.run``), so a scoring worker gets the whole substrate for free: the
node :class:`~tensorflowonspark_tpu_torch.queues.QueueServer` (with per-connection
shm negotiation — inline array shards arrive as zero-copy views) as its
task/result plane, crash files + the ``error`` queue for failure
propagation, and the heartbeat the driver's
:class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` watches.

The loop: pull one shard task from the input queue
(:meth:`~tensorflowonspark_tpu_torch.datafeed.DataFeed.next_chunk` — the
zero-copy consumer path), stream its records in ``batch_size`` groups
through the user's ``predict_fn``, spool results straight into a
:class:`~tensorflowonspark_tpu_torch.batch.writer.ShardWriter` part (atomic
rename-commit), then report ``shard_done`` on the output queue.  Every
predict batch reports ``ctx.report_step(step, phase="batch")``, so the
driver's hang watchdog covers the scoring loop itself and chaos plans get
their deterministic ``at_step`` trigger.  An
:class:`~tensorflowonspark_tpu_torch.marker.EndOfFeed` (sent by
``cluster.shutdown``) ends the loop.

``args`` contract (all keys prefixed ``batch_``):

- ``batch_predict_fn(model, records, trial_params) -> iterable`` —
  picklable top-level callable; ``records`` is a list of raw record bytes
  (tfrecord shards) or a slice of the shard's inline array (array
  shards); ``trial_params`` is the grid-search trial's param dict (None
  for plain jobs).  Returns one output record per input record (bytes
  pass through to disk; other objects are pickled — see
  :func:`~tensorflowonspark_tpu_torch.batch.writer.encode_record`).
- ``batch_model_builder(args) -> model`` — optional; built ONCE per
  worker process (this is where torch/the model stack imports belong,
  and where the model is placed on the worker's card),
  passed to every ``predict_fn`` call.  Default: ``model=None``.
- ``batch_output_dir`` — the job's output dir (shared filesystem).
- ``batch_size`` — records per predict call (default 256).
"""

from __future__ import annotations

import logging
import os
import time

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch.batch.writer import ShardWriter

logger = logging.getLogger(__name__)


def _grouped(records, batch_size: int):
    """Batch an iterable (lazy) or a sliceable array into predict groups."""
    if hasattr(records, "__getitem__") and hasattr(records, "__len__"):
        for i in range(0, len(records), batch_size):
            yield records[i:i + batch_size]
        return
    buf: list = []
    for r in records:
        buf.append(r)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf:
        yield buf


def _shard_records(task: dict):
    """The task's input records: a lazy tfrecord stream or the inline
    array (already a zero-copy view on the shm transport)."""
    if task["kind"] == "tfrecord":
        from tensorflowonspark_tpu_torch import tfrecord

        return tfrecord.read_records(task["path"])
    return task["data"]


def batch_worker(args, ctx) -> None:
    """The batch-inference ``map_fun``: score shard tasks until the driver
    sends ``EndOfFeed`` (see module docstring)."""
    predict_fn = args["batch_predict_fn"]
    builder = args.get("batch_model_builder")
    batch_size = max(1, int(args.get("batch_size", 256)))
    writer = ShardWriter(args["batch_output_dir"])
    mgr = ctx.mgr
    if mgr is None:
        raise RuntimeError("batch_worker needs the node queue server "
                           "(InputMode.SPARK)")
    feed = ctx.get_data_feed(train_mode=False)
    rec = ctx.goodput()  # data waits vs predict time, heartbeat-carried

    reg = _metrics.get_registry()
    m_records = reg.counter("tfos_batch_records_total",
                            "Input records scored by this worker.")
    m_shards = reg.counter("tfos_batch_worker_shards_total",
                           "Shards committed by this worker.")
    h_predict = reg.histogram("tfos_batch_predict_seconds",
                              "predict_fn latency per batch.")

    model = builder(args) if builder is not None else None
    step = 0        # cumulative predict batches — the heartbeat step
    shards = 0
    ctx.report_step(0, phase="batch")

    while True:
        with rec.time("data"):
            task = feed.next_chunk(timeout=None)  # blocks until EndOfFeed
        if task is None:
            break
        if not (isinstance(task, dict) and task.get("op") == "shard"):
            logger.warning("batch worker %d: ignoring non-task item %r",
                           ctx.executor_id, type(task))
            continue
        key = task["key"]
        n_in = 0

        def _score():
            nonlocal step, n_in
            for group in _grouped(_shard_records(task), batch_size):
                t0 = time.monotonic()
                with rec.time("step"):
                    out = predict_fn(model, group, task.get("trial_params"))
                h_predict.record(time.monotonic() - t0)
                n_in += len(group)
                m_records.inc(len(group))
                step += 1
                ctx.report_step(step, phase="batch")
                yield from out

        final, count = writer.write(key, _score())
        shards += 1
        m_shards.inc()
        mgr.queue_put("output", {
            "event": "shard_done", "key": key, "worker": ctx.executor_id,
            "count": count, "records_in": n_in,
            # the writer's actual layout, relative to the output dir (the
            # ledger-recorded location must never drift from the file)
            "path": os.path.relpath(final, args["batch_output_dir"]),
        })
    logger.info("batch worker %d drained: %d shard(s), %d predict batch(es)",
                ctx.executor_id, shards, step)
