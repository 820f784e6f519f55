"""The in-training-process data API: ``DataFeed``.

Equivalent of the reference's ``tensorflowonspark/TFNode.py::DataFeed`` — the
object a user's ``map_fun(args, ctx)`` uses to pull data that the driver
pushed into this node's queues, and to push inference results back.

Semantics preserved from the reference:

- ``next_batch(batch_size)`` returns *up to* ``batch_size`` samples, ending a
  batch early at an ``EndPartition`` marker (so batches align to partition
  boundaries) and setting ``done_feeding`` at the terminal sentinel.
- ``should_stop()`` — true once the terminal sentinel was consumed.
- ``batch_results(results)`` — push a list of predictions to the output queue.
- ``terminate()`` — set cluster state to ``'terminating'`` and drain the
  input queue so blocked feeders unblock (reference:
  ``TFNode.py::DataFeed.terminate``).

Divergence (deliberate, SURVEY.md §3.2): queue items are **chunks** (lists of
samples), not single samples, so the per-sample path never crosses a socket.
``next_batch`` transparently re-slices chunks into batches through an internal
buffer.
"""

from __future__ import annotations

import logging
import queue as _queue
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch.marker import EndOfFeed, EndPartition, Marker

logger = logging.getLogger(__name__)


class DataFeed:
    """Reads data chunks from this node's input queue.

    ``mgr`` is anything with the uniform queue interface
    (``queues.QueueServer`` in-process or ``queues.QueueClient`` over TCP).
    ``input_mapping`` (reference: pipeline's ``--input_mapping``) selects and
    orders the columns of dict-shaped samples.
    """

    def __init__(self, mgr, train_mode: bool = True, qname_in: str = "input",
                 qname_out: str = "output", input_mapping: dict | None = None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_tensors = (
            [col for col, tensor in sorted(input_mapping.items())]
            if input_mapping is not None else None
        )
        self.done_feeding = False
        self._buffer: list = []          # samples carried over between batches
        # feed telemetry: wait time blocked on the queue, chunk/sample
        # throughput — carried to the driver in the heartbeat payload
        reg = _metrics.get_registry()
        self._m_wait = reg.histogram(
            "tfos_feed_wait_seconds",
            "Time blocked on the input queue per fetched chunk.")
        self._m_chunks = reg.counter(
            "tfos_feed_chunks_total", "Chunks consumed from the feed.")
        self._m_items = reg.counter(
            "tfos_feed_items_total", "Samples consumed from the feed.")

    # -- input -------------------------------------------------------------
    def next_batch(self, batch_size: int, timeout: float = 600.0):
        """Return up to ``batch_size`` samples (list), partition-aligned.

        Reference: ``TFNode.py::DataFeed.next_batch``.  Returns ``[]`` only
        when the feed has terminated.
        """
        if self.done_feeding:
            return []
        batch: list = []
        deadline = time.monotonic() + timeout
        while len(batch) < batch_size:
            # serve from the carry-over buffer first
            if self._buffer:
                take = batch_size - len(batch)
                batch.extend(self._buffer[:take])
                self._buffer = self._buffer[take:]
                continue
            wait_start = time.monotonic()
            try:
                item = self.mgr.queue_get(self.qname_in,
                                          timeout=max(0.1, deadline - time.monotonic()))
            except (_queue.Empty, TimeoutError):
                if batch:
                    break
                raise TimeoutError(f"no data on '{self.qname_in}' after {timeout}s")
            self._m_wait.record(time.monotonic() - wait_start)
            if isinstance(item, EndOfFeed):
                self.done_feeding = True
                break
            if isinstance(item, EndPartition):
                if batch:
                    break
                continue
            if isinstance(item, Marker):  # unknown marker: skip
                continue
            samples = item if isinstance(item, (list, tuple)) else [item]
            self._m_chunks.inc()
            self._m_items.inc(len(samples))
            if self.input_tensors is not None:
                samples = [
                    [s[col] for col in self.input_tensors] if isinstance(s, dict) else s
                    for s in samples
                ]
            self._buffer.extend(samples)
        return batch

    def next_chunk(self, timeout: float | None = 600.0):
        """Next raw queue chunk, zero-copy — the batched-array hot path.

        For feeds that push pre-batched device-sized arrays (the
        streamed-ImageNet regime), re-slicing through :meth:`next_batch`'s
        sample buffer would only add Python-side copies; this returns each
        queue item as-is.  Over the same-host shm transport (``shm.py``)
        the item's arrays are zero-copy views straight into the producer's
        shared-memory segments, ready for ``torch.from_numpy(...).to(device)``
        — dropping the
        returned chunk releases its segment back to the producer's ring.

        Partition markers are skipped (a pre-batched chunk is already
        batch-aligned); returns ``None`` once the feed has terminated.
        ``timeout=None`` blocks until a chunk (or the terminal sentinel)
        arrives — the task-queue consumer shape used by
        ``batch.batch_worker``, where "no task yet" is an idle fleet,
        not an error.  Don't mix with :meth:`next_batch` on the same
        queue: this method bypasses (and would reorder against) its
        carry-over buffer.
        """
        if self.done_feeding:
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait_start = time.monotonic()
            try:
                item = self.mgr.queue_get(
                    self.qname_in,
                    timeout=5.0 if deadline is None
                    else max(0.1, deadline - time.monotonic()))
            except (_queue.Empty, TimeoutError):
                if deadline is None:
                    self._m_wait.record(time.monotonic() - wait_start)
                    continue
                raise TimeoutError(
                    f"no data on '{self.qname_in}' after {timeout}s")
            self._m_wait.record(time.monotonic() - wait_start)
            if isinstance(item, EndOfFeed):
                self.done_feeding = True
                return None
            if isinstance(item, Marker):
                continue
            self._m_chunks.inc()   # opaque pre-batched chunk: no item count
            return item

    def next_batch_arrays(self, batch_size: int, timeout: float = 600.0):
        """``next_batch`` + column-wise stacking into numpy arrays.

        Convenience for training and inference loops: a batch of tuple/list
        samples becomes a tuple of stacked numpy arrays; the caller moves
        them to its device with
        ``torch.from_numpy(a).to(device, non_blocking=True)``.
        Returns ``None`` when the feed has terminated.
        """
        batch = self.next_batch(batch_size, timeout=timeout)
        if not batch:
            return None
        first = batch[0]
        if isinstance(first, (tuple, list)):
            cols = len(first)
            return tuple(np.stack([np.asarray(s[i]) for s in batch]) for i in range(cols))
        return np.stack([np.asarray(s) for s in batch])

    def should_stop(self) -> bool:
        """Reference: ``TFNode.py::DataFeed.should_stop``."""
        return self.done_feeding

    # -- output ------------------------------------------------------------
    def batch_results(self, results, timeout: float = 600.0) -> None:
        """Push one batch of inference results (reference:
        ``TFNode.py::DataFeed.batch_results``)."""
        self.mgr.queue_put(self.qname_out, list(results), timeout=timeout)

    # -- teardown ----------------------------------------------------------
    def terminate(self, drain_secs: float = 3.0) -> None:
        """Signal feeders to stop and drain pending input.

        Reference: ``TFNode.py::DataFeed.terminate`` — sets
        ``state='terminating'`` then empties the input queue so Spark feed
        tasks blocked on ``put`` unblock.
        """
        logger.info("DataFeed: terminating feed")
        self.mgr.kv_set("state", "terminating")
        self.done_feeding = True
        quiet_since = time.monotonic()
        while time.monotonic() - quiet_since < drain_secs:
            try:
                item = self.mgr.queue_get(self.qname_in, timeout=0.2)
                if isinstance(item, EndOfFeed):
                    break
                quiet_since = time.monotonic()
            except (_queue.Empty, TimeoutError):
                break
