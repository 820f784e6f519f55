"""Sharded batch-inference plane: manifest-driven, checkpointed, resumable.

Port of ``tensorflowonspark_tpu/batch/``, the offline half of the serving
story: bulk predict over a shard manifest with per-shard committed
progress —

- :mod:`~tensorflowonspark_tpu_torch.batch.manifest` — :class:`ShardManifest` /
  :class:`Shard`, the ordered unit-of-work list (TFRecord files or inline
  arrays);
- :mod:`~tensorflowonspark_tpu_torch.batch.ledger` — :class:`ProgressLedger`,
  the fsync'd JSONL shard-state journal resume replays;
- :mod:`~tensorflowonspark_tpu_torch.batch.writer` — :class:`ShardWriter`
  (atomic rename-commit TFRecord parts) + :func:`read_results` (merged,
  manifest-order output);
- :mod:`~tensorflowonspark_tpu_torch.batch.worker` — :func:`batch_worker`, the
  scoring map_fun;
- :mod:`~tensorflowonspark_tpu_torch.batch.job` — :class:`BatchJob`, the
  driver-side dispatcher (assignment, reassignment, resume);
- :mod:`~tensorflowonspark_tpu_torch.batch.gridsearch` — :class:`GridSearch`,
  K trials multiplexed across one cluster.

Safe to import eagerly: torch and the model stack are imported inside the
worker map_fun (``model_builder``), not at import time.  Parts, manifests
and ``progress.jsonl`` ledgers are byte-compatible with the JAX package's,
so either package reads the other's output directory.
"""

from tensorflowonspark_tpu_torch.batch.gridsearch import (GridSearch,  # noqa: F401
                                                    expand_param_grid)
from tensorflowonspark_tpu_torch.batch.job import BatchJob  # noqa: F401
from tensorflowonspark_tpu_torch.batch.ledger import ProgressLedger  # noqa: F401
from tensorflowonspark_tpu_torch.batch.manifest import (Shard,  # noqa: F401
                                                  ShardManifest)
from tensorflowonspark_tpu_torch.batch.worker import batch_worker  # noqa: F401
from tensorflowonspark_tpu_torch.batch.writer import (ShardWriter,  # noqa: F401
                                                iter_part, iter_results,
                                                read_results)
