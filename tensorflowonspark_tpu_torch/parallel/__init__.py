"""Parallelism layer of the port: the data-parallel strategy over
``torch.distributed`` (DDP).  Meshes, partition rules, FSDP and the
long-context ops of the JAX package's ``parallel`` are not ported yet
(ROADMAP A6)."""

from tensorflowonspark_tpu_torch.parallel.strategy import (  # noqa: F401
    DataParallelStrategy, MultiWorkerMirroredStrategy, TrainState, adam,
    all_gather_batch, cross_replica_mean, sgd, step_generator)
