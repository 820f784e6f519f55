"""Parallelism layer of the port: the data-parallel strategy over
``torch.distributed`` (DDP), its optax-exact optimizers, and the
vocab-sharded embedding tables over an embedding process group (the
reference's parameter servers).  Meshes, partition rules, FSDP and the
long-context ops of the JAX package's ``parallel`` are not ported yet
(ROADMAP A6)."""

from tensorflowonspark_tpu_torch.parallel.embedding import (  # noqa: F401
    ShardedEmbedding, apply_sharded_lookup, build_sparse_embedding_train_step,
    sharded_embedding_lookup)
from tensorflowonspark_tpu_torch.parallel.strategy import (  # noqa: F401
    DataParallelStrategy, MultiWorkerMirroredStrategy, OptaxAdagrad, OptaxRMSprop,
    TrainState, adagrad, adam, all_gather_batch, cross_replica_mean, exponential_decay,
    rmsprop, sgd, step_generator)
