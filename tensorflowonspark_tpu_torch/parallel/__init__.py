"""Parallelism layer of the port: meshes, shardings, strategies and the
long-context ops, over ``torch.distributed``.

Port of ``tensorflowonspark_tpu/parallel``: a
:class:`~torch.distributed.device_mesh.DeviceMesh` with the JAX package's
named axes (``dp``, ``fsdp``, ``tp``, ``sp``, ``pp``, ``ep``) over the
ranks of the process group, partition rules as DTensor placements, the
data-parallel (DDP), mesh and FSDP (FSDP2) strategies with their
optax-exact optimizers, the vocab-sharded embedding tables over an
embedding process group (the reference's parameter servers), ring and
Ulysses sequence-parallel attention, the tp×sp transformer stage, GPipe
and 1F1B pipelines over ``pp`` and the expert-parallel MoE layer over
``ep``.  The collectives and their autograd transposes are in
:mod:`.comm`.
"""

from tensorflowonspark_tpu_torch.parallel.mesh import (AXES, MeshSpec,  # noqa: F401
                                                       make_hybrid_mesh, make_mesh,
                                                       mesh_from_num_ps)
from tensorflowonspark_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionRules, batch_pspec, named_sharding, shard_batch, shard_params)
from tensorflowonspark_tpu_torch.parallel.embedding import (  # noqa: F401
    ShardedEmbedding, apply_sharded_lookup, build_sparse_embedding_train_step,
    sharded_embedding_lookup)
from tensorflowonspark_tpu_torch.parallel.strategy import (  # noqa: F401
    DataParallelStrategy, FSDPStrategy, MeshStrategy, MultiWorkerMirroredStrategy,
    OptaxAdagrad, OptaxRMSprop, TrainState, adagrad, adam, all_gather_batch,
    cross_replica_mean, exponential_decay, rmsprop, sgd, step_generator)
from tensorflowonspark_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention, ring_self_attention)
from tensorflowonspark_tpu_torch.parallel.transformer import (  # noqa: F401
    make_transformer_stage)
from tensorflowonspark_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention, ulysses_self_attention)
from tensorflowonspark_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipelineStrategy, pipeline_apply, pipeline_value_and_grad, stack_stage_params)
from tensorflowonspark_tpu_torch.parallel.moe import make_moe_layer, moe_apply  # noqa: F401
