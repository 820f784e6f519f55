"""tensorflowonspark_tpu_torch — the PyTorch/CUDA port of tensorflowonspark_tpu.

The JAX package ``tensorflowonspark_tpu`` is the reference; this package
faces it module by module (same file names, same public names) and runs on
an NVIDIA GPU, with every TPU kernel on its path rewritten as a CUDA kernel
under ``ops/csrc``.  It imports nothing of JAX and nothing of the JAX
package.

    from tensorflowonspark_tpu_torch import TPUCluster, InputMode
    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.SPARK)
    cluster.train(data, num_epochs)
    preds = cluster.inference(rows)
    cluster.shutdown()

or, in the reference's own call shape, ``TFCluster.run(None, map_fun,
args, num_executors, num_ps, tensorboard, input_mode)`` (``sc`` is
ignored); ``agent.AgentBackend`` runs the workers on other hosts' agents.

Inside ``map_fun(args, ctx)`` the user pulls data with
``ctx.get_data_feed()`` (SPARK mode) or reads its own shard with
:class:`Dataset` (``Dataset.from_examples`` over TFRecords, TENSORFLOW
mode), checkpoints into ``model_dir`` with :class:`CheckpointManager`,
and the chief writes a serving export with :func:`export_model` that
:class:`ExportedModel` loads.  Above the cluster sit the ML pipeline
(``TFEstimator(train_fn, args).fit(df)`` returns a :class:`TFModel` whose
``transform(df)`` serves the export), the ``model_dir`` trainer
(:class:`Estimator` with :func:`train_and_evaluate`) and
:func:`run_with_recovery`, which relaunches a job after a lost worker,
the online tier (``serving.ServingCluster``), the batch-inference plane
(``batch.BatchJob``) and the continual loop
(``continual.ContinualPipeline``).  The root exports the reference root's names for every module ported so
far.

Entry points run on the card unless the caller passes ``device="cpu"``;
a missing GPU raises instead of falling back.
"""

__version__ = "0.1.0"

from tensorflowonspark_tpu_torch.cluster import (InputMode, TPUCluster,  # noqa: E402,F401
                                                 run_with_recovery)
from tensorflowonspark_tpu_torch.datafeed import DataFeed  # noqa: E402,F401
from tensorflowonspark_tpu_torch.health import (ClusterFailure, ClusterMonitor,  # noqa: F401
                                                HeartbeatReporter)
from tensorflowonspark_tpu_torch.node import NodeContext  # noqa: E402,F401
from tensorflowonspark_tpu_torch.checkpoint import (CheckpointManager,  # noqa: F401
                                                    ExportedModel, export_model,
                                                    restore_checkpoint, save_checkpoint)
from tensorflowonspark_tpu_torch.data import Dataset, device_prefetch  # noqa: F401
from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row  # noqa: F401
from tensorflowonspark_tpu_torch.preemption import PreemptionGuard  # noqa: F401
from tensorflowonspark_tpu_torch.pipeline import (Namespace, Pipeline,  # noqa: F401
                                                  ParamGridBuilder, TFEstimator,
                                                  TFModel, TrainValidationSplit,
                                                  CrossValidator)
from tensorflowonspark_tpu_torch import gpu_info, metrics, tracing  # noqa: F401,E402
# ``from tensorflowonspark import TFCluster, TFNode`` maps onto
# ``from tensorflowonspark_tpu_torch import TFCluster, TFNode`` (module
# objects with the reference's entry points: TFCluster.run(sc, ...),
# TFNode.DataFeed, TFManager.start/connect, compat.*)
from tensorflowonspark_tpu_torch import (TFCluster, TFManager, TFNode,  # noqa: F401,E402
                                         TFSparkNode, compat)
# the batch-inference plane (manifest-driven, resumable bulk predict) and
# the continual loop (checkpoint publication, offline gate, journaled
# rollout); their model imports happen inside the worker map_fun
from tensorflowonspark_tpu_torch import batch, continual  # noqa: F401,E402

# the Estimator and the online serving tier (over ContinuousBatcher
# replicas) import torch: they load at their first use, so a worker whose
# map_fun needs neither starts without torch
_LAZY = {"Estimator": "estimator", "EvalSpec": "estimator", "TrainSpec": "estimator",
         "train_and_evaluate": "estimator", "serving": "serving"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    value = mod if name == _LAZY[name] else getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
