"""Reference-named façade: ``tensorflowonspark.TFCluster`` → this module.

Port of ``tensorflowonspark_tpu/TFCluster.py``.  A reference user's driver
script does::

    from tensorflowonspark_tpu_torch import TFCluster
    cluster = TFCluster.run(sc, map_fun, args, num_executors, num_ps,
                            tensorboard, TFCluster.InputMode.SPARK)
    cluster.train(dataRDD, num_epochs)
    cluster.shutdown()

This module keeps that exact call shape (``TFCluster.py::run``): ``sc`` is
accepted and ignored (there is no Spark; pass ``None``), everything else
maps onto :class:`tensorflowonspark_tpu_torch.cluster.TPUCluster`.
"""

from __future__ import annotations

import logging

from tensorflowonspark_tpu_torch.cluster import (InputMode, Partitioned,  # noqa: F401
                                                 TPUCluster)

logger = logging.getLogger(__name__)

# the reference exposes the class as TFCluster.TFCluster
TFCluster = TPUCluster


def run(sc, map_fun, tf_args, num_executors: int, num_ps: int = 0,
        tensorboard: bool = False, input_mode: int = InputMode.TENSORFLOW,
        log_dir: str | None = None, driver_ps_nodes: bool = False,
        master_node: str | None = None, reservation_timeout: float = 600.0,
        queues=("input", "output", "error"), eval_node: bool = False,
        release_port: bool = True, **kwargs) -> TPUCluster:
    """Reference: ``TFCluster.py::run`` — same positional signature.

    ``sc`` (the SparkContext) is unused: the cluster backend replaces Spark.
    ``release_port`` is advisory (ports are bound by the node runtime).
    ``log_dir`` is the TensorBoard logdir.  Extra ``kwargs`` (``backend=``,
    ``worker_env=``, ``working_dir=``, ...) pass through to
    ``TPUCluster.run``.
    """
    if callable(sc):
        # a map_fun in the sc slot means the caller used TPUCluster.run's
        # signature (no sc); fail loudly instead of shifting every arg by one
        raise TypeError(
            "TFCluster.run's first argument is the (ignored) SparkContext — "
            "pass None, or call TPUCluster.run(map_fun, ...) for the "
            "sc-less signature")
    if sc is not None:
        logger.info("TFCluster.run: SparkContext argument ignored (no Spark here)")
    return TPUCluster.run(
        map_fun, tf_args, num_executors, num_ps=num_ps,
        tensorboard=tensorboard, input_mode=input_mode,
        master_node=master_node, eval_node=eval_node,
        driver_ps_nodes=driver_ps_nodes,
        reservation_timeout=reservation_timeout,
        queues=list(queues), tensorboard_logdir=log_dir, **kwargs)
