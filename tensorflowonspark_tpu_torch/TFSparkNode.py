"""Reference-named façade: ``tensorflowonspark.TFSparkNode`` → this module.

Port of ``tensorflowonspark_tpu/TFSparkNode.py``.  The executor-side node
runtime (``TFSparkNode.py::run/train/inference``) lives in
:mod:`~tensorflowonspark_tpu_torch.node`; the driver-side feed closures
the reference kept here are methods on
:class:`~tensorflowonspark_tpu_torch.cluster.TPUCluster`.  Re-exported for
import parity.
"""

from __future__ import annotations

from tensorflowonspark_tpu_torch.node import (NodeContext, run,  # noqa: F401
                                              start_cluster_server)

TFNodeContext = NodeContext  # reference class name
TFSparkNode = NodeContext    # module-level alias some user code touches
