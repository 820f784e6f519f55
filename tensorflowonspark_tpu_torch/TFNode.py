"""Reference-named façade: ``tensorflowonspark.TFNode`` → this module.

Port of ``tensorflowonspark_tpu/TFNode.py``: the in-graph user API a
reference ``map_fun`` imports (``TFNode.py::DataFeed/hdfs_path/
start_cluster_server``), re-exported over the port's implementations::

    from tensorflowonspark_tpu_torch import TFNode
    def map_fun(args, ctx):
        tf_feed = TFNode.DataFeed(ctx.mgr, train_mode=True)
        path = TFNode.hdfs_path(ctx, args.model_dir)

The reference's ``export_saved_model`` is the port's
:func:`~tensorflowonspark_tpu_torch.checkpoint.export_model` (a
``torch.export`` program over a state dict).
"""

from __future__ import annotations

from tensorflowonspark_tpu_torch.checkpoint import export_model  # noqa: F401
from tensorflowonspark_tpu_torch.datafeed import DataFeed  # noqa: F401
from tensorflowonspark_tpu_torch.node import start_cluster_server  # noqa: F401
from tensorflowonspark_tpu_torch.util import hdfs_path  # noqa: F401

export_saved_model = export_model


def batch_results(mgr, results, qname: str = "output") -> None:
    """TF1-era module-level helper (``TFNode.py::batch_results``); the
    DataFeed method is the modern path."""
    mgr.queue_put(qname, list(results))
