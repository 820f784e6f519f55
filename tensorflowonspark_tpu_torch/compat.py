"""TF-version compatibility shims, reinterpreted for the PyTorch port.

Port of ``tensorflowonspark_tpu/compat.py``: the reference's
``tensorflowonspark/compat.py`` papered over TF 2.x API churn with
``export_saved_model``, ``disable_auto_shard`` and ``is_gpu_available``;
the port keeps the same three names so reference-era user code imports
cleanly, each with its PyTorch meaning.  The JAX package's shims for its
own jax-version churn (``shard_map``, ``axis_size``, ``pcast``,
``vma_of``, ``has_vma``, ``bound_axes``) have no torch meaning and are
left out.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def export_saved_model(model, export_dir: str, is_chief: bool = False):
    """Reference: ``compat.py::export_saved_model(model, dir, is_chief)``.

    ``model`` is a ``(fn, params, example_inputs)`` triple or a dict with
    those keys; delegates to :func:`~tensorflowonspark_tpu_torch.checkpoint.
    export_model` (a ``torch.export`` program over a state dict, the
    SavedModel equivalent).  Chief-only, like the reference."""
    from tensorflowonspark_tpu_torch.checkpoint import export_model

    if isinstance(model, dict):
        fn, params, inputs = model["fn"], model["params"], model["example_inputs"]
    else:
        fn, params, inputs = model
    return export_model(export_dir, fn, params, inputs, is_chief=is_chief)


def disable_auto_shard(options) -> None:
    """Reference: ``compat.py::disable_auto_shard(options)`` — turned off
    tf.data auto-sharding under MultiWorkerMirrored.  The port's input
    pipelines shard explicitly (``ctx.executor_id`` / ``shard_batch``), so
    there is nothing to disable; kept as a no-op for source compatibility."""
    logger.debug("disable_auto_shard: no-op in the PyTorch port")


def is_gpu_available() -> bool:
    """Reference: ``compat.py::is_gpu_available()``: whether PyTorch sees
    a CUDA card (``torch.cuda.is_available()``)."""
    import torch

    return torch.cuda.is_available()
