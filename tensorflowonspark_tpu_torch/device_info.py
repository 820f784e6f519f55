"""Accelerator discovery and visibility, over ``torch.cuda``.

Port of ``tensorflowonspark_tpu/device_info.py`` (and the reference's
``tensorflowonspark/gpu_info.py``).  The JAX module enumerates TPU chips
through ``jax.devices()`` and sets ``TPU_VISIBLE_DEVICES``; here the
devices are the CUDA cards PyTorch sees, and visibility is
``CUDA_VISIBLE_DEVICES``.  :func:`card_name_and_limit` reads the card's
name and power limit from ``nvidia-smi``, which every measurement of the
port prints beside its numbers.
"""

from __future__ import annotations

import logging
import subprocess

logger = logging.getLogger(__name__)


def num_local_devices() -> int:
    """Number of CUDA cards visible to this process (0 without CUDA)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def device_summary() -> list[dict]:
    """One dict per visible card: id, platform, kind (the card's name),
    memory in bytes and compute capability."""
    import torch

    out = []
    for i in range(num_local_devices()):
        props = torch.cuda.get_device_properties(i)
        out.append({
            "id": i,
            "process_index": 0,
            "platform": "gpu",
            "kind": props.name,
            "memory_bytes": props.total_memory,
            "capability": f"{props.major}.{props.minor}",
        })
    return out


def visibility_env(device_ids=None) -> dict:
    """The env-var dict that limits a child process to ``device_ids``
    (``CUDA_VISIBLE_DEVICES``, as the reference's ``get_gpus`` result
    was used); empty when ``device_ids`` is None."""
    if device_ids is None:
        return {}
    return {"CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in device_ids)}


def get_gpus(num_gpu: int = 1, worker_index: int = -1, format_as_csv: bool = True):
    """API-parity shim for ``gpu_info.py::get_gpus``: the first
    ``num_gpu`` visible card ids (the reference probed ``nvidia-smi`` for
    free ones).  With none visible and ``worker_index >= 0``, the worker's
    index modulo the device count (as the JAX package's shim does)."""
    ids = list(range(num_local_devices()))[:num_gpu]
    if worker_index >= 0 and not ids:
        ids = [worker_index % max(1, num_local_devices())]
    return ",".join(map(str, ids)) if format_as_csv else ids


def card_name_and_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
    one line a card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``.  A card set
    below its maximum power runs slower under load, so every number the
    port keeps names this line beside it.  Raises if ``nvidia-smi`` fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
