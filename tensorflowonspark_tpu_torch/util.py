"""Small utilities shared across the port.

Port of ``tensorflowonspark_tpu/util.py``: the framework-free helpers
(``split_evenly``, ``find_in_path``, ``get_free_port``, ``hdfs_path``) are
copied; the JAX helpers (compile cache, platform env, host-fetch drain) are
replaced by :func:`resolve_device`, which never falls back to the CPU.
"""

from __future__ import annotations

import os
import socket


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` and ``"cuda"`` mean the card: raise if PyTorch sees none,
    rather than quietly running on the CPU.  ``"cpu"`` (what the tests
    pass) is honoured as asked.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def strict_matmul_precision() -> None:
    """Matrix products as the JAX package computes them: float32 products
    in full float32 (no TF32, in cuBLAS or cuDNN) and bf16 products
    accumulated in float32 (no reduced-precision reductions)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def split_evenly(items: list, n: int) -> list[list]:
    """Split ``items`` into at most ``n`` non-empty contiguous partitions.

    Shared by the cluster feeder's RDD-partition stand-in and DataFrame
    construction so both layers agree on partition shapes.
    """
    n = max(1, min(n, len(items)) if items else 1)
    size = (len(items) + n - 1) // n
    return [items[i * size:(i + 1) * size]
            for i in range(n) if items[i * size:(i + 1) * size]]


def find_in_path(path: str, file_name: str) -> str | bool:
    """Find a file within a search-path string.  Reference: ``util.py::find_in_path``."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return False


def get_free_port(host: str = "") -> int:
    """Reserve an ephemeral port (bind + close), as the reference's node
    runtime does when pre-binding the TF server port (``TFSparkNode.py::run``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def hdfs_path(ctx, path: str) -> str:
    """Resolve a user path against the cluster's default FS / working dir.

    Reference: ``TFNode.py::hdfs_path`` — absolute schemes pass through,
    relative paths are joined against ``ctx.defaultFS`` + working dir.
    """
    if any(path.startswith(p) for p in ("hdfs://", "gs://", "viewfs://", "file://", "s3://")):
        return path
    if path.startswith("/"):
        default_fs = getattr(ctx, "default_fs", "") or ""
        if default_fs and not default_fs.startswith("file://"):
            return default_fs.rstrip("/") + path
        return path
    # relative path
    working_dir = getattr(ctx, "working_dir", None) or os.getcwd()
    default_fs = getattr(ctx, "default_fs", "") or ""
    if default_fs and not default_fs.startswith("file://"):
        return f"{default_fs.rstrip('/')}/{working_dir.lstrip('/')}/{path}"
    return os.path.join(working_dir, path)
