"""Reference-named façade: ``tensorflowonspark.TFManager`` → this module.

Port of ``tensorflowonspark_tpu/TFManager.py``.  The reference's
``TFManager`` is a ``multiprocessing.managers.BaseManager`` serving
per-node queues + a kv dict (``TFManager.py::start/connect``); the port's
:mod:`~tensorflowonspark_tpu_torch.queues` serves the same queue/kv
surface over its own length-prefixed socket protocol at chunk
granularity.  These wrappers keep the reference's module-level entry
points.
"""

from __future__ import annotations

from tensorflowonspark_tpu_torch.queues import (DEFAULT_QUEUES, QueueClient,  # noqa: F401
                                                QueueServer)

TFManager = QueueServer  # the class the reference exposes


def start(authkey: bytes, queues=DEFAULT_QUEUES, mode: str = "local") -> QueueServer:
    """Reference: ``TFManager.py::start(authkey, queues, mode)`` — create and
    start this node's queue server ('local' binds loopback, 'remote' all
    interfaces)."""
    mgr = QueueServer(authkey=authkey, qnames=list(queues), mode=mode)
    mgr.start()
    return mgr


def connect(addr, authkey: bytes) -> QueueClient:
    """Reference: ``TFManager.py::connect(address, authkey)``."""
    return QueueClient(tuple(addr), authkey)
