"""Driver-fed MNIST training in ``InputMode.SPARK`` — the port's MNIST slice.

The counterpart of ``examples/mnist/mnist_spark.py::main_fun``
(``BASELINE.json`` configs[0]): the driver pushes ``(image, label)`` rows
through ``cluster.train`` (the queue/shm data plane into each worker's
``DataFeed``); each worker pulls them with ``feed.next_batch_arrays``,
pads a partial batch with zero rows of weight 0 (so every step has the
same shape and the weighted loss stays exact), and trains
:class:`~tensorflowonspark_tpu_torch.models.MNISTNet` with Adam 1e-3
through :class:`~tensorflowonspark_tpu_torch.parallel.DataParallelStrategy`.
As in the example, the model trains in eval mode (``model.apply`` there is
called without ``train=True``, so dropout is off).  At ``steps`` the worker
ends the feed (``feed.terminate()``).  Every worker must be fed the same
number of batches: DDP's all-reduce waits for every replica.

    images, labels = synthetic_mnist(4096, seed=0)
    stats, weights = run_training(list(zip(images, labels)), batch_size=64)

Checkpoints and the serving export wait for ROADMAP A4; the chief writes a
``torch.save`` of its final weights (:data:`WEIGHTS_FILE`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

WEIGHTS_FILE = "mnist_train_weights.pt"


def synthetic_mnist(n: int, seed: int = 0):
    """``n`` MNIST-shaped rows from ``seed``: ``[n, 28, 28]`` float32
    images in [0, 1) and integer labels (as ``mnist_spark.py::synthetic_mnist``
    makes them), except that each image is brighter in the two rows
    ``2 * label`` and ``2 * label + 1``, so that the labels can be learnt
    and a falling loss shows the model training."""
    rng = np.random.default_rng(seed)
    images = rng.random((n, 28, 28), np.float32) * np.float32(0.5)
    labels = rng.integers(0, 10, size=n)
    for r in (0, 1):
        images[np.arange(n), 2 * labels + r, :] += np.float32(0.5)
    return images, labels


def pad_batch(batch, batch_size: int) -> tuple:
    """A fed batch ``(images, labels)`` of ``n <= batch_size`` rows as the
    step's arrays ``(x [batch_size, 1, 28, 28], y, w)``: padded with zero
    rows of weight ``w = 0`` (``mnist_spark.py:68``)."""
    x, y = batch
    n = len(x)
    pad = batch_size - n
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    x = np.concatenate([np.asarray(x, np.float32).reshape(n, 1, 28, 28),
                        np.zeros((pad, 1, 28, 28), np.float32)])
    y = np.concatenate([np.asarray(y, np.int64), np.zeros(pad, np.int64)])
    return x, y, w


def weighted_loss(model, batch):
    """The example's loss: cross-entropy weighted by ``w``, summed, over
    ``max(sum(w), 1)``."""
    import torch.nn.functional as F

    x, y, w = batch
    ce = F.cross_entropy(model(x), y, reduction="none")
    return (ce * w).sum() / w.sum().clamp_min(1.0)


def build_model(args: dict):
    """``MNISTNet`` with ``args["state_dict"]`` or weights drawn from
    ``args["seed"]`` (flax's initialisers), on the CPU."""
    from tensorflowonspark_tpu_torch.models.mnist import MNISTNet
    from tensorflowonspark_tpu_torch.models.resnet import init_params

    model = MNISTNet()
    sd = args.get("state_dict")
    model.load_state_dict(init_params(model, args.get("seed", 0)) if sd is None
                          else {k: v.clone() for k, v in sd.items()})
    return model


def map_fun(args: dict, ctx) -> None:
    """Worker half: join the process group, train on every fed batch
    until the feed ends or ``args["steps"]`` steps (then end the feed),
    and write ``<working_dir>/mnist_train_stats.<id>.json``: ``losses``
    and ``step_ms`` a step, ``rows`` consumed, ``shm_conns`` (feeder
    connections that negotiated the shared-memory transport), the flash
    kernels' ``launches`` (none on this path) and the ``device``.  The
    chief also writes its final weights (:data:`WEIGHTS_FILE`)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.bert_train import kernel_launches
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, adam
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        strategy = DataParallelStrategy(device, seed=args.get("seed", 0))
        state = strategy.init_state(build_model(args), adam(args.get("lr", 1e-3)))
        step = strategy.build_train_step(weighted_loss)
        batch_size, steps = int(args["batch_size"]), int(args.get("steps") or 0)
        feed = ctx.get_data_feed(train_mode=True)
        stats = {"losses": [], "step_ms": [], "rows": 0}
        launches0 = kernel_launches()
        while not feed.should_stop() and (steps == 0 or len(stats["losses"]) < steps):
            batch = feed.next_batch_arrays(batch_size,
                                           timeout=float(args.get("feed_timeout", 600)))
            if batch is None:
                break
            t0 = time.perf_counter()
            state, metrics = step(state, strategy.shard_batch(pad_batch(batch, batch_size)))
            stats["losses"].append(float(metrics["loss"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["rows"] += len(batch[0])
            ctx.report_step(len(stats["losses"]))
        if steps and len(stats["losses"]) >= steps:
            feed.terminate()
        stats["shm_conns"] = ctx.mgr.shm_conns
        stats["launches"] = {k: n - launches0[k] for k, n in kernel_launches().items()}
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir,
                               f"mnist_train_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
        if ctx.is_chief:
            weights = {k: v.detach().cpu() for k, v in state.module.state_dict().items()}
            torch.save(weights, os.path.join(ctx.working_dir, WEIGHTS_FILE))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_training(rows: list, *, seed: int = 0, batch_size: int = 64, steps: int = 0,
                 num_epochs: int = 1, lr: float = 1e-3, num_workers: int = 1,
                 device: str = "cuda", state_dict: dict | None = None,
                 worker_env: dict | None = None, working_dir: str | None = None,
                 timeout: float = 600.0):
    """Driver half: boot ``num_workers`` workers running :func:`map_fun`,
    feed ``rows`` ``num_epochs`` times through ``cluster.train``, shut the
    cluster down (re-raising any worker error) and return ``(stats,
    weights)``: each worker's stats dict in executor order and the chief's
    final state dict."""
    import torch

    args = {"seed": seed, "batch_size": batch_size, "steps": steps, "lr": lr,
            "device": device, "state_dict": state_dict, "feed_timeout": timeout}
    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.SPARK,
                             reservation_timeout=timeout, worker_env=worker_env,
                             working_dir=working_dir)
    try:
        cluster.train(rows, num_epochs=num_epochs, feed_timeout=timeout)
    finally:
        cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"mnist_train_stats.{i}.json")) as f:
            stats.append(json.load(f))
    weights = torch.load(os.path.join(cluster.working_dir, WEIGHTS_FILE))
    return stats, weights
