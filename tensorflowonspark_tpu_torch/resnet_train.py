"""ResNet training in ``InputMode.TENSORFLOW`` — the port's ResNet slice.

The counterpart of ``examples/resnet/resnet_cifar.py::main_fun`` and of
the training step ``bench.py::bench_resnet`` times: the driver boots a
cluster with :func:`map_fun` and feeds nothing; each worker makes its own
synthetic shard from ``(seed, executor_id)`` (as the example's ``_shard``
does), reads it through a :class:`~tensorflowonspark_tpu_torch.data.Dataset`
and :func:`~tensorflowonspark_tpu_torch.data.device_prefetch`, and trains
a ResNet with BatchNorm statistics through
:class:`~tensorflowonspark_tpu_torch.parallel.DataParallelStrategy` and SGD
with momentum 0.9 (lr 0.1, as ``bench.py`` sets them).  With more than one
worker the replicas are DDP over the cluster's process group and BatchNorm
reduces over the global batch, so the run equals one process trained on
every worker's batches side by side (:func:`train_in_process`).

    args = {"model": "ResNet50", "image_size": 224, "batch_size": 128,
            "steps": 8, "num_samples": 1024, "seed": 0}
    stats, weights = run_training(args, num_workers=1)

``args`` keys: ``model`` (``ResNet18``, ``ResNet34``, ``ResNet50`` or
``CifarResNet``) and ``model_kwargs`` (constructor overrides such as
``stage_sizes`` or ``num_filters``), ``dtype`` and ``bn`` (the convolution
and BatchNorm dtypes: ``bfloat16`` and ``float32`` by default, flax's
defaults), ``image_size``, ``batch_size``, ``steps``, ``lr``,
``num_samples`` (the cluster's; each worker makes ``num_samples //
num_workers``), ``seed``, ``state_dict`` (weights; else drawn from
``seed``) and ``device`` (the card unless ``"cpu"``).  Checkpoints wait for
ROADMAP A4; the chief writes a ``torch.save`` of its final weights and
BatchNorm buffers (:data:`WEIGHTS_FILE`).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

WEIGHTS_FILE = "resnet_train_weights.pt"
DEFAULTS = {"model": "ResNet50", "model_kwargs": {}, "dtype": "bfloat16", "bn": "float32",
            "image_size": 224, "batch_size": 128, "steps": 8, "lr": 0.1,
            "num_samples": 1024, "seed": 0}


def _args(args: dict) -> dict:
    return {**DEFAULTS, **args}


def build_model(args: dict):
    """The ResNet ``args`` names, with its weights (``args["state_dict"]``
    or :func:`~tensorflowonspark_tpu_torch.models.resnet.init_params` of
    ``seed``), on the CPU."""
    import torch

    from tensorflowonspark_tpu_torch.models import resnet

    args = _args(args)
    model = getattr(resnet, args["model"])(
        dtype=getattr(torch, args["dtype"]), norm_dtype=getattr(torch, args["bn"]),
        **args["model_kwargs"])
    sd = args.get("state_dict")
    model.load_state_dict(resnet.init_params(model, args["seed"]) if sd is None
                          else {k: v.clone() for k, v in sd.items()})
    return model


def make_shard(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """Worker ``executor_id``'s synthetic shard: ``num_samples //
    num_workers`` NHWC float32 images in [0, 1) and integer labels, from
    ``(seed, executor_id)`` (``examples/resnet/resnet_cifar.py::_shard``)."""
    args = _args(args)
    rng = np.random.default_rng([args["seed"], executor_id])
    n, size = args["num_samples"] // num_workers, args["image_size"]
    return (rng.random((n, size, size, 3), np.float32),
            rng.integers(0, num_classes, n).astype(np.int64))


def batches(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """Worker ``executor_id``'s ``steps`` batches as a ``Dataset``: its
    shard shuffled (seeded from ``(seed, executor_id)``), batched with the
    remainder dropped, repeated, and each batch an NCHW tensor in the
    convolution dtype (the model's first cast, made on the host so the
    copy moves half the bytes in bf16) with int64 labels."""
    import torch

    from tensorflowonspark_tpu_torch.data import Dataset

    args = _args(args)
    images, labels = make_shard(args, executor_id, num_workers, num_classes)
    dtype = getattr(torch, args["dtype"])

    def nchw(batch):
        x, y = batch
        return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype), torch.from_numpy(y)

    return (Dataset.from_tensor_slices((images, labels))
            .shuffle(len(images), seed=1_000_003 * args["seed"] + executor_id)
            .batch(args["batch_size"], drop_remainder=True)
            .repeat()
            .take(args["steps"])
            .map(nchw)
            .prefetch(2))


def cross_entropy(model, batch):
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` of
    a train-mode forward (which updates the BatchNorm statistics)."""
    import torch.nn.functional as F

    x, y = batch
    return F.cross_entropy(model(x, train=True), y)


def _strategy_state(args: dict, device):
    import torch

    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, sgd

    model = build_model(args)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
        torch.backends.cudnn.benchmark = True  # fixed shapes: autotune at the first step
    strategy = DataParallelStrategy(device, seed=args["seed"])
    state = strategy.init_state(model, sgd(args["lr"]))
    return state, strategy.build_train_step(cross_entropy)


def map_fun(args: dict, ctx) -> None:
    """Worker half: join the cluster's process group, train ``steps``
    steps on this worker's shard, and write
    ``<working_dir>/resnet_train_stats.<id>.json``: ``losses`` and
    ``step_ms`` a step (host clock after the loss is read, which
    synchronises the device), ``images``, the flash kernels' ``launches``
    (none on this path) and the ``device``.  The chief also writes its
    final weights and BatchNorm buffers (:data:`WEIGHTS_FILE`)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.bert_train import kernel_launches
    from tensorflowonspark_tpu_torch.data import device_prefetch
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    args = _args(args)
    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        state, step = _strategy_state(args, device)
        num_classes = state.module.fc.out_features
        stats = {"losses": [], "step_ms": [], "images": 0}
        launches0 = kernel_launches()
        data = batches(args, ctx.executor_id, ctx.num_workers, num_classes)
        for batch in device_prefetch(iter(data), device=device):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            stats["losses"].append(float(metrics["loss"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["images"] += len(batch[1])
            ctx.report_step(len(stats["losses"]))
        stats["launches"] = {k: n - launches0[k] for k, n in kernel_launches().items()}
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir,
                               f"resnet_train_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
        if ctx.is_chief:
            weights = {k: v.detach().cpu() for k, v in state.module.state_dict().items()}
            torch.save(weights, os.path.join(ctx.working_dir, WEIGHTS_FILE))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_training(args: dict, num_workers: int = 1, worker_env: dict | None = None,
                 working_dir: str | None = None, timeout: float = 600.0):
    """Driver half: boot ``num_workers`` workers running :func:`map_fun`
    in ``InputMode.TENSORFLOW``, wait for them (re-raising any worker
    error) and return ``(stats, weights)``: each worker's stats dict in
    executor order and the chief's final state dict."""
    import torch

    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=timeout, worker_env=worker_env,
                             working_dir=working_dir)
    cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"resnet_train_stats.{i}.json")) as f:
            stats.append(json.load(f))
    weights = torch.load(os.path.join(cluster.working_dir, WEIGHTS_FILE))
    return stats, weights


def train_in_process(args: dict, num_workers: int = 1, device=None):
    """The cluster's run replayed in this process: one replica trained on
    every worker's batches side by side (worker 0's first), which is what
    DDP with global-batch BatchNorm computes.  Returns ``(losses,
    weights)``: the mean loss a step and the final state dict on the
    CPU."""
    import torch

    from tensorflowonspark_tpu_torch.data import device_prefetch
    from tensorflowonspark_tpu_torch.util import resolve_device

    args = _args(args)
    device = resolve_device(device if device is not None else args.get("device"))
    state, step = _strategy_state(args, device)
    num_classes = state.module.fc.out_features
    streams = [batches(args, i, num_workers, num_classes) for i in range(num_workers)]
    losses = []
    for parts in zip(*streams):
        batch = tuple(torch.cat([p[c] for p in parts]) for c in range(2))
        batch = next(device_prefetch(iter([batch]), device=device))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, {k: v.detach().cpu() for k, v in state.module.state_dict().items()}
