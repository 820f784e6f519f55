"""ResNet training in ``InputMode.TENSORFLOW`` — the port's ResNet slice.

The counterpart of ``examples/resnet/resnet_cifar.py::main_fun`` and of
the training step ``bench.py::bench_resnet`` times: the driver boots a
cluster with :func:`map_fun` and feeds nothing; each worker reads its own
shard through a :class:`~tensorflowonspark_tpu_torch.data.Dataset` and
:func:`~tensorflowonspark_tpu_torch.data.device_prefetch` — from
``data_dir``'s TFRecord part files (:func:`write_tfrecords`: raw uint8 HWC
image bytes and an int64 label a record, worker ``i``'s shard in
``part-r-0000i``, read with ``Dataset.from_examples(..., shard=(num_workers,
executor_id))`` as the example's ``loadTFRecords`` path does), or else a
synthetic shard made in memory from ``(seed, executor_id)`` (as the
example's ``_shard`` does) — and trains
a ResNet with BatchNorm statistics through
:class:`~tensorflowonspark_tpu_torch.parallel.DataParallelStrategy` and SGD
with momentum 0.9 (lr 0.1, as ``bench.py`` sets them).  With more than one
worker the replicas are DDP over the cluster's process group and BatchNorm
reduces over the global batch, so the run equals one process trained on
every worker's batches side by side (:func:`train_in_process`).

    args = {"model": "ResNet50", "image_size": 224, "batch_size": 128,
            "steps": 8, "num_samples": 1024, "seed": 0, "model_dir": "/tmp/r50"}
    stats, weights = run_training(args, num_workers=1)

``args`` keys: ``model`` (``ResNet18``, ``ResNet34``, ``ResNet50`` or
``CifarResNet``) and ``model_kwargs`` (constructor overrides such as
``stage_sizes`` or ``num_filters``), ``dtype`` and ``bn`` (the convolution
and BatchNorm dtypes: ``bfloat16`` and ``float32`` by default, flax's
defaults), ``image_size``, ``batch_size``, ``steps``, ``lr``,
``num_samples`` (the cluster's; each worker reads ``num_samples //
num_workers``), ``seed``, ``state_dict`` (weights; else drawn from
``seed``), ``device`` (the card unless ``"cpu"``), ``data_dir``,
``model_dir`` and ``save_every``.

Checkpoints: with ``model_dir`` every worker saves, through a
:class:`~tensorflowonspark_tpu_torch.checkpoint.CheckpointManager`, the
model with its BatchNorm buffers, the SGD momentum, the step and the input
position (``{"elements_consumed": batches the steps took}``, not the
batches the prefetch ran ahead to) every ``save_every`` steps and at the
end.  A run with a ``model_dir`` that holds a checkpoint restores the
latest one, skips the batches it consumed and trains only the steps left
to ``steps``.  The worker trains under a
:class:`~tensorflowonspark_tpu_torch.preemption.PreemptionGuard`: a
SIGTERM to every worker (a preempted job) makes each save at the next step
boundary and return cleanly.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

DEFAULTS = {"model": "ResNet50", "model_kwargs": {}, "dtype": "bfloat16", "bn": "float32",
            "image_size": 224, "batch_size": 128, "steps": 8, "lr": 0.1,
            "num_samples": 1024, "seed": 0, "data_dir": None, "model_dir": None,
            "save_every": 0}


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


def uint8_shard(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """Worker ``executor_id``'s shard as the records hold it: ``num_samples
    // num_workers`` NHWC uint8 images and int64 labels, from ``(seed,
    executor_id)``."""
    args = _args(args)
    rng = np.random.default_rng([args["seed"], executor_id, 8])
    n, size = args["num_samples"] // num_workers, args["image_size"]
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, num_classes, n).astype(np.int64))


def write_tfrecords(args: dict, data_dir: str, num_workers: int, num_classes: int) -> int:
    """Write every worker's :func:`uint8_shard` under ``data_dir`` as
    ``tf.train.Example`` TFRecords through ``dfutil.saveAsTFRecords``: one
    part file a worker, a record ``{"image": raw HWC bytes, "label":
    int64}``.  Returns the record count."""
    from tensorflowonspark_tpu_torch import dfutil
    from tensorflowonspark_tpu_torch.dataframe import DataFrame

    parts = []
    for i in range(num_workers):
        images, labels = uint8_shard(args, i, num_workers, num_classes)
        parts.append([{"image": x.tobytes(), "label": int(y)} for x, y in zip(images, labels)])
    return dfutil.saveAsTFRecords(DataFrame.from_partitions(parts), data_dir)


def examples(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """Worker ``executor_id``'s ``(image HWC, label)`` examples: read from
    ``data_dir``'s part files, or the synthetic float32 shard."""
    from tensorflowonspark_tpu_torch.data import Dataset

    args = _args(args)
    if not args["data_dir"]:
        return Dataset.from_tensor_slices(make_shard(args, executor_id, num_workers,
                                                     num_classes))
    size = args["image_size"]

    def decode(ex):
        return np.frombuffer(ex["image"], np.uint8).reshape(size, size, 3), np.int64(ex["label"])

    return Dataset.from_examples(os.path.join(args["data_dir"], "part-r-*"),
                                 binary_features=("image",),
                                 shard=(num_workers, executor_id)).map(decode)


def raw_batches(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """Worker ``executor_id``'s ``steps`` batches of ``(images NHWC,
    labels)`` as a ``Dataset``: its examples shuffled (seeded from ``(seed,
    executor_id)``), batched with the remainder dropped and repeated."""
    args = _args(args)
    return (examples(args, executor_id, num_workers, num_classes)
            .shuffle(args["num_samples"] // num_workers,
                     seed=1_000_003 * args["seed"] + executor_id)
            .batch(args["batch_size"], drop_remainder=True)
            .repeat()
            .take(args["steps"]))


def batches(args: dict, executor_id: int, num_workers: int, num_classes: int):
    """:func:`raw_batches` as the step takes them: each batch an NCHW
    tensor in the convolution dtype (uint8 images scaled to [0, 1]; the
    model's first cast, made on the host so the copy moves half the bytes
    in bf16) with int64 labels, prefetched."""
    import torch

    args = _args(args)
    dtype = getattr(torch, args["dtype"])

    def nchw(batch):
        x, y = batch
        x = torch.from_numpy(x).permute(0, 3, 1, 2)
        if x.dtype == torch.uint8:
            x = x.float().mul_(1.0 / 255)
        return x.to(dtype), torch.from_numpy(y)

    return (raw_batches(args, executor_id, num_workers, num_classes)
            .map(nchw)
            .prefetch(2))


def cross_entropy(model, batch):
    """``optax.softmax_cross_entropy_with_integer_labels(...).mean()`` of
    a train-mode forward (which updates the BatchNorm statistics)."""
    import torch.nn.functional as F

    x, y = batch
    return F.cross_entropy(model(x, train=True), y)


def strategy_state(args: dict, device):
    """``(TrainState, train step)`` of the model ``args`` names on
    ``device``: SGD with momentum, channels_last and cuDNN autotuning on
    the card."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, sgd

    args = _args(args)
    model = build_model(args)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
        torch.backends.cudnn.benchmark = True  # fixed shapes: autotune at the first step
    strategy = DataParallelStrategy(device, seed=args["seed"])
    state = strategy.init_state(model, sgd(args["lr"]))
    return state, strategy.build_train_step(cross_entropy)


def checkpoint_state(state, consumed: int) -> dict:
    """What a checkpoint holds: the strategy's state (model with its
    BatchNorm buffers, SGD momentum, step) and the input position,
    ``consumed`` batches."""
    return {**state.state_dict(), "data": {"elements_consumed": consumed}}


def map_fun(args: dict, ctx) -> None:
    """Worker half: join the cluster's process group, restore the latest
    checkpoint of ``model_dir`` if there is one, train the steps left to
    ``steps`` on this worker's shard (checkpointing as the module docstring
    says), and write ``<working_dir>/resnet_train_stats.<id>.json``:
    ``losses`` and ``step_ms`` a step of this run (host clock after the
    loss is read, which synchronises the device), ``images``,
    ``first_step`` (the step this run started from), ``preempted``, the
    flash kernels' ``launches`` (none on this path) and the ``device``."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.bert_train import kernel_launches
    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.data import device_prefetch
    from tensorflowonspark_tpu_torch.preemption import PreemptionGuard
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    args = _args(args)
    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        with PreemptionGuard() as guard:
            state, step = strategy_state(args, device)
            mngr = CheckpointManager(args["model_dir"]) if args["model_dir"] else None
            restored = mngr.restore() if mngr else None
            if restored is not None:
                state.load_state_dict(restored)
            consumed = int(restored["data"]["elements_consumed"]) if restored else 0
            num_classes = state.module.fc.out_features
            stats = {"losses": [], "step_ms": [], "images": 0, "first_step": state.step}
            launches0 = kernel_launches()
            data = batches(args, ctx.executor_id, ctx.num_workers, num_classes)
            for batch in device_prefetch(data.checkpointable({"elements_consumed": consumed}),
                                         device=device):
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                consumed += 1
                stats["losses"].append(float(metrics["loss"]))
                stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
                stats["images"] += len(batch[1])
                ctx.report_step(state.step)
                if guard.preempted:
                    break
                if mngr and args["save_every"] and state.step % args["save_every"] == 0:
                    mngr.save(state.step, checkpoint_state(state, consumed))
            if mngr:
                mngr.save(state.step, checkpoint_state(state, consumed))
                mngr.close()
            stats["preempted"] = guard.preempted
        stats["launches"] = {k: n - launches0[k] for k, n in kernel_launches().items()}
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir,
                               f"resnet_train_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_training(args: dict, num_workers: int = 1, worker_env: dict | None = None,
                 working_dir: str | None = None, timeout: float = 600.0):
    """Driver half: boot ``num_workers`` workers running :func:`map_fun`
    in ``InputMode.TENSORFLOW``, wait for them (re-raising any worker
    error) and return ``(stats, weights)``: each worker's stats dict in
    executor order and the final model state dict (weights and BatchNorm
    buffers, on the CPU) from the latest checkpoint of ``model_dir``
    (default: ``<working_dir>/model``)."""
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint

    working_dir = working_dir or tempfile.mkdtemp(prefix="resnet_train_")
    args = {**args, "model_dir": args.get("model_dir") or os.path.join(working_dir, "model")}
    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=timeout, worker_env=worker_env,
                             working_dir=working_dir)
    cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"resnet_train_stats.{i}.json")) as f:
            stats.append(json.load(f))
    return stats, restore_checkpoint(args["model_dir"])["model"]


def train_in_process(args: dict, num_workers: int = 1, device=None,
                     restored: dict | None = None):
    """The cluster's run replayed in this process: one replica trained on
    every worker's batches side by side (worker 0's first), which is what
    DDP with global-batch BatchNorm computes.  With ``restored`` (a
    checkpoint's state, as :func:`map_fun` restores it) the run resumes
    from that state and input position, as a relaunched cluster would.
    Returns ``(losses, weights)``: the mean loss a step and the final state
    dict on the CPU."""
    import torch

    from tensorflowonspark_tpu_torch.data import device_prefetch
    from tensorflowonspark_tpu_torch.util import resolve_device

    args = _args(args)
    device = resolve_device(device if device is not None else args.get("device"))
    state, step = strategy_state(args, device)
    consumed = 0
    if restored is not None:
        state.load_state_dict(restored)
        consumed = int(restored["data"]["elements_consumed"])
    num_classes = state.module.fc.out_features
    streams = [batches(args, i, num_workers, num_classes).checkpointable(
        {"elements_consumed": consumed}) for i in range(num_workers)]
    losses = []
    for parts in zip(*streams):
        batch = tuple(torch.cat([p[c] for p in parts]) for c in range(2))
        batch = next(device_prefetch(iter([batch]), device=device))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, {k: v.detach().cpu() for k, v in state.module.state_dict().items()}
