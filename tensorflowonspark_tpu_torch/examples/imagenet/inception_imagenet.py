"""ImageNet Inception-v3 training — the original TensorFlowOnSpark demo job.

Port of ``examples/imagenet/inception_imagenet.py`` (reference:
``examples/imagenet/inception``, Inception trained under the gRPC
parameter-server strategy).  As the JAX example, the job is synchronous
data parallelism (:class:`~tensorflowonspark_tpu_torch.parallel.MultiWorkerMirroredStrategy`,
DDP over the cluster's process group) with the reference's recipe: the
auxiliary classifier at loss weight 0.3 when ``--image_size >= 128``,
RMSProp (decay 0.9, eps 1.0, momentum 0.9) under an exponential decay of
0.94 over ``--steps`` (optax's, :func:`~tensorflowonspark_tpu_torch.parallel.rmsprop`
and :func:`~tensorflowonspark_tpu_torch.parallel.exponential_decay`), and
a :class:`~tensorflowonspark_tpu_torch.checkpoint.CheckpointManager` that
every worker restores from (a replica that did not would diverge).  On
the card the convolutions run bf16 and ``channels_last`` (float32
BatchNorm and logits); on the CPU the model runs float32, as the JAX
example does off the TPU.

Run (the CI-sized synthetic pass):

    python -m tensorflowonspark_tpu_torch.examples.imagenet.inception_imagenet \\
        --cpu --cluster_size 1 --steps 4 --batch_size 4 --image_size 75 \\
        --model_dir /tmp/incep

Besides the reference's flags: ``--seed`` (weights and dropout) and
``--cpu``.  Each worker writes ``<working_dir>/inception_stats.<id>.json``
(every step's loss and time, images, peak device memory).
"""

import argparse
import json
import os
import time


def _shard(args, ctx):
    """Synthetic ImageNet-shaped shard (NHWC float32 in [0, 1) and labels);
    ``--data_dir``'s TFRecords (``image`` float32 HWC, ``label``) instead
    when given."""
    import numpy as np

    s = args.image_size
    if args.data_dir:
        from tensorflowonspark_tpu_torch.data import Dataset

        rows = list(Dataset.from_examples(os.path.join(args.data_dir, "part-*"),
                                          shard=(ctx.num_workers, ctx.executor_id)))
        x = np.stack([np.asarray(r["image"], np.float32).reshape(s, s, 3) for r in rows])
        y = np.asarray([int(r["label"]) for r in rows])
        return x, y
    rng = np.random.default_rng(7 + ctx.executor_id)
    n = args.num_samples // ctx.num_workers
    return (rng.random((n, s, s, 3), np.float32),
            rng.integers(0, args.num_classes, size=n))


def build(args, device):
    """``(model, strategy, state, step)`` for ``args`` on ``device``: the
    model with the weights of ``--seed``, RMSProp under the decay."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import inception
    from tensorflowonspark_tpu_torch.parallel import (MultiWorkerMirroredStrategy,
                                                      exponential_decay, rmsprop)

    use_aux = args.image_size >= 128    # the aux head needs a 17x17-stage grid
    cuda = device.type == "cuda"
    model = inception.InceptionV3(num_classes=args.num_classes, aux_logits=use_aux,
                                  dtype=torch.bfloat16 if cuda else torch.float32,
                                  image_size=args.image_size)
    model.load_state_dict(inception.init_params(model, args.seed))
    if cuda:
        model = model.to(memory_format=torch.channels_last)
    sched = exponential_decay(args.lr, max(args.steps, 1), 0.94)
    strategy = MultiWorkerMirroredStrategy(device, seed=args.seed)
    state = strategy.init_state(model, rmsprop(sched, decay=0.9, eps=1.0, momentum=0.9))

    def loss_fn(model, batch, rng=None):
        x, y = batch
        out = model(x, train=True, rng=rng)
        logits, aux = out if use_aux else (out, None)
        loss = F.cross_entropy(logits, y)
        if aux is not None:
            loss = loss + 0.3 * F.cross_entropy(aux, y)
        return loss, {"acc": (logits.argmax(-1) == y).float().mean()}
    loss_fn.has_aux = True
    return strategy, state, strategy.build_train_step(loss_fn)


def main_fun(args, ctx):
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if args.cpu else getattr(args, "device", None))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        images, labels = _shard(args, ctx)
        strategy, state, step = build(args, device)
        # restore on EVERY worker (a replica that did not would diverge)
        ckpt = CheckpointManager(args.model_dir, async_save=False) if args.model_dir else None
        restored = ckpt.restore() if ckpt is not None else None
        if restored is not None:
            state.load_state_dict(restored)
            print(f"node {ctx.executor_id}: resumed from step {state.step}", flush=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rng = np.random.default_rng(ctx.executor_id)
        stats = {"losses": [], "step_ms": [], "images": 0, "first_step": state.step}
        for s in range(state.step, args.steps):
            idx = rng.integers(0, len(images), size=args.batch_size)
            t0 = time.perf_counter()
            x = torch.from_numpy(images[idx]).permute(0, 3, 1, 2)   # NCHW, NHWC memory
            state, metrics = step(state, strategy.shard_batch((x, labels[idx])))
            stats["losses"].append(float(metrics["loss"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["images"] += args.batch_size
            if (s + 1) % 10 == 0 or s + 1 == args.steps:
                print(f"node {ctx.executor_id}: step {s + 1} loss {stats['losses'][-1]:.4f} "
                      f"acc {float(metrics['acc']):.3f}", flush=True)
        if ckpt is not None:
            if ckpt.latest_step() != args.steps:
                ckpt.save(args.steps, state.state_dict(), force=True)
            ckpt.close()
        stats["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None)
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir,
                               f"inception_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import InputMode, TPUCluster

    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.045)
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--num_samples", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_dir", default="")
    p.add_argument("--model_dir", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else None
    cluster = TPUCluster.run(main_fun, args, args.cluster_size,
                             input_mode=InputMode.TENSORFLOW,
                             worker_env=worker_env, reservation_timeout=60)
    cluster.shutdown(timeout=1800)
    print("inception_imagenet: done")
