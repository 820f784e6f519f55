"""MNIST, estimator-style — ``train_and_evaluate`` under the cluster.

Port of ``examples/mnist/mnist_estimator.py`` (reference:
``examples/mnist/estimator/``): a ``tf.estimator.Estimator`` driven by
``tf.estimator.train_and_evaluate(TrainSpec, EvalSpec)`` — model_dir-
centric, periodically evaluating, resumable from the latest checkpoint.
Here the same contract runs over PyTorch
(:mod:`tensorflowonspark_tpu_torch.estimator`): the model is the
(module, loss_fn, optimizer_fn) triple, the workers form one process
group (gloo on the CPU, NCCL on the card) and train one model with DDP,
each on its own synthetic shard, and ``torch.distributed.checkpoint``
provides checkpoint/resume behind the shared ``model_dir``.

Run:

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_estimator \\
        --cpu --cluster_size 2 --max_steps 40 --model_dir /tmp/mnist_est
"""

import argparse


def main_fun(args, ctx):
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.estimator import (Estimator, EvalSpec,
                                                       TrainSpec, train_and_evaluate)
    from tensorflowonspark_tpu_torch.mnist_train import build_model
    from tensorflowonspark_tpu_torch.parallel.strategy import DataParallelStrategy, adam
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)

    # synthetic shard per worker (same scheme as the JAX package's example)
    rng = np.random.default_rng(1234 + ctx.executor_id)
    n = args.num_samples // ctx.num_workers
    images = rng.random((n, 28, 28, 1), np.float32).reshape(n, 1, 28, 28)
    labels = rng.integers(0, 10, size=n)
    n_eval = max(args.batch_size, n // 10)

    epoch = [0]  # fresh shuffle per invocation, not a replay of the same order

    def train_input_fn():
        epoch[0] += 1
        order = np.random.default_rng(
            (ctx.executor_id, epoch[0])).permutation(n - n_eval)
        for i in range(0, len(order) - args.batch_size + 1, args.batch_size):
            idx = order[i:i + args.batch_size]
            yield {"x": images[idx], "y": labels[idx]}

    def eval_input_fn():
        for i in range(n - n_eval, n - args.batch_size + 1, args.batch_size):
            yield {"x": images[i:i + args.batch_size],
                   "y": labels[i:i + args.batch_size]}

    def loss_fn(model, batch):
        return F.cross_entropy(model(batch["x"]), batch["y"])

    def metrics_fn(model, batch):
        logits = model(batch["x"])
        return {"loss": F.cross_entropy(logits, batch["y"]),
                "accuracy": (logits.argmax(-1) == batch["y"]).float().mean()}

    try:
        with Estimator(build_model({"seed": 0}), loss_fn, adam(args.lr), args.model_dir,
                       strategy=DataParallelStrategy(device),
                       eval_metrics_fn=metrics_fn,
                       save_every_steps=args.save_every) as est:
            final = train_and_evaluate(
                est,
                TrainSpec(input_fn=train_input_fn, max_steps=args.max_steps),
                EvalSpec(input_fn=eval_input_fn, steps=2,
                         throttle_steps=args.throttle_steps))
            print(f"node {ctx.executor_id}: final eval "
                  f"step={final['global_step']} "
                  f"loss={final['loss']:.4f} acc={final['accuracy']:.3f}",
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import InputMode, TPUCluster

    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=40)
    p.add_argument("--throttle_steps", type=int, default=20)
    p.add_argument("--save_every", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_samples", type=int, default=1024)
    p.add_argument("--model_dir", default="/tmp/mnist_estimator")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else None
    cluster = TPUCluster.run(main_fun, args, args.cluster_size,
                             input_mode=InputMode.TENSORFLOW,
                             worker_env=worker_env, reservation_timeout=60)
    cluster.shutdown(timeout=600)
    print("mnist_estimator: done")
