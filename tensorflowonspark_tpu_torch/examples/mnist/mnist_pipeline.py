"""MNIST through the ML-pipeline API: TFEstimator.fit → TFModel.transform.

Port of ``examples/mnist/mnist_pipeline.py`` (reference:
``examples/mnist/keras/mnist_pipeline.py``) — the same CNN driven by the
Spark-ML-style Estimator/Model wrappers: ``fit(df)`` feeds the DataFrame
through a training cluster (DDP across the workers, Adam 1e-3) and the
chief exports a serving signature; ``transform(df)`` batch-scores a
DataFrame against the export on the driver via the per-process model
cache, mapping columns with input/output mappings.

Run:

    python -m tensorflowonspark_tpu_torch.examples.mnist.mnist_pipeline \\
        --cpu --cluster_size 2 --export_dir /tmp/mnist_pipe_export

Without ``--cpu`` the workers and the transform run on the card.
"""

import argparse


def train_fn(args, ctx):
    """Estimator training fn — identical contract to TPUCluster map_funs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.checkpoint import export_model
    from tensorflowonspark_tpu_torch.mnist_train import build_model, pad_batch, weighted_loss
    from tensorflowonspark_tpu_torch.parallel.strategy import (MultiWorkerMirroredStrategy,
                                                               adam)
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        strategy = MultiWorkerMirroredStrategy(device)
        state = strategy.init_state(build_model({"seed": 0}), adam(1e-3))
        step = strategy.build_train_step(weighted_loss)
        feed = ctx.get_data_feed(train_mode=True)
        while not feed.should_stop():
            batch = feed.next_batch_arrays(args.batch_size, timeout=60)
            if batch is None:
                break
            state, _ = step(state, strategy.shard_batch(pad_batch(batch, args.batch_size)))

        if ctx.is_chief:
            model = state.module

            def serve(params, image):
                x = image.reshape(-1, 1, 28, 28)
                logits = torch.func.functional_call(model, params, (x,))
                return torch.softmax(logits, dim=-1)

            export_model(args.export_dir, serve, model.state_dict(),
                         [np.zeros((1, 784), np.float32)],
                         input_names=["image"], output_names=["prob"],
                         is_chief=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    import numpy as np

    from tensorflowonspark_tpu_torch import pipeline as pl
    from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--export_dir", default="/tmp/mnist_pipeline_export")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    rng = np.random.default_rng(0)
    rows = [Row(image=rng.random(784).astype(np.float32).tolist(),
                label=int(rng.integers(0, 10)))
            for _ in range(args.num_samples)]
    df = DataFrame(rows, num_partitions=args.cluster_size * 2)

    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else None
    estimator = (pl.TFEstimator(train_fn, args, worker_env=worker_env,
                                device="cpu" if args.cpu else None)
                 .setClusterSize(args.cluster_size)
                 .setBatchSize(args.batch_size)
                 .setEpochs(args.epochs)
                 .setExportDir(args.export_dir)
                 .setInputMapping({"image": "image"})
                 .setOutputMapping({"prob": "prediction"}))
    model = estimator.fit(df)

    sample = DataFrame([Row(image=np.asarray(r.image, np.float32), label=r.label)
                        for r in df.collect()[:8]])
    preds = model.transform(sample)   # columns per output_mapping only
    for src, row in zip(sample.collect(), preds.collect()):
        probs = np.asarray(row.prediction)
        print(f"label={src.label} pred={int(probs.argmax())} "
              f"p={float(probs.max()):.3f}")
    print("mnist_pipeline: done")
