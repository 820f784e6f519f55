"""Image segmentation with U-Net.

Port of ``examples/segmentation/unet_segmentation.py`` (reference:
``examples/segmentation``, a U-Net trained on (image, mask) TFRecords).
Each worker reads its shard of ``--data_dir``'s TFRecords (``image``
float32 HWC and ``mask`` int32 HW bytes, read back with ``dfutil``) or
synthesises the JAX example's bright discs on noise, and trains the
per-pixel cross-entropy with Adam under the data-parallel strategy,
reporting the foreground IoU.  On the card the convolutions run bf16 and
``channels_last`` (float32 GroupNorm and logits).

Run:

    python -m tensorflowonspark_tpu_torch.examples.segmentation.unet_segmentation \\
        --cpu --steps 5 --image_size 64 --batch_size 8

Besides the reference's flags: ``--features`` (the levels' widths, the
reference example's ``16,32,64`` by default; the model's own default is
``64,128,256,512``), ``--seed`` and ``--cpu``.  Each worker writes
``<working_dir>/unet_stats.<id>.json`` (every step's loss, IoU and time,
images, peak device memory).
"""

import argparse
import json
import os
import time


def _shard(args, ctx):
    import numpy as np

    S = args.image_size
    if args.data_dir:
        from tensorflowonspark_tpu_torch import dfutil

        rows = dfutil.loadTFRecords(args.data_dir, binary_features=("image", "mask"))
        rows = rows.collect()[ctx.executor_id::ctx.num_workers]
        x = np.stack([np.frombuffer(r.image, np.float32).reshape(S, S, 3) for r in rows])
        y = np.stack([np.frombuffer(r.mask, np.int32).reshape(S, S) for r in rows])
        return x, y
    # synthetic: random images with a bright disc; mask = the disc
    rng = np.random.default_rng(7 + ctx.executor_id)
    n = args.num_samples // ctx.num_workers
    yy, xx = np.mgrid[0:S, 0:S]
    images, masks = [], []
    for _ in range(n):
        cx, cy, r = rng.integers(8, S - 8), rng.integers(8, S - 8), rng.integers(4, 8)
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < r ** 2
        img = rng.random((S, S, 3), np.float32) * 0.3
        img[disc] += 0.7
        images.append(img)
        masks.append(disc.astype(np.int32))
    return np.stack(images), np.stack(masks)


def iou(pred, y):
    """Foreground intersection over union of 0/1 label maps."""
    inter = ((pred == 1) & (y == 1)).sum()
    union = ((pred == 1) | (y == 1)).sum()
    return inter / union.clamp(min=1)


def main_fun(args, ctx):
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.models import unet
    from tensorflowonspark_tpu_torch.parallel import MultiWorkerMirroredStrategy, adam
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if args.cpu else getattr(args, "device", None))
    strict_matmul_precision()
    cuda = device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        images, masks = _shard(args, ctx)
        features = tuple(int(f) for f in args.features.split(","))
        model = unet.UNet(num_classes=2, features=features,
                          dtype=torch.bfloat16 if cuda else torch.float32)
        model.load_state_dict(unet.init_params(model, args.seed))
        if cuda:
            model = model.to(memory_format=torch.channels_last)
            torch.backends.cudnn.benchmark = True
            torch.cuda.reset_peak_memory_stats(device)
        strategy = MultiWorkerMirroredStrategy(device, seed=args.seed)
        state = strategy.init_state(model, adam(args.lr))

        def loss_fn(model, batch):
            x, y = batch
            logits = model(x)                                   # [B, 2, S, S]
            return F.cross_entropy(logits, y), {"iou": iou(logits.argmax(1), y)}
        loss_fn.has_aux = True

        step = strategy.build_train_step(loss_fn)
        rng = np.random.default_rng(ctx.executor_id)
        stats = {"losses": [], "iou": [], "step_ms": [], "images": 0}
        for s in range(args.steps):
            idx = rng.integers(0, len(images), size=args.batch_size)
            t0 = time.perf_counter()
            x = torch.from_numpy(images[idx]).permute(0, 3, 1, 2)   # NCHW, NHWC memory
            y = torch.from_numpy(masks[idx]).long()
            state, metrics = step(state, strategy.shard_batch((x, y)))
            stats["losses"].append(float(metrics["loss"]))
            stats["iou"].append(float(metrics["iou"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["images"] += args.batch_size
            if (s + 1) % 5 == 0:
                print(f"node {ctx.executor_id}: step {s + 1} loss {stats['losses'][-1]:.4f} "
                      f"IoU {stats['iou'][-1]:.3f}", flush=True)
        if args.model_dir:
            from tensorflowonspark_tpu_torch.checkpoint import save_checkpoint

            save_checkpoint(args.model_dir, state.state_dict(), step=args.steps)
            if ctx.is_chief:
                print(f"chief: saved {args.model_dir}", flush=True)
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir, f"unet_stats.{ctx.executor_id}.json"),
                  "w") as f:
            json.dump(stats, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import InputMode, TPUCluster

    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_samples", type=int, default=256)
    p.add_argument("--features", default="16,32,64")
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
    print("unet_segmentation: done")
