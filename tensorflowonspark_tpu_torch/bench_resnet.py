"""ResNet-50 training throughput of the port on one card.

    python -m tensorflowonspark_tpu_torch.bench_resnet [--bn bf16|f32] [--profile]

The port's counterpart of ``bench.py::bench_resnet`` (the repo's headline
metric, "ResNet-50 images/sec/chip"), at its accelerator configuration:
batch 128, 224 px, bf16 convolutions, bf16 BatchNorm (``--bn f32`` for
flax's default), SGD momentum 0.9 at lr 0.1, random weights and one random
batch from ``--seed``, 3 warm-up and 20 timed steps.  It measures:

- **framework img/s**: ``DataParallelStrategy``'s step over
  ``Dataset.cache_on_device`` (the batch replayed from device memory: the
  compute-bound number), host clock around the timed steps, synchronised
  at the end by reading the last loss;
- **streamed img/s**: the same step fed through ``Dataset.prefetch`` and
  ``device_prefetch`` (pinned host memory, a side stream), timed over the
  same 20 steps once 3 warm-up steps have filled the pipeline, and **h2d
  MB/s**: one batch copied from pinned memory (CUDA events, median of 5);
- **raw img/s**: the same model, loss and optimizer in a bare loop, and
  ``framework_vs_raw``;
- **mfu**: FLOPs counted from the model's own convolution and dense
  shapes, 2 a multiply-add, x3 for forward and backward (the convention of
  XLA's ``cost_analysis``), / step time / the H100 SXM's dense bf16 peak,
  989 TFLOP/s;
- with ``--profile``: device ms a step by kernel family and the device's
  idle share (``torch.profiler`` over 5 framework steps).

Prints one JSON line on stdout (logs go to stderr), with the card's name
and power limit from ``nvidia-smi``.  Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM data sheet
BATCH, IMAGE, STEPS, WARMUP = 128, 224, 20, 3     # bench.py's accelerator config
PROFILE_STEPS = 5


def log(*a) -> None:
    print("bench_resnet:", *a, file=sys.stderr, flush=True)


def forward_flops_per_image(model, image_size: int, device) -> float:
    """Forward FLOPs of one image, 2 a multiply-add, of every convolution
    (read from its output shape by a hook on one eval forward of a
    one-image batch) and of the classifier."""
    import torch

    from tensorflowonspark_tpu_torch.models.resnet import Conv

    macs = [0]

    def count(mod, inputs, out):
        macs[0] += out.numel() * mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, image_size, image_size, device=device), train=False)
    finally:
        for h in hooks:
            h.remove()
    return 2.0 * (macs[0] + model.fc.in_features * model.fc.out_features)


def bench(bn: str = "bf16", seed: int = 0, profile: bool = False) -> dict:
    """Run the measurements above on the card; returns the JSON line's
    dict."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.data import Dataset, device_prefetch
    from tensorflowonspark_tpu_torch.device_info import card_name_and_limit
    from tensorflowonspark_tpu_torch.models.resnet import ResNet50, init_params
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, sgd
    from tensorflowonspark_tpu_torch.resnet_train import cross_entropy
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    batch, image, steps, warmup = BATCH, IMAGE, STEPS, WARMUP
    device = resolve_device("cuda")
    strict_matmul_precision()
    torch.backends.cudnn.benchmark = True      # fixed shapes: autotune once, in warm-up
    card = card_name_and_limit()
    torch.cuda.reset_peak_memory_stats(device)     # the bench's own peak
    bn_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[bn]
    log(f"card {card}; batch {batch}, {image} px, bf16 convs, bn {bn}")

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, norm_dtype=bn_dtype)
    model.load_state_dict(init_params(model, seed))
    model = model.to(memory_format=torch.channels_last)
    strategy = DataParallelStrategy(device, seed=seed)
    state = strategy.init_state(model, sgd(0.1))
    step = strategy.build_train_step(cross_entropy)

    rng = np.random.default_rng(seed)
    x_np = rng.standard_normal((batch, image, image, 3), np.float32)
    # NCHW view of NHWC memory (channels_last), bf16: the model's first cast
    x = torch.from_numpy(x_np).permute(0, 3, 1, 2).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, batch).astype(np.int64))

    def run_framework(it, n: int, warm: int = 0) -> float:
        """Seconds for ``n`` framework steps over the batches of ``it``,
        after ``warm`` untimed ones."""
        for _ in range(warm):
            step(state, next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            _, last = step(state, next(it))
        float(last["loss"])                    # drains the queue
        return time.perf_counter() - t0

    cached = Dataset.from_generator(lambda: iter([(x, y)])).cache_on_device(device)
    t0 = time.perf_counter()
    run_framework(iter(cached.repeat(warmup)), warmup)
    warmup_s = time.perf_counter() - t0
    dt = run_framework(iter(cached.repeat(steps)), steps)
    images_per_sec = batch * steps / dt
    log(f"framework (device-cached input): {steps} steps in {dt:.3f} s -> "
        f"{images_per_sec:.1f} img/s (warm-up {warmup_s:.1f} s)")

    # streamed: the prefetch thread and the device copies are started and
    # filled by the warm-up steps, so the timed steps see a running pipeline
    ds = Dataset.from_generator(lambda: ((x, y) for _ in range(warmup + steps))).prefetch(2)
    stream_dt = run_framework(device_prefetch(iter(ds), depth=2, device=device), steps, warmup)
    streamed_images_per_sec = batch * steps / stream_dt

    pinned = (x.pin_memory(), y.pin_memory())
    nbytes = sum(t.numel() * t.element_size() for t in pinned)
    copy_ms = []
    for _ in range(6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for t in pinned:
            t.to(device, non_blocking=True)
        end.record()
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
    h2d_mbps = nbytes / (statistics.median(copy_ms[1:]) * 1e-3) / 1e6
    log(f"streamed {streamed_images_per_sec:.1f} img/s; h2d {h2d_mbps:.1f} MB/s "
        f"({nbytes} bytes a batch)")

    # the raw loop: the same model, loss and optimizer, no strategy or Dataset
    model, opt = state.module, state.optimizer
    xd, yd = x.to(device), y.to(device)

    def raw_step():
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(xd, train=True), yd)
        loss.backward()
        opt.step()
        return loss

    for _ in range(warmup):
        raw_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = raw_step()
    float(loss.detach())
    raw_dt = time.perf_counter() - t0
    raw_images_per_sec = batch * steps / raw_dt
    log(f"raw loop {raw_images_per_sec:.1f} img/s (framework/raw "
        f"{images_per_sec / raw_images_per_sec:.4f})")

    fwd_flops = forward_flops_per_image(model, image, device)
    step_flops = 3 * fwd_flops * batch
    step_s = dt / steps
    mfu = step_flops / step_s / H100_BF16_FLOPS
    log(f"{fwd_flops / 1e9:.4f} GFLOP forward an image, {step_flops / 1e12:.4f} TFLOP a "
        f"step, {step_s * 1e3:.3f} ms a step, MFU {mfu:.4f}")

    out = {
        "metric": (f"resnet50_train_images_per_sec_per_card[gpu b{batch} {image}px bf16 "
                   f"bn{bn} device-cached-input]"),
        "value": images_per_sec, "unit": "images/sec", "platform": "gpu",
        "kind": torch.cuda.get_device_name(0), "card": card,
        "images_per_sec_total": images_per_sec,
        "streamed_images_per_sec": streamed_images_per_sec, "h2d_MBps": h2d_mbps,
        "raw_images_per_sec": raw_images_per_sec,
        "framework_vs_raw": images_per_sec / raw_images_per_sec,
        "mfu": mfu, "mfu_peak_flops": H100_BF16_FLOPS, "step_ms": step_s * 1e3,
        "step_tflop": step_flops / 1e12, "forward_gflop_per_image": fwd_flops / 1e9,
        "batch": batch, "image": image, "bn": bn, "steps": steps, "warmup": warmup,
        "warmup_s": warmup_s, "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
    }
    if profile:
        out.update(profile_steps(lambda: step(state, next(iter(cached)))[1], step_s))
    return out


def profile_steps(run, step_s: float) -> dict:
    """Trace :data:`PROFILE_STEPS` calls of ``run`` (one framework step,
    returning its metrics) with ``torch.profiler``: device ms a step by
    kernel family, the device's busy ms, and its idle share of the traced
    wall and of ``step_s`` (the unprofiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch.devtime import device_ms, family

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            metrics = run()
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family, by_kernel = device_ms(prof)
    busy = sum(by_family.values())
    n = PROFILE_STEPS
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"  {fam:40s} {ms / n:9.3f} ms a step  {ms / busy:6.3f} of device time")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]:
        log(f"    {ms / n:9.3f} ms a step  [{family(name)}] {name[:100]}")
    return {"profile_steps": n, "device_busy_ms_per_step": busy / n,
            "traced_wall_ms_per_step": wall_ms / n, "idle_share": 1 - busy / wall_ms,
            "idle_share_unprofiled": 1 - busy / n / (step_s * 1e3),
            "device_ms_per_step_by_family": {f: ms / n for f, ms in by_family.items()}}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bn", choices=("bf16", "f32"), default="bf16",
                   help="BatchNorm dtype (bench.py's accelerator config: bf16)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also trace 5 steps: device ms by kernel family, idle share")
    a = p.parse_args()
    print(json.dumps(bench(bn=a.bn, seed=a.seed, profile=a.profile)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
