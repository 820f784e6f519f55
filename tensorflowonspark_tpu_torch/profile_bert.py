"""Where a BERT-base QA batch spends its time on the card.

    python -m tensorflowonspark_tpu_torch.profile_bert [--seed 0] [--batches 5]

Runs the slice's worker forward (``bert_inference.forward_batch``, flash
attention, bf16, random weights from ``--seed``) on one batch of 16
SQuAD-shaped rows at T=384, warms up, then traces ``--batches`` batches
with ``torch.profiler``.  Prints device time by kernel family, the
device's busy share of the traced wall time, and one JSON line with the
same numbers.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

FAMILIES = (  # first match wins; names as CUPTI reports them
    ("flash_attention (CUDA, this repo)", ("flash_fwd",)),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90_xmma", "nvjet")),
    ("layer_norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
    ("casts and copies", ("copy", "memcpy", "cast")),
    ("embedding", ("embedding", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batches", type=int, default=5)
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cuda")
    strict_matmul_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = bi.build_model({"config": bi.BERT_BASE, "seed": args.seed}, device)
    rows = bi.make_rows(16, 384, bi.BERT_BASE["vocab_size"], args.seed)
    batch = [np.stack([r[c] for r in rows]) for c in range(3)]
    with torch.inference_mode():
        for _ in range(3):
            bi.forward_batch(model, batch, 16, device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.batches):
                bi.forward_batch(model, batch, 16, device)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    by_family: dict[str, float] = {}
    by_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:  # kernels only, not the ops
            continue                              # that launched them
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us:
            fam = family(evt.key)
            by_family[fam] = by_family.get(fam, 0.0) + dev_us / 1e3
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(by_family.values())
    per = args.batches
    print(f"profile_bert on {card}: {per} batches of 16 x 384, wall {wall_ms / per:.3f} ms "
          f"a batch, device busy {busy_ms / per:.3f} ms a batch "
          f"({busy_ms / wall_ms:.3f} of wall; idle share {1 - busy_ms / wall_ms:.3f})")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:36s} {ms / per:9.3f} ms a batch  {ms / busy_ms:6.3f} of device time")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms / per:9.3f} ms a batch  {name[:100]}")
    print(json.dumps({"card": card, "batches": per, "wall_ms_per_batch": wall_ms / per,
                      "device_busy_ms_per_batch": busy_ms / per,
                      "idle_share": 1 - busy_ms / wall_ms,
                      "device_ms_per_batch": {f: ms / per for f, ms in by_family.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
