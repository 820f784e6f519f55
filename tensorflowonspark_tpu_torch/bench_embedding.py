"""Criteo-scale embedding steps on one card: dense against sparse.

    python -m tensorflowonspark_tpu_torch.bench_embedding [--vocab 1000000]
        [--features 64] [--batch 8192] [--steps 20] [--seed 0]

The port's counterpart of ``scripts/bench_embedding.py``, at its defaults
(vocab 1M x 64 float32, batch 8192, 20 steps), plus a row at the largest
Criteo Kaggle table (10,131,227 x 16).  On one card the table is whole (an
embedding group of one); the group's memory split is what
``tests/test_torch_embedding.py`` checks on two gloo processes.  For each
row:

- ``table_MB`` and the optimizer state's MB (``dense_state_MB``: SGD's
  momentum, the JAX script's ``optax.sgd(0.05, momentum=0.9)``;
  ``sparse_state_MB``: adagrad's accumulator);
- the dense step (``ShardedEmbedding`` + SGD with momentum over the whole
  table: a ``[V, F]`` gradient and a rewrite of the table and momentum)
  and the sparse step (``build_sparse_embedding_train_step``, adagrad on
  the touched rows only), each with ``step_ms``, ``steps_per_s``,
  ``lookups_per_s`` (the batch's lookups and their updates, per second)
  and ``peak_MB`` (``max_memory_allocated`` over a step, after a reset,
  less what the process held before the row);
- the batch-invariance row: each step again at batch / 8;
  ``batch_invariance`` = the small batch's step time over the full one's.
  Near 1 the step is bound by the vocab (table sweeps), near 1/8 by the
  batch.

The loss is the JAX script's ``mean((emb - tgt) ** 2)``.  Times are the host
clock over ``steps`` steps ending in ``torch.cuda.synchronize()``, after one
warm-up step.  Prints one JSON line with the card's name and power limit.
Runs on the card unless ``device="cpu"`` is passed (the tests' rehearsal).

``--profile`` instead traces BASELINE config 4's dense Wide&Deep step (the
``chip_smoke.py`` phase 15 model: 26 features of 1,298,561 rows, embed 16,
batch 8192, optax adagrad) with ``torch.profiler``
(``devtime.profile_calls``): device ms a step by kernel family, the top
kernels and the idle share; one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the largest of the 26 Criteo Kaggle vocabularies (the DLRM Kaggle loader's)
CRITEO_LARGEST = (10_131_227, 16)


def log(*a) -> None:
    print("bench_embedding:", *a, file=sys.stderr, flush=True)


def _mse(emb, tgt):
    return ((emb - tgt) ** 2).mean()


def _time(step, steps: int, device) -> float:
    """Seconds a step: one warm-up, then ``steps`` steps to a sync."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync()
    return (time.perf_counter() - t0) / steps


def _peak_mb(fn, device, base: int) -> float | None:
    """Peak device MB of a call of ``fn`` above ``base`` bytes (what was
    allocated before the row began)."""
    import torch

    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 1e6


def run_row(vocab: int, features: int, batch: int, steps: int, seed: int, device) -> dict:
    """One row of the bench (module docstring) for a ``[vocab, features]``
    table on ``device``."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.parallel import (ShardedEmbedding,
                                                      build_sparse_embedding_train_step, sgd)

    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, batch)).to(device)
    tgt = torch.from_numpy(rng.standard_normal((batch, features), dtype=np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    table_mb = vocab * features * 4 / 1e6
    row = {"vocab": vocab, "features": features, "batch": batch, "steps": steps,
           "table_MB": table_mb, "dense_state_MB": table_mb, "sparse_state_MB": table_mb}

    def measure(name, step):
        dt = _time(lambda: step(batch), steps, device)
        dt_small = _time(lambda: step(batch // 8), steps, device)
        row[name] = {"step_ms": dt * 1e3, "steps_per_s": 1 / dt, "lookups_per_s": batch / dt,
                     "peak_MB": _peak_mb(lambda: step(batch), device, base),
                     f"step_ms_batch_{batch // 8}": dt_small * 1e3,
                     "batch_invariance": dt_small / dt}
        log(f"{vocab} x {features} {name}: {dt * 1e3:.3f} ms a step, "
            f"{batch / dt:,.0f} lookups/s, batch/8 {dt_small / dt:.3f}x")

    emb = ShardedEmbedding(vocab, features, generator=gen, device=device)
    opt = sgd(0.05, 0.9)(emb.parameters())

    def dense(n):
        opt.zero_grad(set_to_none=True)
        _mse(emb(ids[:n]), tgt[:n]).backward()
        opt.step()

    measure("dense", dense)
    table = emb.weight.detach().clone()     # the sparse step starts where the dense one ended
    del emb, opt, dense                     # so the sparse peak holds only its table and slot
    slot = torch.zeros_like(table)
    sparse = build_sparse_embedding_train_step(None, _mse, lr=0.05, optimizer="adagrad")
    measure("sparse", lambda n: sparse(table, slot, ids[:n], tgt[:n]))
    row["sparse_vs_dense_step"] = row["dense"]["step_ms"] / row["sparse"]["step_ms"]
    del table, slot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def bench(vocab: int = 1_000_000, features: int = 64, batch: int = 8192, steps: int = 20,
          seed: int = 0, device=None, criteo: bool = True) -> dict:
    """The JSON line's dict: the JAX script's row and, with ``criteo``,
    the largest Criteo Kaggle table's."""
    import torch

    from tensorflowonspark_tpu_torch.device_info import card_name_and_limit
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device(device)
    shapes = [(vocab, features)] + ([CRITEO_LARGEST] if criteo else [])
    rows = [run_row(v, f, batch, steps, seed, device) for v, f in shapes]
    return {"bench": "embedding", "device": (torch.cuda.get_device_name(device)
                                             if device.type == "cuda" else "cpu"),
            "card": card_name_and_limit() if device.type == "cuda" else None, "rows": rows}


def profile_wide_deep(seed: int = 0, calls: int = 5) -> dict:
    """The ``--profile`` trace (module docstring) on the card."""
    import torch

    from tensorflowonspark_tpu_torch import devtime
    from tensorflowonspark_tpu_torch.examples.wide_deep import wide_deep_criteo as wdc
    from tensorflowonspark_tpu_torch.models.wide_deep import sigmoid_binary_cross_entropy
    from tensorflowonspark_tpu_torch.parallel import adagrad
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(None)
    strict_matmul_precision()
    args = argparse.Namespace(vocab_size=1_298_561, embed_dim=16, batch_size=8192, steps=1,
                               lr=0.05, seed=seed)
    model = wdc.build_model(args, device)
    opt = adagrad(args.lr)(model.parameters())
    d, c, y = (torch.from_numpy(a).to(device) for a in next(wdc.batches(args, 17)))

    def step():
        opt.zero_grad(set_to_none=True)
        sigmoid_binary_cross_entropy(model(d, c), y).mean().backward()
        opt.step()

    return {"profile": "wide_deep_dense_step", "rows": args.vocab_size * wdc.NUM_CATEGORICAL,
            "batch": args.batch_size, **devtime.profile_calls(step, calls, "step")}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--vocab", type=int, default=1_000_000)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="trace the dense Wide&Deep step instead (module docstring)")
    a = p.parse_args()
    print(json.dumps(profile_wide_deep(a.seed) if a.profile
                     else bench(a.vocab, a.features, a.batch, a.steps, a.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
