#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``tensorflowonspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run loudly (nothing falls back to the CPU):

1. device: the card's name and, from ``nvidia-smi``, its power limit;
2. build: every kernel of the main path compiled by ``nvcc`` from the
   checkout's sources into ``build/torch_kernels/``;
3. kernels: each kernel held against its plain PyTorch version on the
   card, at the main path's shapes and at edge cases, then timed beside
   its bound, its plain version and the one PyTorch call that computes the
   same function (a yardstick only; the port never calls it);
4. main path: ``TPUCluster.run`` + ``cluster.inference`` serving 64
   SQuAD-shaped rows through full-width BERT-base QA (bf16, random weights
   from ``--seed``) in one worker process; the worker's kernel launches
   must be 12 per batch, and its logits must agree with the same weights
   run in this process with the plain attention in place of the kernel.

The line before the last is the card's name and power limit; the line
before that is the ``{"kernels": [...]}`` summary; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA card or outside a checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
BERT_LAYERS = 12
KERNEL_REPS = 30
ROWS, BATCH_SIZE = 64, 16           # the main path's requests

FLASH_SOURCE = "tensorflowonspark_tpu_torch/ops/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = "tensorflowonspark_tpu/ops/flash_attention.py:107"  # _fwd_kernel


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = KERNEL_REPS, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: the median over ``reps`` samples, each a
    CUDA-event span around ``inner`` back-to-back calls divided by
    ``inner`` (so the host's per-call overhead hides behind the queue)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# ----------------------------------------------------------------- kernels

def flash_cases(seed: int):
    """(name, B, Tq, Tk, H, D, dtype, key lengths or None, causal, window,
    atol).  The first is the main path's shape: BERT-base at T=384 in
    batches of 16, with ragged key padding and one fully masked row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    bert_lens = [int(x) for x in rng.integers(192, 385, 16)]
    bert_lens[5] = 0                                   # a fully masked row
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("bert_bf16", 16, 384, 384, 12, 64, bf16, bert_lens, False, None, 2e-2),
        ("bert_f32", 16, 384, 384, 12, 64, f32, bert_lens, False, None, 2e-5),
        ("causal_window_d128", 2, 512, 512, 8, 128, bf16, None, True, 128, 2e-2),
        ("tq_ne_tk", 4, 100, 300, 12, 64, bf16, [300, 250, 17, 299], False, None, 2e-2),
        ("ragged_37", 4, 37, 37, 12, 64, f32, [37, 30, 1, 36], True, None, 2e-5),
    ]


def make_inputs(B, Tq, Tk, H, D, dtype, lens, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
               for T in (Tq, Tk, Tk))
    mask = None
    if lens is not None:
        mask = (torch.arange(Tk, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda")[:, None])
    return q, k, v, mask


def check_flash(seed: int) -> dict:
    """Hold the flash forward against its plain version in every case; time
    it at the main path's shape.  Returns the kernel's summary entry."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)

    summary = None
    for i, (name, B, Tq, Tk, H, D, dtype, lens, causal, window, atol) in \
            enumerate(flash_cases(seed)):
        q, k, v, mask = make_inputs(B, Tq, Tk, H, D, dtype, lens, seed + i)
        out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
        torch.cuda.synchronize()
        want, want_lse = flash_attention_reference(q, k, v, mask=mask, causal=causal,
                                                   window=window)
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        ok = (torch.isfinite(out).all().item()
              and torch.allclose(out.float(), want.float(), atol=atol, rtol=1e-5)
              and torch.allclose(lse, want_lse, atol=atol, rtol=1e-5))
        if lens is not None and 0 in lens:
            row = lens.index(0)
            ok = ok and bool((out[row] == 0).all()) and bool((lse[row] == 1e30).all())
        log(f"flash {name}: B={B} Tq={Tq} Tk={Tk} H={H} D={D} {str(dtype)[6:]} "
            f"causal={causal} window={window}: max|out-plain|={err:.3g} "
            f"max|lse-plain|={lse_err:.3g} atol={atol} -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(f"flash kernel disagrees with its plain version in {name}")
        if i > 0:
            continue
        # main path's shape: time the kernel, its plain version and SDPA
        kernel_ms = time_ms(lambda: flash_attention_fwd(q, k, v, mask=mask))
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask=mask))
        # SDPA returns NaN on a fully masked row: give that row its keys back
        sdpa_mask = mask.clone()
        sdpa_mask[lens.index(0)] = True
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask[:, None, None, :]))
        elt = q.element_size()
        bytes_moved = (3 * B * Tk * H * D * elt + B * Tq * H * D * elt   # q k v in, out
                       + B * H * Tq * 4 + B * Tk)                        # lse out, mask in
        flops = 4 * B * H * Tq * Tk * D            # no causal trim on this path
        bytes_ms = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
        ops_ms = flops / H100_BF16_FLOPS * 1e3
        summary = {
            "name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES, "launches": None, "max_abs_err": err,
            "tolerance": atol, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "shape": f"B={B} T={Tq} H={H} D={D} bf16",
            "bytes": bytes_moved, "flops": flops,
            "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
    return summary


# --------------------------------------------------------------- main path

def run_main_path(seed: int, card: str, rows_n: int, batch_size: int) -> int:
    """Serve ``rows_n`` rows through the port's cluster; check the worker
    went through the kernel and agrees with the plain-attention run.
    Returns the worker's kernel launches."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch.ops import flash_attention

    seq_len = 384
    rows = bi.make_rows(rows_n, seq_len, bi.BERT_BASE["vocab_size"], seed)
    n_batches = math.ceil(rows_n / batch_size)
    torch.cuda.empty_cache()

    flash_attention.launches = 0          # counts start at 0 for the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
        t0 = time.perf_counter()
        results, stats = bi.run_inference(rows, bi.BERT_BASE, seed=seed,
                                          batch_size=batch_size, num_workers=1,
                                          device="cuda", working_dir=wd, timeout=600)
        wall = time.perf_counter() - t0
    launches = sum(s["launches"] for s in stats)
    log(f"main path: {len(results)} rows served in {wall:.2f} s wall "
        f"(cluster boot, weights, {n_batches} batches, shutdown); worker kernel "
        f"launches={launches} (expected {BERT_LAYERS} x {n_batches} = "
        f"{BERT_LAYERS * n_batches}); driver launches={flash_attention.launches}")
    if len(results) != rows_n:
        raise SystemExit(f"main path returned {len(results)} of {rows_n} rows")
    if launches != BERT_LAYERS * n_batches:
        raise SystemExit("the main path did not go through the flash kernel once "
                         "per layer and batch")

    st = stats[0]
    steady = st["batch_ms"][1:] or st["batch_ms"]
    med = statistics.median(steady)
    shares = [a / b for a, b in zip(st["attention_ms"], st["batch_ms"])][1:]
    log(f"main path on {card}: median batch {med:.2f} ms over batches 2..{n_batches} "
        f"(first, with warm-up: {st['batch_ms'][0]:.2f} ms) = {batch_size / med * 1e3:.1f} "
        f"rows/s steady; end to end {rows_n / wall:.1f} rows/s; attention share of "
        f"a batch {statistics.median(shares or [0.0]):.3f} (CUDA events around "
        f"each call, host gaps included; per batch attention ms "
        f"{[round(x, 3) for x in st['attention_ms']]})")

    # the same weights and rows in this process, plain attention, on the card
    model = bi.build_model({"config": bi.BERT_BASE, "seed": seed}, torch.device("cuda"),
                           attention="reference")
    want_s, want_e = [], []
    with torch.inference_mode():
        for i in range(0, rows_n, batch_size):
            batch = [np.stack([r[c] for r in rows[i:i + batch_size]]) for c in range(3)]
            s, e = bi.forward_batch(model, batch, batch_size, "cuda")
            want_s.append(s)
            want_e.append(e)
    want_s, want_e = np.concatenate(want_s), np.concatenate(want_e)
    got_s = np.stack([r[0] for r in results])
    got_e = np.stack([r[1] for r in results])
    if got_s.shape != (rows_n, seq_len) or not (np.isfinite(got_s).all()
                                                 and np.isfinite(got_e).all()):
        raise SystemExit(f"bad logits: shape {got_s.shape}, finite "
                         f"{np.isfinite(got_s).all()} {np.isfinite(got_e).all()}")
    if flash_attention.launches != 0:
        raise SystemExit("the plain-attention run launched the kernel")
    err = max(np.abs(got_s - want_s).max(), np.abs(got_e - want_e).max())
    real = np.stack([r[1] for r in rows]).astype(bool)         # attention masks
    span = lambda lg: np.where(real, lg, -np.inf).argmax(axis=1)  # noqa: E731
    agree = float(np.mean((span(got_s) == span(want_s)) & (span(got_e) == span(want_e))))
    logit_atol, span_share = 0.1, 0.9
    log(f"main path vs plain attention (same weights, bf16): max|logit diff|={err:.4g} "
        f"(atol {logit_atol}; logit std {want_s.std():.3g}); identical argmax spans "
        f"{agree:.3f} (need >= {span_share})")
    if not (err <= logit_atol and agree >= span_share):
        raise SystemExit("the served logits disagree with the plain-attention run")
    return launches


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0, help="weights and data seed")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from tensorflowonspark_tpu_torch.ops.flash_attention import build_kernel
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    from tensorflowonspark_tpu_torch.util import strict_matmul_precision

    strict_matmul_precision()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = gpu_name_and_limit()
    log(f"device: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    so = build_kernel()
    log(f"build: {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())

    # 3. kernels against their plain versions, and their times
    flash = check_flash(args.seed)
    log(f"flash_attention_fwd at {flash['shape']} on {card}: kernel "
        f"{flash['ms']:.4f} ms, plain {flash['plain_ms']:.4f} ms, SDPA "
        f"{flash['library_ms']:.4f} ms, bound {flash['bound_ms']:.4f} ms "
        f"({flash['bound_by']}), {flash['achieved_tflops']:.2f} TFLOP/s")

    # 4. the main path
    flash["launches"] = run_main_path(args.seed, card, ROWS, BATCH_SIZE)
    flash["launches_per_forward"] = BERT_LAYERS

    print(json.dumps({"kernels": [flash]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
