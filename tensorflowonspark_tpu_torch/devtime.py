"""Device time of a call on the card, with the host's cost kept out of it.

    python -m tensorflowonspark_tpu_torch.devtime [--rounds 20] [--calls 100]

run as a script prints the host cost of each flash-attention wrapper call
at BERT's shape (see :func:`main`).

A CUDA-event span around ``inner`` back-to-back calls measures the device
only while the device is slower than the host's enqueue of the calls
(Python, ctypes, ``torch.empty``, the launch).  A kernel faster than that
leaves the device idle between launches, and the span times the host.  So
each span here starts behind a ``torch.cuda._sleep`` long enough to cover
the host's enqueue of the ``inner`` calls: by the time the sleep ends they
are all queued, and run back to back.

:func:`time_in_turns` samples several calls alternately within one loop
(a kernel and its library yardstick), so that both see the same clocks,
power and neighbours.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time


@functools.cache
def sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per millisecond on this card (measured
    once: events around a 10-million-cycle sleep)."""
    import torch

    n = 10_000_000
    torch.cuda._sleep(n)                           # warm the sleep kernel
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / start.elapsed_time(end)


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return (no sync inside
    the timed loop: the launch cost, not the device's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_in_turns(fns: dict, reps: int = 30, inner: int = 10,
                  warmup: int = 3) -> dict:
    """Median device ms of one call of each of ``fns`` (name -> callable):
    ``reps`` samples each, taken in turns (the order reversed every other
    round), each a CUDA-event span around ``inner`` back-to-back calls
    queued behind a sleep that covers their enqueue, divided by
    ``inner``."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    enqueue_ms = max(host_us(fn, inner) * inner / 1e3 for fn in fns.values())
    cycles = int((2.0 * enqueue_ms + 0.1) * sleep_cycles_per_ms())
    samples = {name: [] for name in fns}
    names = list(fns)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            fn = fns[name]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / inner)
    return {name: statistics.median(s) for name, s in samples.items()}


def time_ms(fn, reps: int = 30, inner: int = 10, warmup: int = 3) -> float:
    """Median device ms of one call of ``fn`` (:func:`time_in_turns` of
    one)."""
    return time_in_turns({"fn": fn}, reps, inner, warmup)["fn"]


def main() -> int:
    """Host microseconds a call of each flash-attention wrapper takes at
    BERT's shape (16 x 384, 12 heads of 64, bf16, a key-padding mask), the
    wrappers in turns: the median and the least of ``--rounds`` readings of
    :func:`host_us` over ``--calls`` calls.  Prints one JSON line."""
    p = argparse.ArgumentParser(description="host us a call of each flash-attention wrapper")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--calls", type=int, default=100)
    args = p.parse_args()

    import torch

    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    B, T, H, D = 16, 384, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(B, T, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    lens = torch.randint(T // 2, T + 1, (B, 1), device="cuda", generator=gen)
    mask = torch.arange(T, device="cuda")[None, :] < lens
    out, lse = flash_attention_fwd(q, k, v, mask=mask)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    fns = {"flash_attention_fwd": lambda: flash_attention_fwd(q, k, v, mask=mask),
           "flash_attention_dq": lambda: flash_attention_dq(q, k, v, mask, dout, lse, delta),
           "flash_attention_dkv": lambda: flash_attention_dkv(q, k, v, mask, dout, lse, delta)}
    samples = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            samples[name].append(host_us(fn, args.calls))
    print(json.dumps({"card": card, "rounds": args.rounds, "calls": args.calls,
                      "host_us_median": {n: statistics.median(s) for n, s in samples.items()},
                      "host_us_min": {n: min(s) for n, s in samples.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
