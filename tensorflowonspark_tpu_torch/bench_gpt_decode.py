"""Autoregressive decode throughput of the port's GPT on one card.

    python -m tensorflowonspark_tpu_torch.bench_gpt_decode [--seed 0]

The port's counterpart of ``bench.py::bench_gpt_decode``, at its config:
vocab 32000, hidden 768, 12 layers, 12 heads, FFN 3072, 1024 positions,
bf16 compute on float32 parameters drawn from ``--seed``; batch 8, a
128-token prompt, 128 new tokens.  Each variant decodes once to warm up,
then 3 times on the host clock, each ending with the ids copied to the
host (which waits for the card):

- ``tokens_per_sec`` / ``ms_per_token_batch``: ``greedy_generate``;
- ``int8_tokens_per_sec`` / ``int8_vs_bf16``: the same on
  ``quantize_params`` weights (int8, dequantized at every matmul);
- ``int8_kv_tokens_per_sec`` / ``int8_kv_vs_bf16``: int8 weights and the
  int8 KV cache;
- ``lookup_tokens_per_sec`` / ``lookup_vs_greedy_repetitive``:
  ``lookup_generate`` (draft 8) against greedy on a repetitive prompt
  (0..15 tiled), where prompt lookup is meant to pay.

Every variant runs: a failure fails the bench.  Prints one JSON line on
stdout (logs go to stderr), with the card's name and power limit from
``nvidia-smi``.  Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

B, T0, NEW = 8, 128, 128             # bench.py's decode config
ITERS = 3


def log(*a) -> None:
    print("bench_gpt_decode:", *a, file=sys.stderr, flush=True)


def decode_config(**overrides):
    """``bench.py::bench_gpt_decode``'s GPT-124M-class config, bf16."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import GPTConfig

    kw = dict(vocab_size=32000, hidden_size=768, num_layers=12, num_heads=12,
              intermediate_size=3072, max_position_embeddings=1024, dtype=torch.bfloat16)
    return GPTConfig(**{**kw, **overrides})


def bench(seed: int = 0, cfg=None, device="cuda", batch: int = B, prompt_len: int = T0,
          new_tokens: int = NEW, iters: int = ITERS) -> dict:
    """Run the measurements above; returns the JSON line's dict.  ``cfg``,
    ``device`` and the sizes exist to rehearse the bench at a tiny size on
    the CPU; the defaults are the measurement."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import (greedy_generate, init_params,
                                                        lookup_generate)
    from tensorflowonspark_tpu_torch.ops import quantize_params
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(device)
    strict_matmul_precision()
    cfg = cfg or decode_config()
    card = device.type
    if device.type == "cuda":
        from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

        card = card_name_and_limit()
    log(f"card {card}; batch {batch}, prompt {prompt_len}, {new_tokens} new tokens")
    params = {n: t.to(device) for n, t in init_params(cfg, seed).items()}
    rng = np.random.default_rng(seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)

    def timed(fn, *args) -> float:
        """Seconds a decode, over ``iters`` after one warm-up; the ids are
        read back to the host, so the card has finished."""
        fn(*args).cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        out.cpu()
        return (time.perf_counter() - t0) / iters

    n = batch * new_tokens
    dt = timed(greedy_generate, cfg, params, prompt, new_tokens)
    result = {"batch": batch, "prompt": prompt_len, "new_tokens": new_tokens,
              "tokens_per_sec": n / dt, "ms_per_token_batch": dt / new_tokens * 1e3,
              "model": f"gpt {cfg.num_layers}x{cfg.hidden_size} vocab {cfg.vocab_size} "
                       f"{str(cfg.dtype).removeprefix('torch.')}",
              "device": torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu", "card": card}
    log(f"greedy {n / dt:.0f} tok/s")

    qparams = quantize_params(params)
    dt_q = timed(greedy_generate, cfg, qparams, prompt, new_tokens)
    result.update(int8_tokens_per_sec=n / dt_q, int8_vs_bf16=dt / dt_q)
    log(f"int8 weights {n / dt_q:.0f} tok/s ({dt / dt_q:.3f}x bf16)")

    dt_kv = timed(greedy_generate, dataclasses.replace(cfg, kv_cache_int8=True), qparams,
                  prompt, new_tokens)
    result.update(int8_kv_tokens_per_sec=n / dt_kv, int8_kv_vs_bf16=dt / dt_kv)
    log(f"int8 weights + int8 KV {n / dt_kv:.0f} tok/s")

    rep = torch.arange(16, device=device).repeat(batch, prompt_len // 16 + 1)[:, :prompt_len]
    dt_g = timed(greedy_generate, cfg, params, rep, new_tokens)

    def lookup(*args):
        return lookup_generate(*args, draft_len=8)

    dt_l = timed(lookup, cfg, params, rep, new_tokens)
    _, stats = lookup_generate(cfg, params, rep, new_tokens, draft_len=8, return_stats=True)
    result.update(lookup_tokens_per_sec=n / dt_l, lookup_vs_greedy_repetitive=dt_g / dt_l,
                  lookup_forwards=stats["forwards"])
    log(f"lookup {n / dt_l:.0f} tok/s ({dt_g / dt_l:.3f}x greedy on repetitive text, "
        f"{stats['forwards']} forwards for {new_tokens} tokens)")
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    print(json.dumps(bench(seed=a.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
