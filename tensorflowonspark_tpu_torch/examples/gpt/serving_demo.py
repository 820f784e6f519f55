"""Continuous-batching serving demo.

Port of ``examples/gpt/serving_demo.py``.  Trains nothing — serving is
about SCHEDULING, not weights.  A tiny GPT with random weights from
``--seed`` serves a burst of mixed-length greedy requests through
``models.ContinuousBatcher`` (requests admit into and retire from batch
slots mid-flight over one decode step), and every response must equal a
solo ``greedy_generate`` run on its prompt — the greedy-exact contract.

Prints each request's finishing step, then the sequential-call comparison
with arrival-order static batching (the hardware-independent scheduling
win).  ``--speculative K`` drafts K tokens a slot by prompt lookup on
repetitive prompts and verifies them in one call; ``--block-steps K`` runs
up to K decode steps a call.

Run:

    python -m tensorflowonspark_tpu_torch.examples.gpt.serving_demo --cpu [--requests 12]

Without ``--cpu`` it runs on the card (and fails without one).
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speculative", type=int, default=None, metavar="K",
                   help="draft K tokens per slot via prompt lookup and verify them in one "
                        "call (per-row acceptance); repetitive prompts accept well")
    p.add_argument("--block-steps", type=int, default=None, metavar="K",
                   help="run up to K decode steps a call when no admission can be delayed "
                        "(identical tokens, K-x fewer host round trips; excludes "
                        "--speculative)")
    args = p.parse_args(argv)
    if args.requests < 1 or args.slots < 1:
        p.error("--requests and --slots must be >= 1")
    if args.speculative is not None and args.speculative < 1:
        p.error("--speculative must be >= 1")
    if args.block_steps is not None and args.block_steps < 2:
        p.error("--block-steps must be >= 2")
    if args.block_steps is not None and args.speculative is not None:
        p.error("--block-steps and --speculative are mutually exclusive")

    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models import (ContinuousBatcher, GPTConfig,
                                                    greedy_generate)
    from tensorflowonspark_tpu_torch.models.gpt import init_params
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if args.cpu else None)
    strict_matmul_precision()
    cfg = GPTConfig(vocab_size=97, hidden_size=48, num_layers=2, num_heads=4,
                    intermediate_size=96, max_position_embeddings=64, dtype=torch.float32,
                    pos_encoding="rope")
    params = {n: t.to(device) for n, t in init_params(cfg, args.seed).items()}

    rng = np.random.default_rng(args.seed)
    if args.speculative is not None:
        # repetitive prompts: the regime prompt-lookup drafting wins in
        reqs = [(np.tile(rng.integers(0, cfg.vocab_size, (3,)).astype(np.int32), 4),
                 int(rng.integers(4, 25))) for _ in range(args.requests)]
    else:
        reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 10)),)).astype(np.int32),
                 int(rng.integers(4, 25))) for _ in range(args.requests)]

    b = ContinuousBatcher(cfg, params, max_batch=args.slots, speculative_k=args.speculative,
                          decode_block_steps=args.block_steps)
    rids = [b.submit(prompt, budget) for prompt, budget in reqs]
    remaining = set(rids)
    steps = 0
    while remaining:
        finished = b.step()
        steps += 1
        for rid in finished:
            print(f"serving_demo: request {rid} finished at step {steps}", flush=True)
        remaining.difference_update(finished)
    results = b.run()

    for rid, (prompt, budget) in zip(rids, reqs):
        want = greedy_generate(cfg, params, prompt[None, :], budget)[0, len(prompt):]
        assert (results[rid] == want.cpu().numpy()).all(), f"request {rid} diverged"
    print(f"serving_demo: {len(rids)} requests greedy-exact on {device.type}", flush=True)

    # symmetric accounting: sequential device calls on the critical path.
    # Static = per group (1 prefill + max_budget - 1 decode steps) = the sum
    # of group max budgets; continuous = its decode-loop steps plus its
    # MEASURED prefill calls (same-bucket admissions share one).
    cont = steps + b.prefill_dispatches
    static = sum(max(bgt for _, bgt in reqs[i:i + args.slots])
                 for i in range(0, len(reqs), args.slots))
    print(f"serving_demo: sequential dispatches {cont} continuous (incl. "
          f"{b.prefill_dispatches} batched prefills for {len(reqs)} requests) vs {static} "
          f"static ({static / cont:.2f}x)", flush=True)
    if args.speculative is not None:
        total = sum(len(v) for v in results.values())
        print(f"serving_demo: speculative k={args.speculative}: {b.spec_accepted}/"
              f"{b.spec_proposed} drafts accepted, {total} tokens in {b.decode_dispatches} "
              f"decode dispatches ({total / max(b.decode_dispatches, 1):.2f} tok/dispatch)",
              flush=True)
    if args.block_steps is not None:
        print(f"serving_demo: block-steps k={args.block_steps}: {b.decode_steps} decode steps "
              f"in {b.decode_dispatches} dispatches "
              f"({b.decode_steps / max(b.decode_dispatches, 1):.2f} steps/dispatch)",
              flush=True)
    print("serving_demo: done", flush=True)


if __name__ == "__main__":
    main()
