"""Cluster-hosted continuous-batching inference.

Port of ``examples/gpt/cluster_serving.py``: the DRIVER pushes decode
requests through the SPARK-mode data plane (``cluster.inference`` — push n
items, collect n results, partition order kept), and each WORKER hosts a
``ContinuousBatcher`` behind its ``DataFeed``, so requests stream through
its slots mid-flight instead of waiting for a fixed batch to assemble —
the reference's ``TFCluster.inference`` pattern with a serving engine
behind the feed.

Each request is ``prompt tokens + [budget]`` as one int list; each result
is the generated continuation, in arrival order.  Every result must equal
a solo ``greedy_generate`` run on the driver (the same weights, drawn from
``--seed``).

Run:

    python -m tensorflowonspark_tpu_torch.examples.gpt.cluster_serving --cpu [--requests 12]

Besides the reference's flags: ``--seed``, the widths (``--vocab``,
``--hidden``, ``--num_layers``, ``--num_heads``, ``--intermediate_size``,
default twice ``--hidden``, ``--max_position_embeddings``), ``--bf16`` and
the request sizes (``--max_prompt``, ``--max_new``).  Without ``--cpu`` the
workers and the oracle run on the card.  :func:`serve` is the cluster run
without the check; each worker writes its counters to
``<working_dir>/cluster_serving_stats.<id>.json``.
"""

import argparse
import json
import os
import time

#: the reference's tiny model
DEFAULTS = {"vocab": 83, "hidden": 32, "num_layers": 2, "num_heads": 4,
            "max_position_embeddings": 64, "intermediate_size": None}


def model_config(args: dict):
    """The served ``GPTConfig``: RoPE, the widths of ``args``, float32 (or
    bf16 compute with ``args["bf16"]``)."""
    import torch

    from tensorflowonspark_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=args["vocab"], hidden_size=args["hidden"],
                     num_layers=args["num_layers"], num_heads=args["num_heads"],
                     intermediate_size=args.get("intermediate_size") or 2 * args["hidden"],
                     max_position_embeddings=args["max_position_embeddings"],
                     dtype=torch.bfloat16 if args.get("bf16") else torch.float32,
                     pos_encoding="rope")


def build_params(args: dict, device):
    """Random weights from ``args["seed"]`` (numpy, the same on every
    process), on ``device``."""
    from tensorflowonspark_tpu_torch.models.gpt import init_params

    return {n: t.to(device) for n, t in init_params(model_config(args), args["seed"]).items()}


def map_fun(args: dict, ctx) -> None:
    """Worker: host a ContinuousBatcher behind the DataFeed queues."""
    from collections import deque

    import torch

    from tensorflowonspark_tpu_torch.models import ContinuousBatcher
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    batcher = ContinuousBatcher(model_config(args), build_params(args, device),
                                max_batch=args["slots"])
    feed = ctx.get_data_feed()
    order: deque = deque()     # request ids in arrival order
    inflight: set = set()
    finished: dict = {}        # request id -> tokens (pruned at emit)
    emitted = 0
    t_first = None
    while not feed.should_stop() or inflight:
        # admit as many arrivals as there are free slots, then step once;
        # results leave IN ARRIVAL ORDER (the inference contract).  Poll
        # near-non-blocking while slots decode — a blocking wait would stall
        # every in-flight request; block only when idle.
        while batcher.has_free_slot() and not feed.should_stop():
            try:
                batch = feed.next_batch(1, timeout=0.1 if inflight else 2)
            except TimeoutError:
                break          # nothing queued right now; keep decoding
            if not batch:
                break
            req = [int(x) for x in batch[0]]
            rid = batcher.submit(req[:-1], req[-1])
            t_first = t_first or time.perf_counter()
            inflight.add(rid)
            order.append(rid)
        if not inflight:
            continue
        done = batcher.step()
        inflight.difference_update(done)
        finished.update({rid: batcher.result(rid, pop=True) for rid in done})
        while order and order[0] in finished:
            feed.batch_results([finished.pop(order.popleft()).tolist()])
            emitted += 1
    stats = {"served": emitted, "prefill_dispatches": batcher.prefill_dispatches,
             "decode_dispatches": batcher.decode_dispatches,
             "decode_steps": batcher.decode_steps, "shm_conns": ctx.mgr.shm_conns,
             "serve_s": time.perf_counter() - t_first if t_first else 0.0,
             "device": str(device)}
    with open(os.path.join(ctx.working_dir,
                           f"cluster_serving_stats.{ctx.executor_id}.json"), "w") as f:
        json.dump(stats, f)
    print(f"cluster_serving: node {ctx.task_index} served {emitted} requests", flush=True)


def make_requests(n: int, vocab: int, seed: int, max_prompt: int = 8, max_new: int = 11):
    """``n`` requests ``(prompt list, budget)``: prompts of 3..max_prompt
    tokens, budgets 3..max_new, drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (int(rng.integers(3, max_prompt + 1)),)).tolist(),
             int(rng.integers(3, max_new + 1))) for _ in range(n)]


def serve(args: dict, reqs, num_workers: int, worker_env: dict | None = None,
          working_dir: str | None = None, timeout: float = 600.0):
    """Boot ``num_workers`` workers running :func:`map_fun`, push ``reqs``
    through ``cluster.inference`` and shut down (re-raising any worker
    error).  Returns ``(results, stats, seconds)``: one token list per
    request in order, each worker's stats, and the seconds of the
    ``inference`` call alone."""
    from tensorflowonspark_tpu_torch import TPUCluster

    cluster = TPUCluster.run(map_fun, args, num_workers, reservation_timeout=timeout,
                             worker_env=worker_env, working_dir=working_dir)
    try:
        t0 = time.perf_counter()
        results = cluster.inference([p + [n] for p, n in reqs], feed_timeout=timeout)
        seconds = time.perf_counter() - t0
    finally:
        cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"cluster_serving_stats.{i}.json")) as f:
            stats.append(json.load(f))
    return results, stats, seconds


def oracle(args: dict, reqs, device) -> list[list[int]]:
    """Each request's solo ``greedy_generate`` continuation, on ``device``."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models import greedy_generate

    cfg, params = model_config(args), build_params(args, device)
    return [greedy_generate(cfg, params, np.asarray([p]), n)[0, len(p):].tolist()
            for p, n in reqs]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    for name, value in DEFAULTS.items():
        p.add_argument(f"--{name}", type=int, default=value)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--max_prompt", type=int, default=8)
    p.add_argument("--max_new", type=int, default=11)
    a = p.parse_args(argv)

    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if a.cpu else None)
    strict_matmul_precision()
    args = {**{k: getattr(a, k) for k in DEFAULTS}, "slots": a.slots, "seed": a.seed,
            "bf16": a.bf16, "device": device.type}
    reqs = make_requests(a.requests, a.vocab, a.seed, a.max_prompt, a.max_new)
    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if a.cpu else None
    results, stats, seconds = serve(args, reqs, a.workers, worker_env=worker_env)
    assert len(results) == len(reqs), (len(results), len(reqs))
    # inference() keeps order: partitions are contiguous splits concatenated
    # back by partition index
    for idx, (got, want) in enumerate(zip(results, oracle(args, reqs, device))):
        assert list(got) == want, f"request {idx} diverged"
    tokens = sum(len(r) for r in results)
    print(f"cluster_serving: {len(results)} requests greedy-exact across {a.workers} workers "
          f"({len(results) / seconds:.1f} rows/s, {tokens / seconds:.1f} tokens/s; shm "
          f"connections {[s['shm_conns'] for s in stats]})", flush=True)
    print("cluster_serving: done", flush=True)


if __name__ == "__main__":
    main()
