"""The online tier under load, on one card: latency and throughput through
``ServingCluster``, steady and with a replica killed; and a standby's
warm-up sweep, eager against captured.

    python -m tensorflowonspark_tpu_torch.bench_serving [--seed 0] [--requests 48] [--rate 8]
        [--replicas 2] [--slots 4] [--kill-step 16]

The port's counterpart of ``scripts/bench_serving.py``'s ``bench_scenario``
and ``aot_warmup_scenario``, on a GPT-124M-class model (vocab 32000, hidden
768, 12 layers, 12 heads, RoPE, 1024 positions) in float32 with TF32 off,
weights drawn from ``--seed``.  Requests arrive on a Poisson process at
``--rate`` a second whatever completes (open loop), each on its own
thread and ``ServeClient`` connection; prompts of 16-128 tokens and
budgets of 16-64.  Every replica shares the one card.  Scenarios:

- ``steady`` and ``steady_eager``: the load through the replicas with
  their serve steps captured as CUDA graphs (``aot_cache``), and eager;
- ``replica_kill`` (captured): ``TFOS_CHAOS`` SIGKILLs replica 1 at its
  decode step ``--kill-step``; no accepted request may fail, and every
  stream must equal a solo ``greedy_generate`` (the replayed ones too);
- ``warmup``: a standby's bucket x group sweep (``standby._warm_batcher``)
  on a fresh batcher in this process, eager, then captured (every site's
  first call: its eager run and capture, each timed alone), then the same
  sweep again (every site replays, each call timed alone); and the graphs'
  pool in bytes.

Per tier scenario: TTFT (submit to first streamed delta) and end-to-end
latency percentiles from the clients' clocks, tokens/s over the load's
wall, the scheduler's request counts.  Each tier is warmed first by one
concurrent request a replica (its first calls, and captures, outside the
measured window).  Prints one JSON line on stdout (logs on stderr) with
the card's name and power limit.  Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

WIDTH = {"vocab_size": 32000, "hidden_size": 768, "num_layers": 12, "num_heads": 12,
         "intermediate_size": 3072, "max_position_embeddings": 1024}


def log(*a) -> None:
    print("bench_serving:", *a, file=sys.stderr, flush=True)


def model_config(args: dict):
    import torch

    from tensorflowonspark_tpu_torch.models import GPTConfig

    return GPTConfig(**args.get("width", WIDTH), dtype=torch.float32, pos_encoding="rope")


def model_builder(args: dict):
    """Replica-side model (top level: pickled by reference into workers)."""
    from tensorflowonspark_tpu_torch.models.gpt import init_params

    cfg = model_config(args)
    return cfg, init_params(cfg, int(args.get("seed", 0)))


def _percentiles(samples) -> dict:
    from tensorflowonspark_tpu_torch.observability import LatencyHistogram

    h = LatencyHistogram()
    for s in samples:
        h.record(s)
    return h.summary()


def _run_load(serving, reqs, rate: float, rng, timeout: float) -> list:
    """Open-loop Poisson arrivals; per-request records."""
    from tensorflowonspark_tpu_torch.serving import ServingError

    records = [None] * len(reqs)

    def one(i, prompt, budget):
        t0 = time.monotonic()
        rec = {"ok": False, "ttft": None, "e2e": None, "tokens": 0}
        try:
            with serving.client() as c:
                toks = []
                for delta in c.generate_stream(prompt, budget, timeout=timeout):
                    if rec["ttft"] is None:
                        rec["ttft"] = time.monotonic() - t0
                    toks.extend(delta)
                rec.update(e2e=time.monotonic() - t0, tokens=len(toks), ok=True, out=toks)
        except ServingError as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        records[i] = rec

    threads = []
    for i, (p, n) in enumerate(reqs):
        t = threading.Thread(target=one, args=(i, p, n), daemon=True)
        t.start()
        threads.append(t)
        time.sleep(rng.exponential(1.0 / rate))   # Poisson inter-arrivals
    for t in threads:
        t.join(timeout)
    return records


def requests(n: int, vocab: int, seed: int, prompt=(16, 129), budget=(16, 65)) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (int(rng.integers(*prompt)),)).tolist(),
             int(rng.integers(*budget))) for _ in range(n)]


def tier_scenario(scenario: str, args: dict, reqs, rate: float, replicas: int, slots: int,
                  kill_step: int, graphs: bool, device=None, worker_env=None,
                  oracle=None, timeout: float = 600.0) -> dict:
    """One tier run under the open-loop load (module docstring)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.serving import ServingCluster

    env = dict(worker_env or {})
    if scenario == "replica_kill":
        env["TFOS_CHAOS"] = f"kill node=1 at_step={kill_step}"
    t_boot = time.monotonic()
    serving = ServingCluster.run(model_builder, replicas, max_batch=slots, replica_args=args,
                                 aot_cache=True if graphs else None, device=device,
                                 worker_env=env or None, reservation_timeout=timeout,
                                 client_timeout=timeout)
    try:
        def warm():
            with serving.client() as c:
                c.generate(reqs[0][0], 2, timeout=timeout)

        warmers = [threading.Thread(target=warm) for _ in range(replicas)]
        for t in warmers:
            t.start()
        for t in warmers:
            t.join(timeout)
        boot = time.monotonic() - t_boot
        base = serving.metrics()
        t0 = time.monotonic()
        records = _run_load(serving, reqs, rate, np.random.default_rng(args["seed"] + 1),
                            timeout)
        wall = time.monotonic() - t0
        m = serving.metrics()
    finally:
        serving.shutdown(timeout=timeout)
    lost = [i for i, r in enumerate(records) if r is None or (not r["ok"] and "error" not in r)]
    failed = [r for r in records if r and not r["ok"]]
    if lost:
        raise RuntimeError(f"{scenario}: requests lost without a typed error: {lost}")
    if scenario == "replica_kill" and failed:
        raise RuntimeError(f"{scenario}: accepted requests failed after the kill: {failed[:3]}")
    exact = None
    if oracle is not None:
        exact = all(r["out"] == w for r, w in zip(records, oracle) if r and r["ok"])
        if not exact:
            raise RuntimeError(f"{scenario}: a stream differs from solo greedy")
    ok = [r for r in records if r and r["ok"]]
    tokens = sum(r["tokens"] for r in ok)
    row = {"scenario": scenario, "graphs": graphs,
           "requests": {"offered": len(reqs), "completed": len(ok),
                        **{k: m[k] - base[k] for k in ("accepted", "shed", "failed",
                                                       "requeued")}},
           "tokens_total": tokens, "wall_secs": wall, "boot_and_warm_secs": boot,
           "throughput_tokens_per_s": tokens / wall, "throughput_requests_per_s": len(ok) / wall,
           "ttft": _percentiles([r["ttft"] for r in ok if r["ttft"] is not None]),
           "e2e": _percentiles([r["e2e"] for r in ok]), "oracle_exact": exact,
           "served": {str(e): r["served"] for e, r in m["replicas"].items()}}
    log(f"{scenario}: {tokens / wall:.1f} tok/s, {len(ok)}/{len(reqs)} completed in "
        f"{wall:.2f} s; TTFT p50 {row['ttft']['p50_secs']}, p95 {row['ttft']['p95_secs']}; "
        f"end to end p50 {row['e2e']['p50_secs']}, p95 {row['e2e']['p95_secs']}; requeued "
        f"{row['requests']['requeued']}; boot and warm-up {boot:.1f} s")
    return row


def warmup_scenario(args: dict, slots: int, device, capture=None) -> dict:
    """The standby's warm-up sweep (module docstring).  The graphs' pool
    is read from the allocator's segments that belong to a graph pool
    (``torch.cuda.memory_snapshot``, after ``empty_cache``); the card's
    reserved bytes with each batcher alive are kept beside it, and the
    captured batcher's own copy of the weights (an eager batcher reads the
    caller's) as ``weights_copy_bytes``."""
    import torch

    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, _storage
    from tensorflowonspark_tpu_torch.serving import aot
    from tensorflowonspark_tpu_torch.serving.standby import _warm_batcher

    cfg, params = model_builder(args)
    params = {n: t.to(device) for n, t in params.items()}
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def reserved() -> int:
        if not cuda:
            return 0
        sync()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device)

    def graph_pool() -> int:
        """Bytes of the allocator's segments in a graph's private pool."""
        if not cuda:
            return 0
        sync()
        torch.cuda.empty_cache()
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id") or (0, 0)) != (0, 0))

    def sweep(b) -> float:
        sync()
        t0 = time.perf_counter()
        _warm_batcher(b)
        sync()
        return time.perf_counter() - t0

    b = ContinuousBatcher(cfg, params, max_batch=slots)
    eager_s = sweep(b)
    reserved_eager = reserved()
    del b
    first, replays = {}, {}

    def timed(record):
        def call(site, *a):
            sync()
            t0 = time.perf_counter()
            try:
                return orig(site, *a)
            finally:
                sync()
                record.setdefault(repr(site.site), []).append(time.perf_counter() - t0)
        return call

    cache = aot.AOTExecutableCache(None, capture=capture)
    b = ContinuousBatcher(cfg, params, max_batch=slots, aot_cache=cache)
    orig = aot._GraphSite._first_call
    aot._GraphSite._first_call = timed(first)
    try:
        captured_s = sweep(b)
    finally:
        aot._GraphSite._first_call = orig
    orig = aot._GraphSite.__call__
    aot._GraphSite.__call__ = timed(replays)
    try:
        replay_s = sweep(b)
    finally:
        aot._GraphSite.__call__ = orig
    reserved_captured = reserved()
    pool_bytes = graph_pool()
    copy_bytes = sum(t.numel() * t.element_size() for t in _storage(b.params))
    out = {"scenario": "warmup", "slots": slots, "eager_secs": eager_s,
           "captured_first_secs": captured_s, "captured_replay_secs": replay_s,
           "first_call_secs_by_site": {k: v[0] for k, v in first.items()},
           "replay_call_secs_by_site": {k: sum(v) / len(v) for k, v in replays.items()},
           "aot_stats": cache.stats(), "reserved_bytes_eager": reserved_eager,
           "reserved_bytes_captured": reserved_captured,
           "weights_copy_bytes": copy_bytes, "graph_pool_bytes": pool_bytes}
    log(f"warm-up sweep: eager {eager_s:.3f} s, captured {captured_s:.3f} s (its "
        f"{cache.compiles} first calls and captures), replayed {replay_s:.3f} s; graph pool "
        f"{pool_bytes} bytes, the batcher's copy of the weights {copy_bytes} bytes (reserved "
        f"{reserved_captured} against {reserved_eager} with the eager batcher); aot "
        f"{cache.stats()}")
    return out


def bench(seed: int = 0, n_requests: int = 48, rate: float = 8.0, replicas: int = 2,
          slots: int = 4, kill_step: int = 16, device=None, width: dict | None = None,
          worker_env: dict | None = None, capture=None) -> dict:
    """Run every scenario; returns the JSON line's dict.  ``device="cpu"``,
    ``width`` and ``capture`` (the capture cache's test seam) rehearse it
    at a tiny size on the CPU, where the tiers run eagerly."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    dev = resolve_device(device)
    strict_matmul_precision()
    args = {"seed": seed, **({"width": width} if width else {})}
    card = dev.type
    if dev.type == "cuda":
        from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

        card = card_name_and_limit()
    cfg, params = model_builder(args)
    reqs = requests(n_requests, cfg.vocab_size, seed)
    log(f"card {card}; {n_requests} requests at {rate}/s, {replicas} replicas x {slots} slots")
    params = {n: t.to(dev) for n, t in params.items()}
    t0 = time.perf_counter()
    oracle = [greedy_generate(cfg, params, np.asarray([p]), n)[0, len(p):].tolist()
              for p, n in reqs]
    log(f"solo greedy oracles in {time.perf_counter() - t0:.1f} s")
    del params
    graphs = dev.type == "cuda"
    kw = dict(args=args, reqs=reqs, rate=rate, replicas=replicas, slots=slots,
              kill_step=kill_step, device=None if device is None else str(device),
              worker_env=worker_env, oracle=oracle)
    rows = [tier_scenario("steady", graphs=graphs, **kw),
            tier_scenario("steady_eager", graphs=False, **kw),
            tier_scenario("replica_kill", graphs=graphs, **kw),
            warmup_scenario(args, slots, dev, capture)]
    return {"benchmark": "serving", "card": card,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "config": {"model": f"gpt {cfg.num_layers}x{cfg.hidden_size} vocab {cfg.vocab_size} "
                                f"float32", "requests": n_requests, "rate": rate,
                       "replicas": replicas, "slots": slots, "kill_step": kill_step,
                       "seed": seed},
            "rows": rows}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--rate", type=float, default=8.0)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--kill-step", type=int, default=16)
    a = p.parse_args()
    print(json.dumps(bench(seed=a.seed, n_requests=a.requests, rate=a.rate,
                           replicas=a.replicas, slots=a.slots, kill_step=a.kill_step)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
