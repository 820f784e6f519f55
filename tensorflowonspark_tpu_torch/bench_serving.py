"""The online tier under load, on one card: latency and throughput through
``ServingCluster``, steady and with a replica killed; and a standby's
warm-up sweep, eager against captured.

    python -m tensorflowonspark_tpu_torch.bench_serving [--seed 0] [--requests 48] [--rate 8]
        [--replicas 2] [--slots 4] [--kill-step 16]
    python -m tensorflowonspark_tpu_torch.bench_serving --disagg [--rate 8]
    python -m tensorflowonspark_tpu_torch.bench_serving --failover

The port's counterpart of ``scripts/bench_serving.py``'s ``bench_scenario``,
``aot_warmup_scenario``, ``disagg_scenario`` (``--disagg``) and
``failover_scenario`` (``--failover``), on a GPT-124M-class model (vocab 32000, hidden
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

``--disagg``: short prompts (12 tokens, budget 16) with long ones (320
tokens, budget 8) interleaved one in six, open loop at ``--rate``, through
two replicas unified and through one prefill and one decode replica (the
prefill pool admitting in chunks of 64), the same paged engine (pages of
16 tokens) captured in both: TTFT and end-to-end p50/p95 of each kind, and
the gates (every stream equal to solo greedy, none lost, no prefill on the
decode replica, a handoff a request).  ``--failover``: five clients stream
back to back with ``failover_wait`` through two replicas; ``TFOS_CHAOS=
"kill driver after_secs=20"`` crashes the driver (the replicas serve from
~11 s after the tier returns: their models load and capture first), ``resume_driver`` replays
its journal onto the live replicas and rebinds the port: heal seconds (the
crash to the resumed tier, and to the first token a client reads after
it), and the
gates (streams completed before the crash, so it landed in a serving tier;
no client error, every stream equal to solo greedy, the journal owing
nothing, one resume).

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


def _node_counter(nodes: dict, eids, name: str, **labels) -> float:
    from tensorflowonspark_tpu_torch.examples.gpt.online_serving import counter

    return sum(counter(nodes.get(e, {}), name, **labels) for e in eids)


def disagg_scenario(arm: str, args: dict, reqs, kinds, oracle, rate: float, slots: int,
                    page_tokens: int, prefill_chunk: int, graphs: bool, device=None,
                    worker_env=None, timeout: float = 600.0) -> dict:
    """One arm of ``--disagg`` (module docstring): ``"unified"`` (two
    replicas) or ``"disagg"`` (a prefill and a decode replica)."""
    import numpy as np

    from tensorflowonspark_tpu_torch.serving import ServingCluster

    extra = {}
    if arm == "disagg":
        extra["disagg"] = {"prefill": 1, "decode": 1,
                           "prefill_kwargs": {"prefill_chunk": prefill_chunk}}
    serving = ServingCluster.run(
        model_builder, 2, max_batch=slots, replica_args=args,
        batcher_kwargs={"kv_page_tokens": page_tokens}, max_queue_depth=4 * len(reqs),
        aot_cache=True if graphs else None, device=device, worker_env=worker_env,
        reservation_timeout=timeout, client_timeout=timeout, **extra)
    rng = np.random.default_rng(args["seed"] + 7)
    try:
        def wave(prompts):
            def one(p):
                with serving.client() as c:
                    c.generate(p, 2, timeout=timeout)

            ts = [threading.Thread(target=one, args=(p,)) for p in prompts]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout)

        short, long = (len(reqs[kinds.index(k)][0]) for k in ("short", "long"))
        vocab = model_config(args).vocab_size
        fresh = lambda n: rng.integers(0, vocab, n).tolist()  # noqa: E731 — unseen prompts
        # every site's first call (and capture) outside the window: shorts
        # alone and grouped, a long alone and among shorts
        wave([fresh(short)])
        for _ in range(2):
            wave([fresh(short) for _ in range(slots)])
        wave([fresh(long)])
        wave([fresh(long)] + [fresh(short) for _ in range(slots - 1)])
        time.sleep(2.5)             # the heartbeats carry the counters
        m0 = serving.metrics()
        t0 = time.monotonic()
        records = _run_load(serving, reqs, rate, np.random.default_rng(args["seed"] + 1),
                            timeout)
        wall = time.monotonic() - t0
        time.sleep(2.5)
        m1 = serving.metrics()
    finally:
        serving.shutdown(timeout=timeout)
    ok = [r for r in records if r and r["ok"]]
    if len(ok) != len(reqs):
        raise RuntimeError(f"{arm}: {len(reqs) - len(ok)} request(s) lost or failed")
    if any(r["out"] != w for r, w in zip(records, oracle)):
        raise RuntimeError(f"{arm}: a stream differs from solo greedy")
    roles = {e: r.get("role") for e, r in m1["replicas"].items()}
    delta = {k: m1[k] - m0[k] for k in ("accepted", "completed", "failed", "requeued",
                                        "handoffs")}

    def nodes_delta(role, name, **labels):
        eids = [e for e, r in roles.items() if r == role]
        return int(_node_counter(m1["nodes"], eids, name, **labels)
                   - _node_counter(m0["nodes"], eids, name, **labels))

    engine = None
    if arm == "disagg":
        engine = {"decode_prefill_dispatches": nodes_delta(
                      "decode", "tfos_replica_prefill_dispatches_total"),
                  "prefill_decode_dispatches": nodes_delta(
                      "prefill", "tfos_replica_decode_dispatches_total"),
                  "sessions_adopted": nodes_delta("decode", "tfos_replica_sessions_total",
                                                  direction="adopted")}
        if engine["decode_prefill_dispatches"] or delta["handoffs"] < len(reqs):
            raise RuntimeError(f"{arm}: prefill ran on the decode replica, or a request "
                               f"was not handed off: {engine}, handoffs {delta['handoffs']}")
    row = {"scenario": arm, "graphs": graphs, "requests": delta, "engine": engine,
           "oracle_exact": True, "wall_secs": wall,
           "throughput_tokens_per_s": sum(r["tokens"] for r in ok) / wall}
    for kind in ("short", "long"):
        rs = [r for r, k in zip(records, kinds) if k == kind]
        row[kind] = {"count": len(rs), "ttft": _percentiles([r["ttft"] for r in rs]),
                     "e2e": _percentiles([r["e2e"] for r in rs])}
    log(f"{arm}: short TTFT p50 {row['short']['ttft']['p50_secs']} p95 "
        f"{row['short']['ttft']['p95_secs']}, e2e p50 {row['short']['e2e']['p50_secs']} p95 "
        f"{row['short']['e2e']['p95_secs']}; long TTFT p50 {row['long']['ttft']['p50_secs']}, "
        f"e2e p95 {row['long']['e2e']['p95_secs']}; {row['throughput_tokens_per_s']:.1f} tok/s; "
        f"handoffs {delta['handoffs']}; engine {engine}")
    return row


def disagg_requests(seed: int, vocab: int, n_short: int = 40, n_long: int = 8,
                    short_tokens: int = 12, long_tokens: int = 320, short_budget: int = 16,
                    long_budget: int = 8) -> tuple[list, list]:
    """``--disagg``'s workload: a long prompt after every ``n_short //
    n_long`` short ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    stride = max(1, n_short // max(1, n_long))
    reqs, kinds, li = [], [], 0
    for i in range(n_short + n_long):
        is_long = li < n_long and (i - li >= n_short or i % (stride + 1) == stride)
        li += is_long
        kinds.append("long" if is_long else "short")
        n = long_tokens if is_long else short_tokens
        reqs.append((rng.integers(0, vocab, n).tolist(),
                     long_budget if is_long else short_budget))
    return reqs, kinds


def failover_scenario(args: dict, oracle_fn, after: float = 20.0, clients: int = 5,
                      graphs: bool = True, device=None, worker_env=None,
                      timeout: float = 600.0) -> dict:
    """``--failover`` (module docstring).  ``oracle_fn(prompt, n)`` is the
    solo greedy continuation."""
    import os
    import tempfile

    import numpy as np

    from tensorflowonspark_tpu_torch import chaos
    from tensorflowonspark_tpu_torch.serving import (ControlPlaneJournal, ServingCluster,
                                                     resume_driver)

    wd = tempfile.mkdtemp(prefix="tfos_failover_")
    saved = {k: os.environ.get(k) for k in ("TFOS_CHAOS", "TFOS_CHAOS_DIR")}
    os.environ["TFOS_CHAOS"] = f"kill driver after_secs={after:g}"
    os.environ["TFOS_CHAOS_DIR"] = wd
    rng = np.random.default_rng(args["seed"] + 3)
    shapes = [(rng.integers(0, model_config(args).vocab_size, int(t)).tolist(), int(n))
              for t in (4, 6, 8) for n in (24, 32)]
    results, errors, arrivals = [], [], []
    stop, lock = threading.Event(), threading.Lock()
    serving = resumed = None
    try:
        serving = ServingCluster.run(model_builder, 2, max_batch=4, replica_args=args,
                                     aot_cache=True if graphs else None, device=device,
                                     worker_env=worker_env, working_dir=wd,
                                     reservation_timeout=timeout, client_timeout=timeout,
                                     max_queue_depth=256)
        addr = serving.address

        def loop(cid):
            crng = np.random.default_rng(cid)
            try:
                with serving.client(failover_wait=120.0) as c:
                    while not stop.is_set():
                        p, n = shapes[int(crng.integers(len(shapes)))]
                        toks = []
                        for d in c.generate_stream(p, n, timeout=timeout):
                            with lock:
                                arrivals.append(time.time())
                            toks.extend(d)
                        with lock:
                            results.append((p, n, toks))
            except Exception as e:  # the zero-loss gate reads these
                with lock:
                    errors.append(f"client {cid}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=loop, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + after + timeout
        while chaos.fired_at(wd, "driver") is None:
            if time.monotonic() > deadline:
                raise RuntimeError("failover: the driver chaos never fired")
            time.sleep(0.05)
        crashed_at = chaos.fired_at(wd, "driver")
        with lock:
            before = len(results)
        resumed = resume_driver(serving.cluster, address=addr, max_batch=4,
                                crashed_at=crashed_at, client_timeout=timeout)
        resumed_at = time.time()
        resume_secs = resumed_at - crashed_at
        requeued = resumed.scheduler.requeued
        time.sleep(4.0)             # traffic after the heal
        stop.set()
        for t in threads:
            t.join(timeout)
        # the dead driver's requests still decode on the replicas: let them
        # drain before the shutdown
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and any(
                r["alive"] and r["reported_load"]
                for r in resumed.scheduler.metrics()["replicas"].values()):
            time.sleep(0.05)
    finally:
        stop.set()
        if resumed is not None:
            resumed.shutdown(timeout=timeout)
        elif serving is not None:
            serving.cluster.shutdown(timeout=timeout)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # frames the dead driver sent may still sit in a client's socket: only
    # a token read after the resume is the resumed tier's
    first_after = min((t for t in arrivals if t > resumed_at), default=None)
    cache = {}
    mismatches = sum(toks != cache.setdefault((tuple(p), n), oracle_fn(p, n))
                     for p, n, toks in results)
    st = ControlPlaneJournal.replay(os.path.join(wd, "control_plane.jsonl"))
    row = {"scenario": "driver_kill", "chaos": f"kill driver after_secs={after:g}",
           "clients": clients, "streams_before_crash": before,
           "streams_completed": len(results), "requeued_on_resume": requeued,
           "resume_secs": resume_secs,
           "heal_secs": None if first_after is None else first_after - crashed_at,
           "errors": errors, "oracle_mismatches": mismatches,
           "journal": {"admitted": len(st.admitted), "committed": len(st.committed),
                       "unfinished": len(st.unfinished), "resumes": st.resumes}}
    log(f"failover: {len(results)} streams ({before} before the crash), requeued {requeued}, resume {resume_secs:.3f} s, "
        f"heal (the crash to the first token after the resume) {row['heal_secs']} s, errors {len(errors)}, "
        f"mismatches {mismatches}, journal {row['journal']}")
    if not before or errors or mismatches or st.unfinished or st.resumes != 1 \
            or requeued < 1:
        raise RuntimeError(f"failover: a gate failed: {row}")
    return row


def bench_disagg(seed: int = 0, rate: float = 8.0, slots: int = 4, page_tokens: int = 16,
                 prefill_chunk: int = 64, device=None, width: dict | None = None,
                 worker_env: dict | None = None, **shape) -> dict:
    """``--disagg``: the unified arm, then the disaggregated one."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate

    dev, card, args = _setup(seed, device, width)
    cfg, params = model_builder(args)
    reqs, kinds = disagg_requests(seed, cfg.vocab_size, **shape)
    params = {n: t.to(dev) for n, t in params.items()}
    oracle = [greedy_generate(cfg, params, np.asarray([p]), n)[0, len(p):].tolist()
              for p, n in reqs]
    del params
    kw = dict(args=args, reqs=reqs, kinds=kinds, oracle=oracle, rate=rate, slots=slots,
              page_tokens=page_tokens, prefill_chunk=prefill_chunk,
              graphs=dev.type == "cuda", device=None if device is None else str(device),
              worker_env=worker_env)
    rows = [disagg_scenario("unified", **kw), disagg_scenario("disagg", **kw)]
    u, d = (r["short"]["ttft"]["p95_secs"] for r in rows)
    return {"benchmark": "serving_disagg", "card": card,
            "config": {"rate": rate, "slots": slots, "page_tokens": page_tokens,
                       "prefill_chunk": prefill_chunk, "seed": seed,
                       "requests": {k: kinds.count(k) for k in ("short", "long")}},
            "rows": rows, "short_ttft_p95_disagg_over_unified": d / u}


def bench_failover(seed: int = 0, device=None, width: dict | None = None,
                   worker_env: dict | None = None, after: float = 20.0) -> dict:
    """``--failover``."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate

    dev, card, args = _setup(seed, device, width)
    cfg, params = model_builder(args)
    params = {n: t.to(dev) for n, t in params.items()}
    row = failover_scenario(
        args, lambda p, n: greedy_generate(cfg, params, np.asarray([p]), n)[0, len(p):].tolist(),
        after=after, graphs=dev.type == "cuda", device=None if device is None else str(device),
        worker_env=worker_env)
    return {"benchmark": "serving_failover", "card": card, "config": {"seed": seed},
            "rows": [row]}


def _setup(seed: int, device, width):
    """``(device, card, replica args)``, float32 matrix products."""
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    dev = resolve_device(device)
    strict_matmul_precision()
    card = dev.type
    if dev.type == "cuda":
        from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

        card = card_name_and_limit()
    log(f"card {card}")
    return dev, card, {"seed": seed, **({"width": width} if width else {})}


def bench(seed: int = 0, n_requests: int = 48, rate: float = 8.0, replicas: int = 2,
          slots: int = 4, kill_step: int = 16, device=None, width: dict | None = None,
          worker_env: dict | None = None, capture=None) -> dict:
    """Run every scenario; returns the JSON line's dict.  ``device="cpu"``,
    ``width`` and ``capture`` (the capture cache's test seam) rehearse it
    at a tiny size on the CPU, where the tiers run eagerly."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import greedy_generate

    dev, card, args = _setup(seed, device, width)
    cfg, params = model_builder(args)
    reqs = requests(n_requests, cfg.vocab_size, seed)
    log(f"{n_requests} requests at {rate}/s, {replicas} replicas x {slots} slots")
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
    p.add_argument("--disagg", action="store_true",
                   help="only the unified against disaggregated arms (module docstring)")
    p.add_argument("--failover", action="store_true",
                   help="only the driver crash and resume (module docstring)")
    a = p.parse_args()
    if a.disagg:
        print(json.dumps(bench_disagg(seed=a.seed, rate=a.rate, slots=a.slots)))
        return 0
    if a.failover:
        print(json.dumps(bench_failover(seed=a.seed)))
        return 0
    print(json.dumps(bench(seed=a.seed, n_requests=a.requests, rate=a.rate,
                           replicas=a.replicas, slots=a.slots, kill_step=a.kill_step)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
