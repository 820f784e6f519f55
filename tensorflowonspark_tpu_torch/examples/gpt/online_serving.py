"""Online serving: the cluster-level tier over batcher replicas.

Port of ``examples/gpt/online_serving.py``.  Where ``cluster_serving.py``
pushes a fixed request list through the batch ``cluster.inference`` path,
this runs the ONLINE tier (``tensorflowonspark_tpu_torch.serving``): a
``ServingCluster`` of replicas behind an authenticated TCP frontend,
concurrent streaming clients, live stats — and, with ``--kill``, a
``TFOS_CHAOS`` SIGKILL of replica 1 mid-run, which a warm standby heals
(``--warm_standbys``, default 1) while the scheduler requeues the lost
streams once, losing no request.

Every result must equal a solo ``greedy_generate`` run on the driver over
the same weights (the serving determinism contract survives routing, slot
churn and failover).

Run:

    python -m tensorflowonspark_tpu_torch.examples.gpt.online_serving --cpu [--requests 12] [--kill]
    python -m tensorflowonspark_tpu_torch.examples.gpt.online_serving --cpu --tp 2 \
        --warm_standbys 0 --kill

``--tp 2`` makes each replica a gang of two processes, each holding a
Megatron tp shard of the model (``serving/sharded.py``); ``--kill`` then
SIGKILLs a gang member, and the whole gang fails over.

Without ``--cpu`` the replicas and the oracle run on the card, and
``--graphs`` arms the tier's capture cache (each replica's serve steps
captured as CUDA graphs, a standby's during its warm-up).  Besides the
reference's flags: ``--seed`` and the widths.  :func:`run` is the tier's
run without the check; :func:`model_builder` builds the served model in
each worker from ``args`` (``weights``: a ``torch.save`` d state dict to
serve instead of ``init_params(seed)``).
"""

import argparse
import threading
import time

#: the reference's tiny model
DEFAULTS = {"vocab": 83, "hidden": 32, "num_layers": 2, "num_heads": 4,
            "max_position_embeddings": 64}


def model_config(args: dict):
    """The served ``GPTConfig``: RoPE, the widths of ``args``, float32."""
    import torch

    from tensorflowonspark_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=args["vocab"], hidden_size=args["hidden"],
                     num_layers=args["num_layers"], num_heads=args["num_heads"],
                     intermediate_size=args.get("intermediate_size") or 2 * args["hidden"],
                     max_position_embeddings=args["max_position_embeddings"],
                     dtype=torch.float32, pos_encoding="rope")


def model_builder(args: dict):
    """Replica-side model (top level: pickled by reference into workers):
    ``(GPTConfig, state dict on the CPU)`` — the weights saved at
    ``args["weights"]``, else drawn from ``args["seed"]``."""
    import torch

    from tensorflowonspark_tpu_torch.models.gpt import init_params

    cfg = model_config(args)
    if args.get("weights"):
        return cfg, torch.load(args["weights"], map_location="cpu", weights_only=True)
    return cfg, init_params(cfg, int(args.get("seed", 0)))


def make_requests(n: int, vocab: int, seed: int, prompt=(3, 9), budget=(6, 14)):
    """``n`` requests ``(prompt list, budget)`` drawn from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (int(rng.integers(*prompt)),)).tolist(),
             int(rng.integers(*budget))) for _ in range(n)]


def run(args: dict, reqs, *, replicas: int = 2, slots: int = 2, clients: int = 3,
        warm_standbys: int = 0, kill_at_step: int | None = None, kill_node: int = 1,
        graphs: bool = False, mesh: dict | None = None,
        device=None, working_dir: str | None = None, timeout: float = 300.0,
        worker_env: dict | None = None, builder=None) -> dict:
    """Serve ``reqs`` through a ``ServingCluster`` from ``clients`` threads
    (client ``c`` sends requests ``c, c + clients, ...`` one after another,
    streaming), once the standbys are warm.  ``kill_at_step`` SIGKILLs
    replica ``kill_node`` at that decode step (``TFOS_CHAOS``); with a warm standby
    the second half of the requests then waits for the promoted standby's
    ``standby_ready`` (the heal), so the standby serves some of them.
    ``mesh`` (e.g. ``{"tp": 2}``) makes each replica a gang of
    mesh-sharded processes, ``kill_node`` then any shard.
    Returns the streams by request, each request's TTFT and end-to-end
    seconds, the wall of the traffic, the tier's ``metrics()``, each
    replica's last heartbeat metrics (``nodes``) and the executor ids
    the tier lost (``dead``).  ``builder`` replaces :func:`model_builder`."""
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    env = dict(worker_env or {})
    if kill_at_step is not None:
        env["TFOS_CHAOS"] = f"kill node={int(kill_node)} at_step={int(kill_at_step)}"
    serving = ServingCluster.run(builder or model_builder, replicas, max_batch=slots,
                                 replica_args=args, warm_standbys=warm_standbys,
                                 aot_cache=True if graphs else None, mesh=mesh, device=device,
                                 worker_env=env or None, working_dir=working_dir,
                                 reservation_timeout=timeout, client_timeout=timeout)
    results, ttft, e2e, errors = {}, {}, {}, []
    healed = threading.Event()
    wave = len(reqs) // 2 if kill_at_step is not None and warm_standbys else len(reqs)
    if wave == len(reqs):
        healed.set()
    try:
        if warm_standbys and not serving.wait_standbys(timeout):
            raise RuntimeError("the warm standbys did not become ready")

        def client(cid):
            try:
                with serving.client() as c:
                    for i in range(cid, len(reqs), clients):
                        if i >= wave and not healed.wait(timeout):
                            raise TimeoutError("no standby promotion healed the kill")
                        prompt, budget = reqs[i]
                        toks, t0 = [], time.perf_counter()
                        for delta in c.generate_stream(prompt, budget, timeout=timeout):
                            if not toks:
                                ttft[i] = time.perf_counter() - t0
                            toks.extend(delta)
                        e2e[i] = time.perf_counter() - t0
                        results[i] = toks
            except Exception as e:  # surfaced below, after the tier is down
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        while not healed.is_set() and time.monotonic() < deadline:
            if serving.heal.summary()["count"]:
                healed.set()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout)
        wall = time.perf_counter() - t0
        # the replicas' heartbeat-carried metrics lag by up to a beat: wait
        # until each live replica's served count shows in them
        deadline = time.monotonic() + 10.0
        while not _telemetry_settled(stats := serving.metrics()) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        dead = serving.scheduler.dead_replicas()
    finally:
        serving.shutdown(timeout=timeout)
    if errors:
        raise errors[0]
    return {"results": results, "ttft": ttft, "e2e": e2e, "wall": wall, "metrics": stats,
            "nodes": stats.get("nodes", {}), "dead": dead}


def counter(node: dict, name: str, **labels) -> float:
    """The sum of a replica's heartbeat-carried counter ``name`` over the
    samples whose labels include ``labels`` (0 when absent)."""
    entry = (node.get("metrics") or {}).get(name) or {}
    return sum(v for lab, v in entry.get("samples", [])
               if all(lab.get(k) == w for k, w in labels.items()))


def _telemetry_settled(stats: dict) -> bool:
    nodes = stats.get("nodes", {})
    return all(counter(nodes.get(eid, {}), "tfos_replica_requests_total") >= rep["served"]
               for eid, rep in stats["replicas"].items() if rep["alive"])


def oracle(args: dict, reqs, device) -> list[list[int]]:
    """Each request's solo ``greedy_generate`` continuation, on ``device``."""
    import numpy as np

    from tensorflowonspark_tpu_torch.models import greedy_generate

    cfg, params = model_builder(args)
    params = {n: t.to(device) for n, t in params.items()}
    return [greedy_generate(cfg, params, np.asarray([p]), n)[0, len(p):].tolist()
            for p, n in reqs]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--warm_standbys", type=int, default=1)
    p.add_argument("--kill", action="store_true",
                   help="SIGKILL replica 1 mid-run (TFOS_CHAOS): failover and a promotion")
    p.add_argument("--graphs", action="store_true",
                   help="capture each replica's serve steps as CUDA graphs (the card only)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel gang size: each replica a gang of this many "
                        "processes (no warm standbys)")
    p.add_argument("--seed", type=int, default=0)
    for name, value in DEFAULTS.items():
        p.add_argument(f"--{name}", type=int, default=value)
    a = p.parse_args(argv)

    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if a.cpu else None)
    strict_matmul_precision()
    args = {**{k: getattr(a, k) for k in DEFAULTS}, "seed": a.seed}
    reqs = make_requests(a.requests, a.vocab, a.seed)
    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if a.cpu else None
    out = run(args, reqs, replicas=a.replicas, slots=a.slots, clients=a.clients,
              warm_standbys=a.warm_standbys, kill_at_step=4 if a.kill else None,
              graphs=a.graphs, mesh={"tp": a.tp} if a.tp > 1 else None,
              device=device.type, worker_env=worker_env)
    results, stats = out["results"], out["metrics"]
    assert len(results) == len(reqs), (len(results), len(reqs))
    for i, want in enumerate(oracle(args, reqs, device)):
        assert results[i] == want, f"request {i} diverged"
    print(f"online_serving: {len(reqs)} streamed requests greedy-exact across {a.replicas} "
          f"replicas (completed={stats['completed']} requeued={stats['requeued']} "
          f"failed={stats['failed']} ttft_p50={stats['ttft']['p50_secs']})", flush=True)
    if a.kill:
        dead = [e for e, r in stats["replicas"].items() if not r["alive"]]
        assert dead, "kill was requested but no replica died"
        print(f"online_serving: replica {dead} died mid-run (executors "
              f"{sorted(out['dead'])}); zero requests lost; standby {stats.get('standby')}",
              flush=True)
    print("online_serving: done", flush=True)


if __name__ == "__main__":
    main()
