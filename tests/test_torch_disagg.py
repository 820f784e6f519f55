"""The port's disaggregated prefill/decode pools
(``tensorflowonspark_tpu_torch/serving/disagg.py`` and the role-aware
routing, handoff queue and promote-with-role it brings back).

- **role arithmetic** — ``validate_disagg``, ``role_for_executor`` and
  ``boot_roles`` agree with the JAX package's, errors included;
- **routing on fakes** — the JAX package's ``tests/test_serving_cluster.py``
  disaggregated fake pools (``_DisaggWorld``): the prompt goes to the
  prefill pool and the session is adopted by the decode pool, requeue-once
  holds across the prefill→decode boundary, a role-less warm standby is
  promoted into a dead decode replica's pool — both packages, the same
  outcome;
- **the tier's options** — ``ServingCluster.run``'s checks of ``disagg=``,
  ``model=``/``registry=`` and a ``(model_id, version)`` ``draft_model``
  raise the JAX package's errors before any worker boots; the mesh
  options (ROADMAP A6) raise ``NotImplementedError``;
- **end to end** — one real CPU tier of a prefill and a decode replica
  (tiny GPT, paged KV): every stream equals the JAX package's
  ``greedy_generate``, each request handed off once, and the decode
  replica prefilled nothing.
"""

import importlib
import time

import numpy as np
import pytest

from tests.test_serving_cluster import (_collect, _DisaggPoolWorld, _DisaggWorld,
                                        _fake_tokens)

PACKAGES = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.serving.{name}")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # compared across the packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    {"prefill": 1, "decode": 1}, {"prefill": "2", "decode": 3, "decode_kwargs": {"x": 1}},
    {"prefill": 0, "decode": 1}, {"prefill": 1}, {"prefil": 1, "decode": 1}])
def test_role_arithmetic_agrees_with_the_reference(spec):
    got = {}
    for pkg in PACKAGES:
        d = _mod(pkg, "disagg")
        v = _outcome(d.validate_disagg, spec)
        roles = v if v[0] != "ok" else (
            "ok", [d.role_for_executor(v[1], e, g) for g in (1, 2) for e in range(8)],
            d.boot_roles(v[1]), d.boot_roles(v[1], 2))
        got[pkg] = (v, roles)
    assert got[PACKAGES[1]] == got[PACKAGES[0]]


def _scheduler(pkg, world, **kw):
    kw.setdefault("slots_per_replica", 2)
    kw.setdefault("poll_interval", 0.05)
    kw.setdefault("roles", dict(world.roles))
    return _mod(pkg, "scheduler").ReplicaScheduler(world, client_factory=world.client, **kw)


def _route_run(pkg):
    world = _DisaggWorld(1, 1)
    s = _scheduler(pkg, world).start()
    try:
        prompts = [np.arange(1, 4 + i, dtype=np.int32) for i in range(5)]
        streams = [_collect(s.submit(p, 6)) for p in prompts]
        assert all(err is None and toks == _fake_tokens(p, 6)
                   for (toks, err), p in zip(streams, prompts))
        m = s.metrics()
        return {k: m[k] for k in ("handoffs", "completed", "queued_handoffs")} | {
            e: {k: m["replicas"][e][k] for k in ("role", "served", "free_pages")}
            for e in (0, 1)}
    finally:
        s.stop()


def test_prompt_goes_to_prefill_and_the_session_to_decode():
    ref, port = (_route_run(p) for p in PACKAGES)
    assert port == ref
    assert port["handoffs"] == 5 and port["completed"] == 5 and port["queued_handoffs"] == 0
    assert port[0] == {"role": "prefill", "served": 0, "free_pages": 7}
    assert port[1]["role"] == "decode" and port[1]["served"] == 5


def _decode_death_run(pkg, second_death):
    """The request dies on the decode side after its handoff; with
    ``second_death`` its replay dies there too."""
    world = _DisaggWorld(1, 2, token_delay=0.05)
    s = _scheduler(pkg, world, slots_per_replica=1, overcommit=1).start()
    try:
        p = np.asarray([3, 5, 8], np.int32)
        req = s.submit(p, 10)
        deadline = time.monotonic() + 10
        while len(req.tokens) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        attempts = req.attempts
        assert world.roles[req.replica] == "decode"
        world.kill(req.replica)
        if second_death:
            deadline = time.monotonic() + 10
            while (req.replica is None or world.roles.get(req.replica) != "decode"
                   or req.replica in world._dead) and time.monotonic() < deadline:
                time.sleep(0.01)
            world.kill(req.replica)
        toks, err = _collect(req, timeout=15)
        m = s.metrics()
        return {"attempts_before": attempts, "exact": toks == _fake_tokens(p, 10),
                "err": None if err is None else err[1],
                **{k: m[k] for k in ("requeued", "completed", "failed", "handoffs")}}
    finally:
        s.stop()


@pytest.mark.parametrize("second_death", [False, True])
def test_requeue_once_spans_the_prefill_decode_boundary(second_death):
    """A decode replica dying after the handoff replays the request once
    through prefill → handoff → adopt, the client stream exact; the adopt
    hop charges no failover attempt, so a second decode death fails the
    request typed."""
    ref, port = (_decode_death_run(p, second_death) for p in PACKAGES)
    assert port == ref
    assert port["attempts_before"] == 1 and port["requeued"] == 1
    if second_death:
        assert port["err"] == "replica_failed" and port["failed"] == 1
    else:
        assert port["exact"] and port["err"] is None and port["handoffs"] == 2


def test_a_role_less_standby_is_promoted_into_the_dead_decode_pool():
    """The promote message carries ``role="decode"``, the newcomer joins
    the decode pool, a prefill replica is asked to donate its prefix
    pages, and the healed pipeline serves exact."""
    from tensorflowonspark_tpu_torch.health import ClusterFailure
    from tensorflowonspark_tpu_torch.serving import ServingCluster, StandbyPool

    world = _DisaggPoolWorld(1, 1)
    s = _scheduler(PACKAGES[1], world).start()
    tier = ServingCluster(world, s, monitor=None, frontend=None, address=("127.0.0.1", 0))
    tier.disagg = {"prefill": 1, "decode": 1}
    s.on_replica_ready = tier._on_standby_ready
    tier.standbys = StandbyPool(tier, 1)
    tier.standbys.fill()
    try:
        world.kill(1)
        s.on_cluster_failure(ClusterFailure("crash", "crash: worker 1", (1,)))
        tier._spawn_replacement(1, source="failure", promote_source="failure")
        deadline = time.monotonic() + 10
        while not any(m.get("op") == "prefix" for _, m in world.control) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert 2 in s.alive_replicas() and s.replica_role(2) == "decode"
        [promote] = [m for e, m in world.control if m.get("op") == "standby"]
        assert promote["event"] == "promote" and promote["role"] == "decode"
        [(donor, donation)] = [(e, m) for e, m in world.control if m.get("op") == "prefix"]
        assert donor == 0 and donation["event"] == "export"
        for k in range(3):
            p = np.asarray([5 + k, 2], np.int32)
            toks, err = _collect(s.submit(p, 6))
            assert err is None and toks == _fake_tokens(p, 6)
        assert tier.metrics()["standby"]["promotions"] == {"failure": 1, "role:decode": 1}
    finally:
        tier.standbys.stop()
        s.stop()


# ------------------------------------------------------- tier options

def _tiny_builder(args):
    return None, {}


@pytest.mark.parametrize("kw", [
    {"disagg": {"prefill": 1, "decode": 0}},
    {"disagg": {"prefill": 1, "decode": 1}},                   # num_replicas 1
    {"disagg": {"prefill": 1, "decode": 0}, "num_replicas": 2},
    {"disagg": {"prefill": 1, "decode": 1}, "num_replicas": 2},   # no kv_page_tokens
    {"disagg": {"prefill": 1, "decode": 1}, "num_replicas": 2, "warm_standbys": 1,
     "batcher_kwargs": {"kv_page_tokens": 4, "speculative_k": 2}},
    {"model": ("m", "v1"), "registry": "registry"},
    {"model": ("m", "v1"), "registry": "registry", "model_builder": None,
     "draft_model": ("m", "d")},
    {"draft_model": ("m", "d")},
    {"draft_model": 3},
    {"warm_standbys": -1}])
def test_tier_options_fail_as_the_reference_before_a_worker_boots(kw):
    got = {}
    for pkg in PACKAGES:
        sv = importlib.import_module(f"{pkg}.serving")
        reg = sv.ModelRegistry()
        reg.register("m", "v1", _tiny_builder)
        args = {"model_builder": _tiny_builder, "num_replicas": 1, **kw}
        if args.get("registry") == "registry":
            args["registry"] = reg
        builder, n = args.pop("model_builder"), args.pop("num_replicas")
        got[pkg] = _outcome(lambda: sv.ServingCluster.run(builder, n, **args))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    assert got[PACKAGES[1]][0] in ("ValueError", "KeyError")


# --------------------------------------------------------- end to end

E2E_CFG = dict(vocab_size=83, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               max_position_embeddings=64)


def test_cpu_disagg_tier_equals_jax_greedy(tmp_path):
    """A real tier on the CPU: one prefill and one decode replica (paged KV,
    pages of 4 tokens), 6 streamed requests.  Every stream equals the JAX
    package's ``greedy_generate`` on the flax weights the workers get as a
    numpy state dict; every request is handed off once, and the decode
    replica runs no prefill."""
    import jax
    import jax.numpy as jnp
    import torch

    from tensorflowonspark_tpu.models import GPT, GPTConfig, greedy_generate
    from tensorflowonspark_tpu_torch.examples.gpt.online_serving import counter, model_builder
    from tensorflowonspark_tpu_torch.models.gpt import params_from_flax
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    jcfg = GPTConfig(**E2E_CFG, dtype=jnp.float32, pos_encoding="rope")
    flax_params = GPT(jcfg).init(jax.random.key(5), jnp.ones((1, 4), jnp.int32))["params"]
    torch.save(params_from_flax(jax.tree.map(np.asarray, flax_params), jcfg),
               tmp_path / "weights.pt")
    args = {"vocab": 83, "hidden": 32, "num_layers": 2, "num_heads": 4,
            "max_position_embeddings": 64, "weights": str(tmp_path / "weights.pt")}
    rng = np.random.default_rng(2)
    shapes = [(6, 8), (11, 8)] * 3
    reqs = [(rng.integers(0, 83, (t,)).tolist(), n) for t, n in shapes]
    serving = ServingCluster.run(
        model_builder, 2, max_batch=2, replica_args=args, device="cpu",
        disagg={"prefill": 1, "decode": 1}, batcher_kwargs={"kv_page_tokens": 4},
        working_dir=str(tmp_path / "tier"), reservation_timeout=60, client_timeout=60,
        worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    try:
        with serving.client() as c:
            out = [[t for d in c.generate_stream(p, n, timeout=60) for t in d]
                   for p, n in reqs]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            nodes = serving.metrics()["nodes"]
            if min(counter(nodes.get(eid, {}), "tfos_replica_sessions_total",
                           direction=d) for eid, d in ((0, "exported"), (1, "adopted"))) \
                    >= len(reqs):
                break
            time.sleep(0.2)
        m = serving.metrics()
    finally:
        serving.shutdown(timeout=60)
    greedy = jax.jit(greedy_generate, static_argnums=(0, 3))
    for (t, n) in sorted(set(shapes)):
        idx = [i for i, s in enumerate(shapes) if s == (t, n)]
        want = np.asarray(greedy(jcfg, flax_params,
                                 jnp.asarray([reqs[i][0] for i in idx], jnp.int32), n))[:, t:]
        for i, w in zip(idx, want):
            assert out[i] == w.tolist(), f"request {i} diverged"
    assert m["handoffs"] == len(reqs) and m["completed"] == len(reqs)
    assert m["replicas"][0]["role"] == "prefill" and m["replicas"][1]["role"] == "decode"
    decode = m["nodes"][1]
    assert counter(decode, "tfos_replica_sessions_total", direction="adopted") == len(reqs)
    assert counter(decode, "tfos_replica_prefill_dispatches_total") == 0
    assert counter(m["nodes"][0], "tfos_replica_sessions_total",
                   direction="exported") == len(reqs)
