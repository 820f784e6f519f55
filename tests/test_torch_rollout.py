"""The port's model registry, rollout controller and autoscaler
(``tensorflowonspark_tpu_torch/serving/rollout.py``, ``autoscaler.py``).

- **registry** — the JAX package's ``tests/test_rollout.py`` registry and
  policy cases, run through both packages;
- **adapters** — ``apply_adapter`` over the port's state dict with a
  delta carried over by ``adapter_from_flax`` equals ``params_from_flax``
  of the JAX package's ``apply_adapter`` result, bit for bit in float32,
  and a GPT's logits under both agree to 1e-5;
- **scheduler and controller** — on the JAX package's fake replicas
  (``tests/test_rollout.py``'s ``_ModelWorld``): a traffic split routes
  the same requests to the same versions in both packages, a hot swap
  that fails keeps the old version routable, and rollouts that promote a
  clean canary or roll back on its error rate emit the JAX package's
  event sequence;
- **autoscaler** — ``Autoscaler.decide`` on the JAX package's sample
  sequences (``tests/test_serving_cluster.py``'s facades, unified and per
  pool) gives the same decisions and reasons in both packages.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest

from tests.test_rollout import _builder, _collect, _fake_tokens, _ModelWorld
from tests.test_serving_cluster import _FakeDisaggServing, _FakeServing

PACKAGES = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")


def _serving(pkg):
    return importlib.import_module(f"{pkg}.serving")


# ------------------------------------------------------- registry units

@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_register_lookup_and_validation(pkg):
    reg = _serving(pkg).ModelRegistry()
    v1 = reg.register("chat", "v1", _builder)
    assert reg.models() == ["chat"] and reg.versions("chat") == ["v1"]
    assert reg.version("chat", "v1") is v1
    assert v1.state == "registered" and not reg.promotable("chat", "v1")
    with pytest.raises(ValueError, match="already registered"):
        reg.register("chat", "v1", _builder)
    with pytest.raises(ValueError, match="exactly one"):
        reg.register("chat", "v2")
    with pytest.raises(ValueError, match="exactly one"):
        reg.register("chat", "v2", _builder, base=_builder)
    with pytest.raises(ValueError, match="adapter= needs base="):
        reg.register("chat", "v2", _builder, adapter={"w": np.ones(2)})
    with pytest.raises(KeyError, match="unknown version"):
        reg.version("chat", "v9")
    v2 = reg.register("chat", "v2", base=("chat", "v1"), adapter={"w": np.ones((2,), np.float32)})
    assert v2.base_builder is _builder and v2.describe()["kind"] == "adapter"
    with pytest.raises(ValueError, match="adapter-over-adapter"):
        reg.register("chat", "v3", base=("chat", "v2"))
    with pytest.raises(ValueError, match="unknown state"):
        reg.mark("chat", "v1", "bogus")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_eval_gate_serve_args_and_retention(pkg):
    reg = _serving(pkg).ModelRegistry(keep_versions=1)
    reg.register("m", "v2", _builder, serve_args={"seed": 3})
    assert not reg.promotable("m", "v2")
    assert reg.evaluate("m", "v2", scorer=lambda rs: ({"n": len(rs)}, len(rs) == 2),
                        results=["a", "b"])
    entry = reg.version("m", "v2")
    assert reg.promotable("m", "v2") and entry.state == "evaluated"
    assert entry.eval_metrics == {"n": 2}
    sa = entry.serve_args()
    assert sa["serve_model"] == ("m", "v2") and sa["seed"] == 3
    assert sa["serve_model_builder"] is _builder
    assert entry.swap_payload()["builder"] is _builder
    reg.register("m", "v3", _builder)
    assert not reg.evaluate("m", "v3", scorer=lambda rs: ({}, False), results=[])
    assert not reg.promotable("m", "v3")
    # retention: the oldest dead version beyond keep_versions loses its payloads
    reg.mark("m", "v2", "retired")
    reg.mark("m", "v3", "rolled_back")
    assert reg.version("m", "v2").evicted and not reg.version("m", "v3").evicted
    with pytest.raises(_serving(pkg).RolloutError, match="evicted"):
        reg.version("m", "v2").serve_args()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rollout_policy_validation(pkg):
    Policy = _serving(pkg).RolloutPolicy
    Policy(steps=(25, 100), bake_secs=0.0)
    for kw, match in (({"steps": (10, 50)}, "ending at"), ({"steps": (50, 10, 100)}, "increasing"),
                      ({"bake_secs": -1}, "bake_secs"), ({"max_e2e_ratio": 0}, "max_e2e_ratio"),
                      ({"max_error_rate": 2}, "max_error_rate")):
        with pytest.raises(ValueError, match=match):
            Policy(**kw)


# ------------------------------------------------------------ adapters

def test_apply_adapter_names_shapes_and_a_shared_base():
    """State-dict names; a wrong name or shape raises ``ValueError``
    naming it; the base's tensors are never written."""
    import torch

    from tensorflowonspark_tpu_torch.serving import apply_adapter

    base = {"a.weight": torch.ones(2, 2), "b": np.full((3,), 2.0, np.float32)}
    out = apply_adapter(base, {"a.weight": np.full((2, 2), 0.5), "b": np.ones((3,))})
    assert out["a.weight"].dtype == torch.float32
    np.testing.assert_array_equal(out["a.weight"].numpy(), 1.5)
    np.testing.assert_array_equal(out["b"], 3.0)
    np.testing.assert_array_equal(base["a.weight"].numpy(), 1.0)
    np.testing.assert_array_equal(base["b"], 2.0)
    with pytest.raises(ValueError, match="'a.missing'"):
        apply_adapter(base, {"a.missing": np.ones((2, 2))})
    with pytest.raises(ValueError, match=r"'b' has shape \(4,\)"):
        apply_adapter(base, {"b": np.ones((4,))})


def _flax_gpt(scan_layers):
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import GPT, GPTConfig

    jc = GPTConfig(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2,
                   intermediate_size=32, max_position_embeddings=16, dtype=jnp.float32,
                   scan_layers=scan_layers)
    params = GPT(jc).init(jax.random.key(4), jnp.ones((1, 4), jnp.int32))["params"]
    return jc, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_adapter_from_flax_carries_a_jax_delta_over_exactly(scan_layers):
    """A delta keyed as the JAX package's ``apply_adapter`` names the
    leaves (flax paths, boxed kernels with their ``/.value``): the port's
    ``apply_adapter`` with ``adapter_from_flax(delta)`` equals
    ``params_from_flax`` of the JAX result exactly (float32), and the
    adapted models' logits agree to 1e-5."""
    import jax
    import jax.numpy as jnp
    import torch

    from tensorflowonspark_tpu.models import GPT
    from tensorflowonspark_tpu.serving import apply_adapter as japply
    from tensorflowonspark_tpu_torch.models import gpt as P
    from tensorflowonspark_tpu_torch.serving import apply_adapter

    jc, params = _flax_gpt(scan_layers)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    paths = {"/".join(str(getattr(k, "key", k)) for k in path): np.shape(leaf)
             for path, leaf in flat}
    rng = np.random.default_rng(7)
    chosen = [p for p in paths if any(s in p for s in ("query/kernel", "mlp_up/bias", "ln1/scale",
                                                       "ln_f/bias", "tok_emb", "pos_emb"))]
    assert len(chosen) >= 6
    delta = {p: (0.05 * rng.standard_normal(paths[p])).astype(np.float32) for p in chosen}
    pc = P.GPTConfig(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2,
                     intermediate_size=32, max_position_embeddings=16, dtype=torch.float32)
    want = P.params_from_flax(japply(params, delta), pc)
    got = apply_adapter(P.params_from_flax(params, pc), P.adapter_from_flax(delta, pc))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert any(not np.array_equal(got[n].numpy(), v.numpy())
               for n, v in P.params_from_flax(params, pc).items())
    ids = np.random.default_rng(0).integers(0, 37, (2, 9)).astype(np.int32)
    jlogits = np.asarray(jax.jit(GPT(jc).apply)({"params": japply(params, delta)},
                                                jnp.asarray(ids)))
    model = P.GPT(pc)
    model.load_state_dict(got)
    with torch.no_grad():
        plogits = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(plogits, jlogits, atol=1e-5)


def test_adapter_from_flax_rejects_unknown_paths():
    import torch

    from tensorflowonspark_tpu_torch.models import gpt as P

    pc = P.GPTConfig(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2,
                     intermediate_size=32, max_position_embeddings=16, dtype=torch.float32)
    for path in ("h_0/attn/c_attn/kernel", "layer_2/attn/query/kernel", "layer_0/attn/rope"):
        with pytest.raises(ValueError, match=path):
            P.adapter_from_flax({path: np.zeros((1,), np.float32)}, pc)


# ------------------------------------------- scheduler and controller

def _scheduler(pkg, world, **kw):
    kw.setdefault("slots_per_replica", 2)
    kw.setdefault("poll_interval", 0.05)
    return _serving(pkg).ReplicaScheduler(world, client_factory=world.client, **kw)


def _tier(pkg, world, scheduler, registry):
    """A driver-side ``ServingCluster`` over the fakes (no frontend or
    monitor), labeled with the founding model as ``run(model=)`` does."""
    tier = _serving(pkg).ServingCluster(world, scheduler, monitor=None, frontend=None,
                                        address=("127.0.0.1", 0))
    tier.registry = registry
    rep = scheduler.replicas[min(scheduler.replicas)]
    tier._default_model = (rep.model, rep.version)
    return tier


def _swap_registry(pkg):
    reg = _serving(pkg).ModelRegistry()
    reg.register("m", "v1", _builder, serve_args={"salt": 0})
    reg.register("m", "v2", _builder, serve_args={"salt": 9})
    reg.record_eval("m", "v2", {"ok": 1}, passed=True)
    reg.register("m", "v3", _builder, serve_args={"salt": 0, "fail": True})
    reg.record_eval("m", "v3", {"offline": "cannot see latency"}, passed=True)
    reg.register("m", "bad", _builder, serve_args={"swap_fail": True})
    reg.record_eval("m", "bad", {}, passed=True)
    return reg


def _split_run(pkg):
    """Which version served each of 30 requests under a 50/50, then a
    10/90 split (version-salted fake output tells)."""
    world = _ModelWorld(2)
    s = _scheduler(pkg, world, model=("m", "v1")).start()
    served = []
    try:
        s.retire_replica(1)
        info = world.add_replica()
        world.behavior[int(info["executor_id"])] = {"salt": 1, "fail": False}
        s.add_replica(info, model=("m", "v2"))
        with pytest.raises(ValueError, match="summing to 100"):
            s.set_traffic_split("m", {"v1": 30, "v2": 30})
        for split, n in (({"v2": 50, "v1": 50}, 10), ({"v2": 10, "v1": 90}, 20)):
            s.set_traffic_split("m", split)
            for k in range(n):
                p = np.asarray([len(served) + 1], np.int32)
                toks, err = _collect(s.submit(p, 3, model="m"))
                assert err is None
                served.append("v2" if toks == _fake_tokens(p, 3, 1) else "v1")
        traffic = s.metrics()["traffic"]
        s.clear_traffic_split("m")
        assert s.metrics()["traffic"] == {}
    finally:
        s.stop()
    return served, traffic


def test_traffic_split_routes_the_same_requests_to_the_same_versions():
    ref, port = (_split_run(p) for p in PACKAGES)
    assert port == ref
    served, traffic = port
    assert served[:10].count("v2") == 5 and served[10:].count("v2") == 2
    assert traffic == {"m": {"v2": 10.0, "v1": 90.0}}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_hot_swap_failure_keeps_old_version_routable(pkg):
    world = _ModelWorld(1)
    s = _scheduler(pkg, world, model=("m", "v1")).start()
    tier = _tier(pkg, world, s, _swap_registry(pkg))
    try:
        with pytest.raises(RuntimeError, match="injected swap failure"):
            tier.swap_replica_model(0, "m", "bad")
        rep = s.metrics()["replicas"][0]
        assert rep["version"] == "v1" and not rep["draining"]
        p = np.asarray([2], np.int32)
        toks, err = _collect(s.submit(p, 3, model="m"))
        assert err is None and toks == _fake_tokens(p, 3, 0)
    finally:
        s.stop()


def test_hot_swap_drains_swaps_and_resumes():
    pkg = PACKAGES[1]
    world = _ModelWorld(2)
    s = _scheduler(pkg, world, model=("m", "v1")).start()
    tier = _tier(pkg, world, s, _swap_registry(pkg))
    try:
        tier.swap_replica_model(1, "m", "v2")
        m = s.metrics()["replicas"]
        assert m[1]["version"] == "v2" and not m[1]["draining"]
        assert s.model_versions("m") == {"v1": [0], "v2": [1]}
        [(eid, msg)] = [(e, i) for e, i in world.control if i.get("op") == "model"]
        assert eid == 1 and msg["version"] == "v2" and msg["serve_args"] == {"salt": 9}
        s.set_traffic_split("m", {"v2": 100})
        p = np.asarray([4, 4], np.int32)
        toks, err = _collect(s.submit(p, 4, model="m"))
        assert err is None and toks == _fake_tokens(p, 4, 9)
    finally:
        s.stop()


def _rollout_run(pkg, version, policy_kw, tmp_path):
    """One rollout of ``m`` to ``version`` over two fake replicas under a
    steady trickle of requests; returns the controller's outcome and the
    rollout/model events in the order the tier wrote them."""
    obs = importlib.import_module(f"{pkg}.observability")
    log_path = tmp_path / f"{pkg}-{version}.jsonl"
    log = obs.EventLog(str(log_path))
    world = _ModelWorld(2)
    reg = _swap_registry(pkg)
    s = _scheduler(pkg, world, model=("m", "v1"), event_log=log).start()
    tier = _tier(pkg, world, s, reg)
    stop, outcomes = threading.Event(), {"ok": 0, "err": 0}

    def load():
        k = 0
        while not stop.is_set():
            k += 1
            try:
                _, err = _collect(s.submit(np.asarray([k % 11 + 1], np.int32), 3, model="m"),
                                  timeout=5)
                outcomes["err" if err else "ok"] += 1
            except Exception:
                return
            time.sleep(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        ctl = tier.rollout("m", version, policy=_serving(pkg).RolloutPolicy(**policy_kw))
        stop.set()
        t.join(5)
        p = np.asarray([6], np.int32)
        toks, err = _collect(s.submit(p, 3, model="m"))
        out = {"state": ctl.state, "reason": (ctl.detail.get("reason") or "").split(" ")[:3],
               "versions": s.model_versions("m"), "traffic": s.metrics()["traffic"],
               "states": {v: reg.version("m", v).state for v in ("v1", version)},
               "after": (err, toks), "incumbent_served": outcomes["ok"] > 0}
    finally:
        stop.set()
        s.stop()
        log.close()
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    out["events"] = [(e["kind"], e.get("percent"), e.get("mode"))
                     for e in events if e["kind"].startswith(("rollout_", "model_"))]
    return out


@pytest.mark.parametrize("version, policy_kw, want", [
    ("v2", dict(steps=(50, 100), bake_secs=0.3, min_samples=3, max_e2e_ratio=None),
     "promoted"),
    ("v3", dict(steps=(50, 100), bake_secs=0.3, min_samples=1, max_error_rate=0.2,
                max_e2e_ratio=None), "rolled_back")])
def test_rollout_emits_the_reference_event_sequence(version, policy_kw, want, tmp_path):
    """A clean canary walks every step and promotes (both replicas end on
    v2, v1 retired); an erroring canary trips the error-rate gate, the
    canary swaps back and v1 never stops serving.  Both packages write the
    same rollout events in the same order."""
    ref, port = (_rollout_run(p, version, policy_kw, tmp_path) for p in PACKAGES)
    assert port == ref
    assert port["state"] == want and port["traffic"] == {} and port["incumbent_served"]
    assert port["after"][0] is None
    if want == "promoted":
        assert port["versions"] == {"v2": [0, 1]}
        assert port["states"] == {"v1": "retired", "v2": "serving"}
        assert port["after"][1] == _fake_tokens([6], 3, 9)
        assert [k for k, _, _ in port["events"] if k.startswith("rollout_")] == [
            "rollout_started", "rollout_canary", "rollout_step", "rollout_step",
            "rollout_promoted"]
    else:
        assert port["reason"] == ["canary", "error", "rate"]
        assert port["versions"] == {"v1": [0, 1]}
        assert port["states"]["v3"] == "rolled_back"
        assert port["events"][-1][0] == "rollout_rolled_back"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_rollout_refuses_unevaluated_version_and_unlabeled_deploy(pkg):
    sv = _serving(pkg)
    world = _ModelWorld(1)
    reg = sv.ModelRegistry()
    reg.register("m", "v1", _builder)
    reg.register("m", "v2", _builder)
    s = _scheduler(pkg, world, model=("m", "v1")).start()
    tier = _tier(pkg, world, s, reg)
    try:
        with pytest.raises(sv.RolloutError, match="offline eval"):
            tier.rollout("m", "v2")
        tier._default_model = None
        with pytest.raises(RuntimeError, match="model-labeled tier"):
            tier.deploy_model("m", "v2", require_eval=False)
    finally:
        s.stop()


# --------------------------------------------------------- autoscaler

def _decisions_unified(pkg):
    """The JAX package's hysteresis/cooldown and TTFT sample sequences."""
    Autoscaler = _serving(pkg).Autoscaler
    out = []
    fake = _FakeServing(replicas=1)
    a = Autoscaler(fake, min_replicas=1, max_replicas=3, up_queue_per_replica=4.0,
                   up_consecutive=2, up_cooldown=10.0, down_consecutive=2,
                   down_cooldown=30.0, down_outstanding_per_replica=1.0)
    t = 1000.0
    script = [(9, 0, 1, 0), (9, 0, 1, 1), (9, 0, 2, 2), (9, 0, 2, 3), (9, 0, 2, 12),
              (20, 0, 3, 30), (20, 0, 3, 31), (0, 0, 3, 40), (0, 0, 3, 41), (0, 0, 2, 42),
              (0, 0, 2, 43), (0, 0, 2, 72)]
    for queued, outstanding, n, dt in script:
        fake.queued, fake.outstanding, fake.n = queued, outstanding, n
        d = a.decide(a.sample(), now=t + dt)
        out.append(d)
        if d[0] != "hold":
            a.acted(d[0], now=t + dt)
    fake = _FakeServing(replicas=2)
    a = Autoscaler(fake, min_replicas=2, max_replicas=3, up_ttft_p95=0.5, up_consecutive=1,
                   up_cooldown=0.0, down_consecutive=1, down_cooldown=0.0)
    s = a.sample()
    s["ttft_p95"] = 0.8
    out.append(a.decide(s, now=1.0))
    a.acted("up", now=1.0)
    out.append(a.decide(a.sample(), now=100.0))
    return out


def _decisions_per_pool(pkg):
    sv = _serving(pkg)
    fake = _FakeDisaggServing(n_prefill=1, n_decode=1)
    scalers = {role: sv.Autoscaler(fake, sv.AutoscalerConfig(
        role=role, min_replicas=1, max_replicas=3, up_queue_per_replica=2.0,
        up_consecutive=1, up_cooldown=0.0)) for role in ("prefill", "decode")}
    out = []
    for now, (queued, handoffs, busy) in enumerate([(9, 0, {"prefill": 0, "decode": 0}),
                                                    (0, 9, {"prefill": 5, "decode": 5})]):
        fake.queued, fake.queued_handoffs, fake.outstanding_by_role = queued, handoffs, busy
        for role, a in scalers.items():
            s = a.sample()
            out.append((role, s["alive"], s["queued"], a.decide(s, now=float(now + 1))))
    scalers["decode"]._scale_up(scalers["decode"].sample(), "test")
    fake.queued = fake.queued_handoffs = 0
    fake.outstanding_by_role = {"prefill": 0, "decode": 4}
    m = fake.scheduler.metrics()
    victim = scalers["decode"]._victim(m)
    out.append((fake.added_roles, m["replicas"][victim[0]]["role"],
                [(k, f["role"]) for k, f in fake.events if k == "scale_up"]))
    return out


@pytest.mark.parametrize("sequence", [_decisions_unified, _decisions_per_pool])
def test_autoscaler_decides_as_the_reference(sequence):
    ref, port = (sequence(p) for p in PACKAGES)
    assert port == ref
    kinds = [d[0] for d in port if isinstance(d, tuple) and d and d[0] in ("up", "down", "hold")]
    if sequence is _decisions_unified:
        assert kinds == ["hold", "up", "hold", "hold", "up", "hold", "hold", "hold", "down",
                         "hold", "hold", "down", "up", "hold"]
    else:
        assert [d[3][0] for d in port[:4]] == ["up", "hold", "hold", "up"]
        assert port[-1][:2] == (["decode"], "decode")


def test_autoscaler_loop_scales_up_and_drains_down_with_events():
    fake = _FakeServing(replicas=1)
    fake.queued = 50
    a = _serving(PACKAGES[1]).Autoscaler(
        fake, min_replicas=1, max_replicas=2, interval=0.05, up_queue_per_replica=4.0,
        up_consecutive=2, up_cooldown=0.0, down_consecutive=2, down_cooldown=0.0)
    a.start()
    try:
        deadline = time.monotonic() + 5
        while fake.added == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fake.added >= 1
        fake.queued = fake.outstanding = 0
        deadline = time.monotonic() + 5
        while not fake.retired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fake.retired
    finally:
        a.stop()
    kinds = [k for k, _ in fake.events]
    assert "scale_up" in kinds and "scale_down" in kinds
    assert "reason" in dict(fake.events)["scale_up"]
