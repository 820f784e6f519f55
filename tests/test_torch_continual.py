"""The port's continual loop (``tensorflowonspark_tpu_torch/continual/``).

- **parameter math** — the JAX package's ``diff_params`` over a flax GPT's
  parameters, carried over by ``models.gpt.adapter_from_flax``, equals the
  port's ``diff_params`` over the ``params_from_flax`` state dicts exactly
  (float32, same names); ``flatten_params``/``replace_leaves``/
  ``build_published_full`` round-trip state dicts of tensors; each
  package's ``payload_digest`` is stable and sees dtype and shape (the two
  packages key by different names, so their digests are compared each on
  its own terms, never across);
- **the publisher and collector** — only the chief publishes, and an
  adapter publication carries the delta only; ``attach`` fires on each
  durable save of the port's ``CheckpointManager``; the collector drops a
  corrupt digest and a duplicate and names a missing ``publish`` queue; a
  multi-MB publication rides the bulk tier (``tfos_transport_*``); a
  trainer SIGKILLed mid-publish never surfaces a partial candidate; the
  node drains its ``publish`` queue before a clean exit;
- **the pipeline** over fake replicas (``tests/test_rollout.py``'s
  ``_ModelWorld`` under the port's scheduler, a stand-in ``GridSearch``):
  promote, reject offline and roll back, each writing the same journal
  records as the JAX package's pipeline for the same script; the payload
  store round-trips state-dict names through ``np.savez``; ``resume``
  finalizes a concluded rollout without re-shifting traffic, re-hydrates a
  stored candidate, skips a lost one and restores a journaled verdict;
- **the GPT eval predict function** (``gpt_continual.eval_predict``) at 2
  layers, hidden 32, float32, the plain attention on the CPU: each row's
  mean next-token loss under base + a candidate delta equals the JAX
  package's GPT (its flash kernel causal in interpret mode) under the JAX
  ``apply_adapter`` of the same delta, within ``rtol=1e-5``
  (``tests/test_torch_gpt.py`` sees ~3e-7 on the logits).
"""

import functools
import importlib
import json
import os
import threading
import time

import numpy as np
import pytest

PACKAGES = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")
AUTH = b"k" * 16
WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}


def _continual(pkg):
    return importlib.import_module(f"{pkg}.continual")


class _RecMgr:
    """In-process stand-in for the worker's queue server: records puts."""

    def __init__(self):
        self.sent = []

    def queue_put(self, qname, item, timeout=None):
        self.sent.append((qname, item))


class _Ctx:
    def __init__(self, chief=True, mgr=None):
        self.executor_id = 0
        self.is_chief = chief
        self.mgr = mgr if mgr is not None else _RecMgr()


def _counter(name, help_, label):
    from tensorflowonspark_tpu_torch import metrics

    return metrics.get_registry().counter(name, help_, labelnames=("outcome",)).value(
        outcome=label)


def _pubs(outcome):
    return _counter("tfos_continual_publications_total",
                    "Checkpoint publications by ingest outcome.", outcome)


def _versions(outcome):
    return _counter("tfos_continual_versions_total",
                    "Continual-loop candidates by terminal outcome.", outcome)


# ------------------------------------------------------------ parameter math

@pytest.mark.parametrize("scan_layers", [False, True])
def test_diff_params_of_a_flax_gpt_equals_the_jax_diff_exactly(scan_layers):
    import jax
    import torch

    from tensorflowonspark_tpu.continual import diff_params as jdiff
    from tensorflowonspark_tpu_torch.continual import diff_params
    from tensorflowonspark_tpu_torch.models import gpt as P
    from tests.test_torch_rollout import _flax_gpt

    _, base = _flax_gpt(scan_layers)
    rng = np.random.default_rng(5)
    # the last block and the final norm move (stacked: every block's MLP)
    chosen = ("mlp", "ln_f") if scan_layers else ("layer_1", "ln_f")
    flat, treedef = jax.tree_util.tree_flatten_with_path(base)
    moved = [leaf + (0.01 * rng.standard_normal(np.shape(leaf))).astype(np.float32)
             if any(s in "/".join(str(getattr(k, "key", k)) for k in path)
                    for s in chosen) else leaf
             for path, leaf in flat]
    params = jax.tree_util.tree_unflatten(treedef, moved)
    pc = P.GPTConfig(vocab_size=37, hidden_size=16, num_layers=2, num_heads=2,
                     intermediate_size=32, max_position_embeddings=16, dtype=torch.float32)
    want = P.adapter_from_flax(jdiff(base, params), pc)
    got = diff_params(P.params_from_flax(base, pc), P.params_from_flax(params, pc))
    assert set(got) == set(want) and len(got) >= 6
    assert all(n.startswith("ln_f.") or (".mlp" in n if scan_layers else
                                         n.startswith("layers.1.")) for n in got)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_flatten_diff_replace_and_build_published_full_round_trip():
    import torch

    from tensorflowonspark_tpu_torch.continual import (build_published_full, diff_params,
                                                       flatten_params, payload_nbytes,
                                                       replace_leaves)

    base = {"a": {"weight": torch.ones(2, 3)}, "b": np.zeros((4,), np.float64)}
    flat = flatten_params(base)
    assert set(flat) == {"a.weight", "b"} and payload_nbytes(flat) == 2 * 3 * 4 + 4 * 8
    params = {"a": {"weight": base["a"]["weight"] + 0.5}, "b": base["b"]}
    delta = diff_params(base, params)
    assert set(delta) == {"a.weight"}
    np.testing.assert_allclose(delta["a.weight"], 0.5)
    assert diff_params(base, params, atol=1.0) == {}
    with pytest.raises(ValueError, match="disagree on paths"):
        diff_params(base, {"a": {"weight": torch.ones(2, 3)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        diff_params(base, {"a": {"weight": torch.ones(3, 2)}, "b": base["b"]})
    with pytest.raises(TypeError, match="float32 master"):
        flatten_params({"w": torch.ones(2, dtype=torch.bfloat16)})
    # the host copy owns its memory: a later in-place update does not reach it
    live = {"w": torch.zeros(3)}
    snap = flatten_params(live)
    live["w"].add_(1.0)
    np.testing.assert_array_equal(snap["w"], 0.0)

    rebuilt = replace_leaves(base, flatten_params(params))
    assert torch.equal(rebuilt["a"]["weight"], torch.full((2, 3), 1.5))
    assert rebuilt["a"]["weight"].dtype == torch.float32 and rebuilt["b"].dtype == np.float64
    with pytest.raises(ValueError, match="misses leaf"):
        replace_leaves(base, {"b": np.zeros((4,))})
    with pytest.raises(ValueError, match="shape"):
        replace_leaves(base, {"a.weight": np.ones((9,)), "b": flat["b"]})

    def base_builder(args):
        return {"cfg": True}, {"w": torch.zeros(3)}

    cfg, sd = build_published_full({"serve_base_builder": base_builder,
                                    "serve_published_params": {"w": np.full((3,), 7.0)}})
    assert cfg == {"cfg": True} and sd["w"].dtype == torch.float32
    np.testing.assert_allclose(sd["w"].numpy(), 7.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_payload_digest_is_stable_and_sees_dtype_and_shape(pkg):
    C = _continual(pkg)
    a = {"layers.0.w": np.arange(6, dtype=np.float32), "b": np.ones(2, np.float32)}
    same = {"b": np.ones(2, np.float32), "layers.0.w": np.arange(6, dtype=np.float32)}
    assert C.payload_digest(a) == C.payload_digest(same) == C.payload_digest(dict(a))
    variants = [{**a, "layers.0.w": a["layers.0.w"].reshape(2, 3)},
                {**a, "layers.0.w": a["layers.0.w"].astype(np.float64)},
                {**a, "b": np.array([1.0, 1.5], np.float32)},
                {"layers.1.w": a["layers.0.w"], "b": a["b"]}]
    digests = {C.payload_digest(v) for v in variants} | {C.payload_digest(a)}
    assert len(digests) == len(variants) + 1


# ------------------------------------------------- the publisher and collector

def test_publisher_is_chief_only_and_ships_delta_not_base():
    import torch

    from tensorflowonspark_tpu_torch.continual import (CheckpointPublisher, flatten_params,
                                                       payload_digest, payload_nbytes)

    base = {"w": torch.zeros(1 << 16, dtype=torch.float64), "b": torch.zeros(32)}
    params = {"w": base["w"].clone(), "b": base["b"] + 1.0}
    ctx = _Ctx()
    pub = CheckpointPublisher(ctx, "m", base=base, serve_args={"salt": 9})
    assert pub.publish(5, params) == "step-5"
    [(qname, msg)] = ctx.mgr.sent
    assert qname == "publish" and msg["op"] == "publish" and msg["flavor"] == "adapter"
    assert set(msg["payload"]) == {"b"} and msg["digest"] == payload_digest(msg["payload"])
    np.testing.assert_allclose(msg["payload"]["b"], 1.0)
    assert msg["nbytes"] * 100 < payload_nbytes(flatten_params(base))
    ctx2 = _Ctx(chief=False)
    assert CheckpointPublisher(ctx2, "m").publish(1, params) is None and ctx2.mgr.sent == []

    class _NoQueues:
        executor_id, is_chief, mgr = 0, True, None

    with pytest.raises(RuntimeError, match="queue server"):
        CheckpointPublisher(_NoQueues(), "m")


def test_attach_publishes_each_durable_save_and_swallows_listener_errors(tmp_path):
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.continual import CheckpointPublisher

    ctx = _Ctx()
    boom = []
    with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
        CheckpointPublisher(ctx, "m", metadata={"run": "r1"}).attach(
            mngr, transform=lambda s: s["model"])

        def bad(step, state):
            boom.append(step)
            raise RuntimeError("listener boom")

        mngr.add_save_listener(bad)
        assert mngr.save(3, {"model": {"w": torch.ones(4)}, "step": 3})
        assert not mngr.save(3, {"model": {"w": torch.ones(4)}, "step": 3})
        assert mngr.save(4, {"model": {"w": torch.full((4,), 2.0)}, "step": 4})
    assert [m["version"] for _, m in ctx.mgr.sent] == ["step-3", "step-4"] and boom == [3, 4]
    msg = ctx.mgr.sent[0][1]
    assert msg["flavor"] == "full" and msg["metadata"] == {"run": "r1"} and msg["step"] == 3
    np.testing.assert_array_equal(msg["payload"]["w"], np.ones(4, np.float32))


def _publish_msg(payload, version="v1"):
    from tensorflowonspark_tpu_torch.continual import payload_digest

    return {"op": "publish", "model": "m", "version": version, "flavor": "full", "step": 1,
            "seq": 0, "src": 0, "serve_args": {}, "metadata": {}, "payload": payload,
            "digest": payload_digest(payload), "nbytes": 32}


def _one_node(server):
    class _Cluster:
        cluster_info = [{"executor_id": 0, "addr": server.addr, "authkey": AUTH}]
        cluster_meta = {"queue_shm": False, "queue_bulk": None}

    return _Cluster()


def test_collector_rejects_corrupt_dedupes_and_flags_config():
    from tensorflowonspark_tpu_torch.continual import PublicationCollector
    from tensorflowonspark_tpu_torch.queues import QueueServer

    server = QueueServer(authkey=AUTH, qnames=("publish",), mode="local", shm=False)
    server.start()
    try:
        col = PublicationCollector(_one_node(server))
        payload = {"layers.0.w": np.arange(8, dtype=np.float32)}
        good = _publish_msg(payload)
        corrupt0, dup0 = _pubs("corrupt"), _pubs("duplicate")
        server.queue_put("publish", dict(good, digest="0" * 64))
        server.queue_put("publish", {"op": "gen", "rid": 1})
        server.queue_put("publish", good)
        server.queue_put("publish", dict(good))
        pubs = col.poll()
        assert [p.version for p in pubs] == ["v1"]
        np.testing.assert_array_equal(pubs[0].payload["layers.0.w"], payload["layers.0.w"])
        assert (_pubs("corrupt"), _pubs("duplicate")) == (corrupt0 + 1, dup0 + 1)
        col.mark_seen("m", "v2")
        server.queue_put("publish", dict(good, version="v2"))
        assert col.poll() == []
        col.close()
    finally:
        server.stop()
    plain = QueueServer(authkey=AUTH, qnames=("input",), mode="local", shm=False)
    plain.start()
    try:
        col2 = PublicationCollector(_one_node(plain))
        plain.queue_put("input", "x")
        with pytest.raises(RuntimeError, match="CONTINUAL_QUEUES"):
            col2.poll()
        col2.close()
    finally:
        plain.stop()


def test_weight_stream_rides_bulk_tier_and_delta_stays_small(monkeypatch):
    import torch

    from tensorflowonspark_tpu_torch import metrics, transport
    from tensorflowonspark_tpu_torch.continual import (CheckpointPublisher, PublicationCollector,
                                                       flatten_params, payload_digest,
                                                       payload_nbytes)
    from tensorflowonspark_tpu_torch.queues import QueueServer

    def rx():
        return metrics.get_registry().counter(
            "tfos_transport_bytes_total", "Bulk-transport payload bytes by tier and direction.",
            labelnames=("tier", "dir")).value(tier="bulk", dir="rx")

    monkeypatch.setenv(transport.MIN_KB_ENV, "1")
    server = QueueServer(authkey=AUTH, qnames=("publish",), mode="local", shm=False)
    server.start()
    base = {"w": torch.zeros(1 << 19, dtype=torch.float64), "b": torch.zeros(1 << 12)}
    full = {"w": torch.arange(1 << 19, dtype=torch.float64), "b": torch.full((1 << 12,), 2.0)}
    base_bytes = payload_nbytes(flatten_params(base))
    ctx = _Ctx(mgr=server)
    try:
        col = PublicationCollector(_one_node(server))
        CheckpointPublisher(ctx, "m").publish(1, full)
        before = rx()
        [pub_full] = col.poll()
        assert col._clients[0].bulk_active and not col._clients[0].shm_active
        assert rx() - before >= base_bytes
        assert pub_full.flavor == "full" and payload_digest(pub_full.payload) == pub_full.digest
        np.testing.assert_array_equal(pub_full.payload["w"], full["w"].numpy())
        CheckpointPublisher(ctx, "m", base=base).publish(2, {"w": base["w"], "b": base["b"] + 1})
        before = rx()
        [pub_delta] = col.poll()
        assert set(pub_delta.payload) == {"b"}
        assert pub_delta.nbytes <= rx() - before < base_bytes // 4
        col.close()
    finally:
        server.stop()


def _publish_crash_once(args, ctx):
    """Attempt 1 publishes a multi-MB candidate and SIGKILLs itself at once
    (the driver's collector races that message); attempt 2 publishes a
    small clean one and exits 0."""
    import signal

    from tensorflowonspark_tpu_torch.continual import CheckpointPublisher

    pub = CheckpointPublisher(ctx, args["model"], timeout=30.0)
    sentinel = os.path.join(ctx.working_dir, "publish-crash-injected")
    if not os.path.exists(sentinel):
        with open(sentinel, "w"):
            pass
        pub.publish(1, {"w": np.full((int(args["big_elems"]),), 1.0, np.float64)})
        os.kill(os.getpid(), signal.SIGKILL)
    pub.publish(2, {"w": np.full((8,), 2.0, np.float64)})


def _publish_and_return(args, ctx):
    """Publish one candidate and return at once: only the node's drain keeps
    the queue server up until the driver's collector has it."""
    from tensorflowonspark_tpu_torch.continual import CheckpointPublisher

    CheckpointPublisher(ctx, "m").publish(3, {"w": np.full((1 << 16,), 3.0, np.float32)})


def _collect_until_exit(cluster, collected, delay=0.0):
    from tensorflowonspark_tpu_torch.continual import PublicationCollector

    col = PublicationCollector(cluster)
    for ver in collected:
        col.mark_seen("atom", ver)
    time.sleep(delay)
    try:
        while True:
            for pub in col.poll():
                collected[pub.version] = pub
            codes = cluster.backend.exitcodes()
            if codes and all(c is not None for c in codes.values()):
                for pub in col.poll():
                    collected[pub.version] = pub
                return set()
            time.sleep(0.05)
    finally:
        col.close()


@pytest.mark.integration
def test_publish_crash_atomicity_no_partial_candidate(tmp_path):
    from tensorflowonspark_tpu_torch.cluster import run_with_recovery
    from tensorflowonspark_tpu_torch.continual import CONTINUAL_QUEUES, payload_digest

    collected: dict = {}
    corrupt0 = _pubs("corrupt")
    run_with_recovery(_publish_crash_once, {"model": "atom", "big_elems": 1 << 20}, 1,
                      max_restarts=2, backoff_base=0.2, queues=CONTINUAL_QUEUES,
                      driver_fn=lambda c: _collect_until_exit(c, collected),
                      worker_env=WORKER_ENV, working_dir=str(tmp_path),
                      reservation_timeout=60, shutdown_timeout=60)
    assert "step-2" in collected, sorted(collected)
    np.testing.assert_array_equal(collected["step-2"].payload["w"], np.full((8,), 2.0))
    for pub in collected.values():
        assert payload_digest(pub.payload) == pub.digest
    if "step-1" in collected:
        np.testing.assert_array_equal(collected["step-1"].payload["w"],
                                      np.full((1 << 20,), 1.0))
    assert _pubs("corrupt") == corrupt0


@pytest.mark.integration
def test_node_drains_its_publish_queue_before_a_clean_exit(tmp_path, monkeypatch):
    """The worker returns right after publishing; the collector starts
    polling a second later and still receives the candidate, because the
    node lingers until its ``publish`` queue is drained.  With no collector
    the drain gives up after ``TFOS_PUBLISH_DRAIN_SECS``."""
    from tensorflowonspark_tpu_torch import node
    from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
    from tensorflowonspark_tpu_torch.continual import CONTINUAL_QUEUES
    from tensorflowonspark_tpu_torch.queues import QueueServer

    cluster = TPUCluster.run(_publish_and_return, {}, 1, input_mode=InputMode.SPARK,
                             queues=CONTINUAL_QUEUES, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path), reservation_timeout=60)
    collected: dict = {}
    try:
        _collect_until_exit(cluster, collected, delay=1.0)
    finally:
        cluster.shutdown(timeout=60)
    assert list(collected) == ["step-3"]
    np.testing.assert_array_equal(collected["step-3"].payload["w"], 3.0)

    server = QueueServer(authkey=AUTH, qnames=("publish",), mode="local", shm=False)
    server.queue_put("publish", {"op": "publish"})
    monkeypatch.setenv("TFOS_PUBLISH_DRAIN_SECS", "0.3")
    t0 = time.monotonic()
    node._drain_publish_queue(server, 0)
    assert 0.25 <= time.monotonic() - t0 < 5 and server.queues["publish"].qsize() == 1
    node._drain_publish_queue(QueueServer(authkey=AUTH, qnames=("input",), mode="local"), 0)


# ------------------------------------------------------------------ the pipeline

class _FakeGridSearch:
    """Offline-gate stand-in: the real one boots a batch cluster; this pins
    the pipeline's wiring (the trial params carry the candidate, the verdict
    lands in ``record_eval``) over results keyed off the candidate's
    ``quality`` serve arg."""

    instances: list = []

    def __init__(self, manifest, output_dir, predict_fn, param_grid, **kw):
        self.manifest, self.param_grid, self.ran = manifest, param_grid, None
        _FakeGridSearch.instances.append(self)

    def run(self, num_workers, **kw):
        self.ran = num_workers
        return self

    def trial_results(self, trial_id, decode=False):
        cand = self.param_grid[0]["continual_candidate"]
        return [float(cand["serve_args"].get("quality", 1.0))] * 4


_POLICY = dict(steps=(50, 100), bake_secs=0.4, min_samples=3, max_e2e_ratio=None)
_ROLLBACK = dict(steps=(50, 100), bake_secs=0.5, min_samples=1, max_error_rate=0.2,
                 max_e2e_ratio=None)


def _world(pkg, tmp_path, monkeypatch):
    from tests.test_rollout import _builder, _ModelWorld
    from tests.test_torch_rollout import _scheduler, _tier

    serving = importlib.import_module(f"{pkg}.serving")
    journal_mod = importlib.import_module(f"{pkg}.serving.journal")
    monkeypatch.setattr(f"{pkg}.batch.gridsearch.GridSearch", _FakeGridSearch)
    _FakeGridSearch.instances = []
    world = _ModelWorld(2)
    journal = journal_mod.ControlPlaneJournal(str(tmp_path / f"{pkg}-cp.jsonl"))
    reg = serving.ModelRegistry()
    reg.bind_journal(journal)
    reg.register("m", "v1", _builder, serve_args={"salt": 0})
    reg.record_eval("m", "v1", {}, passed=True)
    s = _scheduler(pkg, world, model=("m", "v1"), journal=journal).start()
    return world, reg, s, _tier(pkg, world, s, reg)


def _eval_spec(pkg, tmp_path):
    return _continual(pkg).OfflineEval(
        manifest="unused-manifest", output_dir=str(tmp_path / f"{pkg}-eval"),
        predict_fn=lambda model, records, tp: records,
        scorer=lambda rs: ({"quality": float(np.mean(rs)), "n": len(rs)},
                           float(np.mean(rs)) >= 0.5), num_workers=1)


def _adapter_pub(pkg, version, step, quality=1.0, model="m", **serve):
    C = _continual(pkg)
    payload = {"w": np.full((2,), 0.25 * step, np.float32)}
    return C.Publication(model=model, version=version, flavor="adapter", step=step,
                         payload=payload, serve_args={"salt": 9, "quality": quality, **serve},
                         metadata={"run": "r1"}, digest=C.payload_digest(payload), src=0,
                         seq=step)


def _traffic(s, stop):
    from tests.test_rollout import _collect

    def load():
        k = 0
        while not stop.is_set():
            k += 1
            try:
                _collect(s.submit(np.asarray([k % 11 + 1], np.int32), 3, model="m"), timeout=5)
            except Exception:
                return
            time.sleep(0.01)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    return t


def _records(pkg, tmp_path):
    """The journal's continual and rollout records, as the tier wrote them."""
    with open(tmp_path / f"{pkg}-cp.jsonl") as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["kind"], r.get("version"), r.get("stage") or r.get("outcome"))
            for r in recs if r["kind"].startswith(("continual_", "rollout_started",
                                                    "rollout_done"))]


@pytest.mark.parametrize("case", ["promoted", "rejected_offline", "rolled_back"])
def test_pipeline_outcomes_journal_what_the_jax_pipeline_journals(case, tmp_path, monkeypatch):
    runs = {}
    for pkg in PACKAGES:
        world, reg, s, tier = _world(pkg, tmp_path, monkeypatch)
        serving = importlib.import_module(f"{pkg}.serving")
        policy = serving.RolloutPolicy(**(_ROLLBACK if case == "rolled_back" else _POLICY))
        pipe = _continual(pkg).ContinualPipeline(tier, "m", base_builder=reg.version(
            "m", "v1").builder, eval_spec=_eval_spec(pkg, tmp_path), policy=policy)
        pub = _adapter_pub(pkg, "step-2", 2, quality=0.0 if case == "rejected_offline" else 1.0,
                           **({"fail": True} if case == "rolled_back" else {}))
        before = _versions(case) if pkg == PACKAGES[1] else None
        stop = threading.Event()
        t = _traffic(s, stop)
        try:
            out = pipe.process(pub)
            dup = pipe.process(_adapter_pub(pkg, "step-2", 2))
            foreign = pipe.process(_adapter_pub(pkg, "x", 9, model="other"))
        finally:
            stop.set()
            t.join(5)
            s.stop()
        swaps = [i for _, i in world.control if i.get("op") == "model"]
        runs[pkg] = {"out": (out, dup, foreign), "records": _records(pkg, tmp_path),
                     "versions": s.model_versions("m"),
                     "states": {v: reg.version("m", v).state for v in ("v1", "step-2")},
                     "eval": reg.version("m", "step-2").eval_passed, "swapped": bool(swaps)}
        if pkg == PACKAGES[1]:
            assert _versions(case) == before + 1
            [gs] = _FakeGridSearch.instances
            cand = gs.param_grid[0]["continual_candidate"]
            assert gs.manifest == "unused-manifest" and gs.ran == 1
            assert cand["version"] == "step-2" and cand["flavor"] == "adapter"
            back = pipe.load_publication("step-2")
            assert back.digest == pub.digest and back.serve_args == pub.serve_args
    ref, port = runs[PACKAGES[0]], runs[PACKAGES[1]]
    assert port == ref
    assert port["out"] == (case, None, None)
    assert port["records"][0] == ("continual_candidate", "step-2", None)
    assert port["records"][-1] == ("continual_done", "step-2", case)
    if case == "rejected_offline":
        assert not port["swapped"] and port["versions"] == {"v1": [0, 1]}
    elif case == "promoted":
        assert port["versions"] == {"step-2": [0, 1]}


def test_payload_store_round_trips_state_dict_names(tmp_path, monkeypatch):
    from tensorflowonspark_tpu_torch.continual import Publication, payload_digest

    world, reg, s, tier = _world(PACKAGES[1], tmp_path, monkeypatch)
    s.stop()
    C = _continual(PACKAGES[1])
    pipe = C.ContinualPipeline(tier, "m", base_builder=reg.version("m", "v1").builder,
                               eval_spec=_eval_spec(PACKAGES[1], tmp_path))
    assert pipe.store_dir == str(tmp_path / "continual_store")
    payload = {"layers.11.attn.query.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
               "ln_f.bias": np.ones(3, np.float32), "tok_emb.weight": np.zeros((1, 3))}
    pub = Publication(model="m", version="step-4", flavor="adapter", step=4, payload=payload,
                      serve_args={"salt": 1}, metadata={"run": "r"},
                      digest=payload_digest(payload), src=0, seq=4)
    pipe._store(pub)
    back = pipe.load_publication("step-4")
    assert back.digest == pub.digest and set(back.payload) == set(payload)
    for name, arr in payload.items():
        assert back.payload[name].dtype == arr.dtype
        np.testing.assert_array_equal(back.payload[name], arr)
    # a stored payload whose bytes changed fails its digest and is discarded
    pub.payload = {**payload, "ln_f.bias": np.full(3, 2.0, np.float32)}
    pipe._store(pub)
    assert pipe.load_publication("step-4") is None and pipe.load_publication("nope") is None


def _journal_state(records):
    from tensorflowonspark_tpu_torch.serving.journal import JournalState

    return JournalState.from_records(records)


def test_resume_finalizes_a_concluded_rollout_without_retraffic(tmp_path, monkeypatch):
    from tests.test_rollout import _builder

    world, reg, s, tier = _world(PACKAGES[1], tmp_path, monkeypatch)
    reg.register("m", "step-2", base=_builder, adapter={"w": np.ones((2,), np.float32)},
                 serve_args={"salt": 9})
    reg.record_eval("m", "step-2", {"quality": 1.0}, passed=True)
    reg.mark("m", "step-2", "serving")
    reg.mark("m", "v1", "retired")
    state = _journal_state([
        dict(kind="continual_candidate", model="m", version="step-2", flavor="adapter",
             step=2, digest="d", src=0),
        dict(kind="continual_stage", model="m", version="step-2", stage="rollout"),
        dict(kind="rollout_started", model="m", version="step-2", incumbent="v1",
             steps=[50, 100]),
        dict(kind="rollout_step", model="m", version="step-2", percent=50),
        dict(kind="rollout_step_done", model="m", version="step-2", percent=50),
        dict(kind="rollout_done", model="m", version="step-2", outcome="promoted")])
    pipe = _continual(PACKAGES[1]).ContinualPipeline(tier, "m", base_builder=_builder)
    promoted0 = _versions("promoted")
    try:
        assert pipe.resume(state) == {("m", "step-2"): "promoted"}
    finally:
        s.stop()
    assert _versions("promoted") == promoted0 + 1
    assert [i for _, i in world.control if i.get("op") == "model"] == []
    assert _records(PACKAGES[1], tmp_path)[-1] == ("continual_done", "step-2", "promoted")
    closed = _journal_state([
        dict(kind="continual_candidate", model="m", version="step-2", flavor="adapter",
             step=2, digest="d", src=0),
        dict(kind="continual_done", model="m", version="step-2", outcome="promoted")])
    assert closed.open_candidates() == {} and pipe.resume(closed) == {}


@pytest.mark.parametrize("stage", ["offline_eval", "rollout"])
def test_resume_rehydrates_a_stored_candidate_and_skips_a_lost_one(stage, tmp_path,
                                                                   monkeypatch):
    """Killed mid-``offline_eval``, a stored candidate is re-scored and
    rolled out; killed mid-``rollout`` with its verdict journaled, the
    verdict is restored (the rollout gate refuses unvetted versions) and
    the rollout runs; a candidate whose payload never reached the store
    waits for its re-publication."""
    world, reg, s, tier = _world(PACKAGES[1], tmp_path, monkeypatch)
    C = _continual(PACKAGES[1])
    pipe = C.ContinualPipeline(tier, "m", base_builder=reg.version("m", "v1").builder,
                               eval_spec=_eval_spec(PACKAGES[1], tmp_path),
                               policy=importlib.import_module(
                                   f"{PACKAGES[1]}.serving").RolloutPolicy(**_POLICY))
    pub = _adapter_pub(PACKAGES[1], "step-7", 7)
    pipe._store(pub)
    records = [dict(kind="continual_candidate", model="m", version="step-7",
                    flavor="adapter", step=7, digest=pub.digest, src=0),
               dict(kind="continual_candidate", model="m", version="step-8",
                    flavor="adapter", step=8, digest="lost", src=0)]
    if stage == "rollout":
        records.append(dict(kind="registry_eval", model="m", version="step-7", passed=True,
                            metrics={"quality": 1.0}))
    records.append(dict(kind="continual_stage", model="m", version="step-7", stage=stage))
    stop = threading.Event()
    t = _traffic(s, stop)
    try:
        results = pipe.resume(_journal_state(records))
    finally:
        stop.set()
        t.join(5)
        s.stop()
    assert results == {("m", "step-7"): "promoted"}
    entry = reg.version("m", "step-7")
    assert entry.state == "serving" and entry.eval_passed is True
    assert entry.eval_metrics["quality"] == 1.0
    assert len(_FakeGridSearch.instances) == (1 if stage == "offline_eval" else 0)
    assert "step-8" not in reg.versions("m")


# ------------------------------------------------------ the GPT eval predict_fn

KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
          max_position_embeddings=32)
EVAL_RTOL = 1e-5


@functools.cache
def _flax_gpt_params():
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from tensorflowonspark_tpu.models import gpt as J

    jc = J.GPTConfig(**KW, dtype=jnp.float32)
    shapes = meta.unbox(jax.eval_shape(J.GPT(jc).init, jax.random.key(0),
                                       jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _base_builder(args):
    import torch

    from tensorflowonspark_tpu_torch.models import gpt as P

    pc = P.GPTConfig(**KW, dtype=torch.float32)
    return pc, P.params_from_flax(_flax_gpt_params(), pc)


def test_gpt_eval_predict_matches_the_jax_loss_under_a_delta(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from tensorflowonspark_tpu.models import gpt as J
    from tensorflowonspark_tpu.ops import flash_attention
    from tensorflowonspark_tpu.serving import apply_adapter as japply
    from tensorflowonspark_tpu_torch import gpt_continual as gc
    from tensorflowonspark_tpu_torch.models import gpt as P

    params = _flax_gpt_params()
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(2)
    delta = {"/".join(str(getattr(k, "key", k)) for k in path):
             (0.05 * rng.standard_normal(np.shape(leaf))).astype(np.float32)
             for path, leaf in flat if "layer_1" in str(path) or "ln_f" in str(path)}
    pc = _base_builder({})[0]
    rows = gc.plus_one_rows(6, 16, KW["vocab_size"], 4)
    threads = torch.get_num_threads()
    try:
        model = gc.eval_model_builder({"continual_base_builder": _base_builder,
                                       "device": "cpu", "compute_dtype": "float32",
                                       "stats_dir": str(tmp_path)})
    finally:
        torch.set_num_threads(threads)
    cand = {"continual_candidate": {"model": "gpt", "version": "c1", "flavor": "adapter",
                                    "payload": P.adapter_from_flax(delta, pc),
                                    "serve_args": {}}}
    got = gc.row_losses(gc.eval_predict(model, rows[:4], cand)
                        + gc.eval_predict(model, rows[4:], cand))
    base_records = gc.eval_predict(model, rows, None)
    base_loss = gc.row_losses(base_records)

    jc = J.GPTConfig(**KW, dtype=jnp.float32, attention_fn=functools.partial(
        flash_attention, block_q=8, block_k=8, interpret=True))

    @jax.jit
    def row_loss(p, ids):
        logits = J.GPT(jc).apply({"params": p}, ids)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], ids[:, 1:]).mean(axis=1)

    want = np.asarray(row_loss(japply(params, delta), jnp.asarray(rows)))
    np.testing.assert_allclose(got, want, rtol=EVAL_RTOL)
    np.testing.assert_allclose(base_loss, np.asarray(row_loss(params, jnp.asarray(rows))),
                               rtol=EVAL_RTOL)
    assert not np.allclose(got, base_loss, rtol=100 * EVAL_RTOL)
    [stats] = gc.read_stats(str(tmp_path), "eval_stats")
    assert stats["batches"] == 3 and stats["launches"] == dict.fromkeys(gc.KERNELS, 0)
    assert len(stats["batch_ms"]) == 3
    scorer = gc.loss_scorer(float(np.mean(base_loss)), 0.0)
    metrics, passed = scorer(base_records)
    assert passed and metrics["rows"] == 6 and metrics["mean_loss"] == np.mean(base_loss)
