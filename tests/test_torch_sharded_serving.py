"""Mesh-sharded serving in the port (``serving/sharded.py``, the batcher
over tp shards, ``ops.shard_quantized``) against the JAX package, on the CPU.

- **the batcher over tp 2** — one 2-rank gloo world
  (``tests/torch_model_parallel_worker.py`` suite ``serving``) runs every
  case while the test computes the JAX side: the counterparts of
  ``tests/test_serving.py``'s plain (``:231``), speculative (``:587``) and
  paged-with-a-prefix-hit (``:1059``) tp cases, ``tests/test_spec_draft.py``'s
  draft (``:214``), ``__graft_entry__.py``'s decode blocks (``:598-616``)
  and ``tests/test_quant.py``'s int8 tp decode (``:80-120``).  Each case's
  tokens on both ranks equal the JAX package's ``greedy_generate`` on the
  same flax weights (float32, the JAX tests' widths: vocab 64, hidden 32,
  2 layers, 4 heads, ``rope``) exactly, and the port's own tp
  ``greedy_generate`` in the same world;
- **gang scheduler units** on the fake world (``tests/torch_serving_world.py``),
  the counterparts of ``tests/test_serving_cluster.py:613-706``, and the
  leader's step protocol (a member whose digest differs is a lost shard);
- **end to end** — ``ServingCluster.run(builder, 2, mesh={"tp": 2})`` on
  the CPU with ``TFOS_CHAOS`` ``kill node=1 at_step=4`` (a member of gang
  0): every stream equals the JAX package's ``greedy_generate``, the gang
  dies once naming both shards, and the tier shuts down cleanly;
- the refusals: a gang with disaggregated pools, a gloo tp batcher asked
  for a capture cache, a shard count that does not divide.
"""

import json
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.serving import GangShardLost, GangSpec
from tensorflowonspark_tpu_torch.serving.sharded import GangBarrier, gang_of, token_digest
from tests.torch_serving_world import _collect, _fake_tokens, _FakeWorld, _scheduler
from tests.torch_world import run_world

#: the JAX tp tests' model, float32
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=64, pos_encoding="rope")


def _requests():
    """The JAX tests' requests: three staggered prompts (``:231``), a
    repetitive one for speculation (``:587``, ``spec_draft.py:214``), two on
    one 16-token prefix served one after the other (``:1059``; their tails
    of one length here, so the JAX oracle compiles once), and two 4-token
    prompts of 6 tokens each for int8 (``tests/test_quant.py:80``)."""
    rng = np.random.default_rng(4)
    plain = [(rng.integers(0, 64, (t,)).astype(np.int32), n) for t, n in ((5, 8), (3, 11), (7, 5))]
    rep = [(np.tile(np.asarray([3, 8, 13], np.int32), 4), 12)]
    rng = np.random.default_rng(46)
    pre = rng.integers(0, 64, (16,)).astype(np.int32)
    paged = [(np.concatenate([pre, rng.integers(0, 64, (k,)).astype(np.int32)]), n)
             for k, n in ((3, 8), (3, 6))]
    int8 = [(rng.integers(0, 64, (4,)).astype(np.int32), 6) for _ in range(2)]
    return {"plain": plain, "rep": rep, "paged": paged, "int8": int8}


def _jax_greedy(cfg, params, reqs):
    """The JAX package's ``greedy_generate`` continuation of each request,
    one jitted call a prompt length (the longest budget, cut per request:
    a greedy rollout's prefix is the shorter rollout)."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import greedy_generate

    greedy = jax.jit(greedy_generate, static_argnums=(0, 3))
    out = [None] * len(reqs)
    for t in sorted({len(p) for p, _ in reqs}):
        idx = [i for i, (p, _) in enumerate(reqs) if len(p) == t]
        n = max(reqs[i][1] for i in idx)
        got = np.asarray(greedy(cfg, params, jnp.asarray(np.stack([reqs[i][0] for i in idx])), n))
        for row, i in zip(got, idx):
            out[i] = row[t:t + reqs[i][1]]
    return out


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import GPT, GPTConfig
    from tensorflowonspark_tpu.ops import quantize_params
    from tensorflowonspark_tpu_torch.models.gpt import params_from_flax

    cfg = GPTConfig(**TINY, dtype=jnp.float32)
    flax_params = jax.tree.map(np.asarray, jax.jit(GPT(cfg).init)(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32))["params"])
    reqs = _requests()
    sd = params_from_flax(flax_params, cfg)
    cases = {"serving": {"cfg": TINY, "params": {k: v.numpy() for k, v in sd.items()}, **reqs}}

    def jax_side():
        want = {k: _jax_greedy(cfg, flax_params, v) for k, v in reqs.items() if k != "int8"}
        want["int8"] = _jax_greedy(cfg, quantize_params(flax_params), reqs["int8"])
        return want

    want, got = run_world("serving", cases, jax_side, tmp_path_factory.mktemp("tp_serving"),
                          world=2)
    return want, got


#: each case's requests in the JAX side's terms
CASES = {"plain": "plain", "speculative": "rep", "paged": "paged", "draft": "rep",
         "block": "plain", "int8": "int8"}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_batcher_equals_jax_greedy_and_the_tp_greedy(tp_world, case):
    """On both ranks, the tp 2 batcher's tokens equal the JAX package's
    ``greedy_generate`` on the same flax weights and the port's tp
    ``greedy_generate`` over the same shards, token for token; speculation
    accepts, the second paged request hits the prefix, decode blocks take
    fewer dispatches than steps."""
    want, got = tp_world
    for rank in got:
        r = rank[case]
        assert len(r["tokens"]) == len(want[CASES[case]])
        for toks, tp_greedy, jax_toks in zip(r["tokens"], r["tp_greedy"], want[CASES[case]]):
            np.testing.assert_array_equal(toks, jax_toks)
            np.testing.assert_array_equal(toks, tp_greedy)
        if case in ("speculative", "draft"):
            assert r["spec_accepted"] > 0
        if case == "paged":
            assert r["prefix_hits"] >= 1
        if case == "block":
            assert r["decode_dispatches"] < r["decode_steps"]
            plain = rank["plain"]["tokens"]
            assert all(np.array_equal(a, b) for a, b in zip(r["tokens"], plain))


def test_tp_shards_are_cut_in_the_port_layout(tp_world):
    """Each rank holds half the heads, units and vocab rows, in
    ``nn.Linear``'s ``[out, in]`` layout; biases, norms whole; int8 ``q``
    cut as its float weight."""
    _, got = tp_world
    shapes, q = got[0]["shapes"], got[0]["int8_q_shapes"]
    assert shapes["tok_emb.weight"] == (32, 32)
    assert shapes["layers.0.attn.query.weight"] == (16, 32)
    assert shapes["layers.0.attn.out.weight"] == (32, 16)
    assert shapes["layers.0.mlp_up.weight"] == (32, 32)
    assert shapes["layers.0.mlp_down.weight"] == (32, 32)
    assert shapes["layers.0.attn.query.bias"] == (32,) and shapes["ln_f.weight"] == (32,)
    assert q["layers.1.attn.key.weight"] == (16, 32) and q["layers.1.mlp_down.weight"] == (32, 32)


def test_tp_batcher_refuses_a_capture_cache_and_heads_that_do_not_divide(tp_world):
    """Over a gloo tp group the batcher refuses ``aot_cache`` (a CUDA graph
    cannot capture a gloo collective) rather than dropping it, and a GPT
    whose K/V heads do not divide over tp raises."""
    _, got = tp_world
    errors = got[0]["errors"]
    assert "gloo collective" in errors["aot_cache"]
    assert "num_kv_heads (1) does not divide over tp=2" in errors["kv_heads"]


# ------------------------------------------------- sharded gang units

def test_gang_spec_and_gang_of_are_the_jax_package_s():
    spec = GangSpec({"tp": 2})
    assert (spec.devices, spec.gang_size, spec.describe()) == (2, 2, "mesh[tp=2] x 2 proc(s)")
    assert gang_of(5, 2) == (4, 1) and gang_of(4, 2) == (4, 0)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        GangSpec({"xx": 2})
    with pytest.raises(ValueError, match="invalid size"):
        GangSpec({"tp": 0})


def test_gang_registration_and_capacity_accounting():
    """gang_size=2 over 4 workers registers TWO routable endpoints
    (leaders 0 and 2, members 1 and 3) with device-weighted capacity."""
    world = _FakeWorld(4)
    s = _scheduler(world, gang_size=2).start()
    try:
        assert set(s.replicas) == {0, 2}
        assert s.gang_members(0) == (0, 1) and s.gang_members(2) == (2, 3)
        assert s.resolve_gang(1) == 0 and s.resolve_gang(3) == 2
        assert s.resolve_gang(2) == 2        # leaders resolve to selves
        m = s.metrics()
        assert m["gang_size"] == 2 and m["capacity_devices"] == 4
        assert m["replicas"][0]["weight"] == 2
        assert m["replicas"][0]["members"] == [1]
        # traffic routes over LEADERS only
        reqs = [s.submit(np.arange(1, 3 + k, dtype=np.int32), 4)
                for k in range(6)]
        for req in reqs:
            _, err = _collect(req)
            assert err is None
        m = s.metrics()
        assert all(m["replicas"][eid]["served"] > 0 for eid in (0, 2))
        # live gang add registers leader + member as one endpoint
        info4 = world.add_replica()
        world.add_replica()                  # member slot (eid 5)
        s.add_replica(info4, members=(5,))
        assert s.alive_replicas() == {0, 2, 4}
        assert s.resolve_gang(5) == 4
        assert s.metrics()["capacity_devices"] == 6
        # a gang endpoint needs exactly gang_size-1 members, in its block
        with pytest.raises(ValueError, match="gang"):
            s.add_replica({"executor_id": 6, "addr": ("x", 0),
                           "authkey": b"x"}, members=())
        with pytest.raises(ValueError, match="gang_size-aligned"):
            s.add_replica({"executor_id": 7, "addr": ("x", 0),
                           "authkey": b"x"}, members=(8,))
    finally:
        s.stop()


def test_gang_misaligned_blocks_rejected():
    world = _FakeWorld(3)
    with pytest.raises(ValueError, match="not a multiple of gang_size"):
        _scheduler(world, gang_size=2)


def test_gang_member_death_fails_whole_gang_over_once():
    """SIGKILL one NON-LEADER shard mid-stream: the whole gang classifies
    dead, its in-flight request requeues ONCE to the surviving gang, and
    the client stream is the exact oracle sequence."""
    from tensorflowonspark_tpu_torch.health import ClusterFailure

    world = _FakeWorld(4, token_delay=0.05)
    s = _scheduler(world, gang_size=2,
                   slots_per_replica=1, overcommit=1).start()
    try:
        p = np.asarray([3, 5], np.int32)
        req = s.submit(p, 8)
        while not req.tokens:
            time.sleep(0.01)
        victim_leader = req.replica
        member = victim_leader + 1
        world.kill(member)                  # the member, NOT the leader
        s.on_cluster_failure(ClusterFailure(
            "crash", f"crash: worker {member} exit=-9",
            failed_workers=(member,)))
        # the leader's own death, observed later, changes nothing
        s.on_cluster_failure(ClusterFailure(
            "crash", f"crash: worker {victim_leader} exit=1",
            failed_workers=(victim_leader,)))
        toks, err = _collect(req, timeout=15)
        assert err is None
        assert toks == _fake_tokens(p, 8), "gang failover stream not exact"
        m = s.metrics()
        assert m["requeued"] == 1 and m["completed"] == 1
        assert not m["replicas"][victim_leader]["alive"]
        assert s.dead_replicas() == {victim_leader, member}
        assert m["capacity_devices"] == 2
    finally:
        s.stop()


def test_gang_member_exit_detected_by_supervisor():
    """The backend-exitcode supervision path alone (no monitor event)
    also resolves a member's death to the whole gang."""
    world = _FakeWorld(4)
    s = _scheduler(world, gang_size=2, poll_interval=0.05).start()
    try:
        world.kill(3)                       # member of gang 2
        deadline = time.monotonic() + 5
        while s.alive_replicas() != {0} and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.alive_replicas() == {0}
        assert s.dead_replicas() == {2, 3}
    finally:
        s.stop()


class _Member:
    """A member's queue client for :class:`GangBarrier`: takes the posted
    descriptors, answers each with an ack carrying ``digest``."""

    def __init__(self, digest):
        self.digest, self.posted = digest, []

    def put(self, qname, item, timeout=None):
        self.posted.append(item)

    def get(self, qname, timeout=None):
        return {"op": "gang", "event": "ack", "seq": self.posted[-1]["seq"],
                "digest": self.digest(self.posted[-1])}

    def close(self):
        pass


class _Batcher:
    def step(self):
        return []


def test_gang_barrier_posts_the_descriptor_and_holds_the_digest():
    """The leader posts each step's mirrored requests before it steps and
    accepts an ack whose digest is its own tokens'; a member whose tokens
    differ is a lost shard."""
    deltas = {3: [7, 8]}
    b = GangBarrier([{"executor_id": 1}], step_timeout=1.0)
    member = b._clients[1] = _Member(lambda desc: token_digest(deltas))
    b.mirror({"op": "gen", "rid": 9, "prompt": [1, 2], "max_new_tokens": 4, "seed": 0})
    assert b.step(_Batcher(), 1) == []
    assert member.posted[-1] == {"op": "gang", "event": "step", "seq": 1, "items": [
        {"prompt": [1, 2], "max_new_tokens": 4, "seed": 0}]}
    b.collect(1, 0, deltas)
    b.step(_Batcher(), 2)
    assert member.posted[-1]["items"] == []         # each item goes once
    member.digest = lambda desc: token_digest({3: [7, 9]})
    with pytest.raises(GangShardLost, match="diverged"):
        b.collect(2, 0, deltas)
    with pytest.raises(GangShardLost, match="cannot|mirrors only"):
        b.refuse("clone")


# ------------------------------------------------------------- refusals

def test_gang_refusals_raise_before_any_worker_boots():
    from tensorflowonspark_tpu_torch.examples.gpt.online_serving import model_builder
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    with pytest.raises(NotImplementedError, match="ROADMAP A6 part 2, item 8"):
        ServingCluster.run(model_builder, 2, mesh={"tp": 2},
                           disagg={"prefill": 1, "decode": 1},
                           batcher_kwargs={"kv_page_tokens": 16})
    with pytest.raises(NotImplementedError, match="tp only"):
        ServingCluster.run(model_builder, 1, mesh={"pp": 2})
    with pytest.raises(ValueError, match="one process a device"):
        ServingCluster.run(model_builder, 1, mesh={"tp": 2}, gang_size=1)
    with pytest.raises(ValueError, match="eagerly"):
        ServingCluster.run(model_builder, 1, mesh={"tp": 2}, aot_cache=True)
    with pytest.raises(ValueError, match="need mesh="):
        ServingCluster.run(model_builder, 1, gang_size=2)


# ---------------------------------------------------------- end to end, CPU

def test_tp_gangs_with_a_killed_member_equal_jax_greedy(tmp_path):
    """``ServingCluster.run(builder, 2, mesh={"tp": 2})`` on the CPU: two
    gangs of two processes serve 8 streamed requests from 3 clients;
    ``TFOS_CHAOS`` SIGKILLs executor 1 (gang 0's member) at its 4th step.
    Every stream equals the JAX package's ``greedy_generate`` on the flax
    weights, at least one request was requeued, the tier lost executors
    0 and 1 and logged one ``replica_dead`` naming both shards, and the
    tier shuts down cleanly."""
    import jax
    import jax.numpy as jnp
    import torch

    from tensorflowonspark_tpu.models import GPT, GPTConfig
    from tensorflowonspark_tpu_torch.examples.gpt import online_serving
    from tensorflowonspark_tpu_torch.models.gpt import params_from_flax

    jcfg = GPTConfig(**{**TINY, "vocab_size": 84}, dtype=jnp.float32)
    flax_params = jax.tree.map(np.asarray, jax.jit(GPT(jcfg).init)(
        jax.random.key(3), jnp.ones((1, 4), jnp.int32))["params"])
    torch.save(params_from_flax(flax_params, jcfg), tmp_path / "weights.pt")
    args = {"vocab": 84, "hidden": 32, "num_layers": 2, "num_heads": 4,
            "max_position_embeddings": 64, "weights": str(tmp_path / "weights.pt")}
    rng = np.random.default_rng(5)
    shapes = [(5, 10), (9, 10)] * 4
    reqs = [(rng.integers(0, 84, (t,)).tolist(), n) for t, n in shapes]
    out = online_serving.run(args, reqs, replicas=2, slots=2, clients=3, kill_at_step=4,
                             kill_node=1, mesh={"tp": 2}, device="cpu",
                             working_dir=str(tmp_path / "tier"),
                             worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""},
                             timeout=120)
    want = _jax_greedy(jcfg, flax_params, [(np.asarray(p, np.int32), n) for p, n in reqs])
    for i, w in enumerate(want):
        assert out["results"][i] == w.tolist(), f"request {i} diverged"
    m = out["metrics"]
    assert m["completed"] == len(reqs) and m["failed"] == 0 and m["requeued"] >= 1
    assert m["gang_size"] == 2 and m["replicas"][2]["members"] == [3]
    assert out["dead"] == {0, 1}
    events = [json.loads(line) for line in
              (tmp_path / "tier" / "serving_events.jsonl").read_text().splitlines()]
    dead = [e for e in events if e["kind"] == "replica_dead"]
    assert len(dead) == 1 and dead[0]["shards"] == [0, 1], dead
