"""The port's mesh, sharding, strategies and long-context ops against the
JAX package's.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``; the port's side runs once for the whole file, in
one gloo group of 4 CPU processes (``tests/torch_parallel_worker.py``),
over the same inputs and weights, drawn here from a seed with numpy.

Tolerances (float32 on both sides, other summation orders): attention
outputs and q/k/v gradients ``atol=rtol=2e-5`` (the reference's own
ulysses-vs-dense bound), the tp×sp transformer stage ``2e-5`` on outputs
and ``1e-4`` on gradients, the strategies' losses and parameters
``rtol=1e-5, atol=1e-6`` (the reference's single-device oracle bound).
"""

import functools
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu import compat
from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu.parallel import FSDPStrategy as JaxFSDP
from tensorflowonspark_tpu.parallel import MeshStrategy as JaxMeshStrategy
from tensorflowonspark_tpu.parallel import PartitionRules as JaxRules
from tensorflowonspark_tpu.parallel import make_hybrid_mesh as jax_hybrid
from tensorflowonspark_tpu.parallel import make_mesh as jax_make_mesh
from tensorflowonspark_tpu.parallel import mesh as jax_mesh_mod
from tensorflowonspark_tpu.parallel import ring_self_attention as jax_ring
from tensorflowonspark_tpu.parallel import ulysses_self_attention as jax_ulysses
from tensorflowonspark_tpu.parallel.transformer import \
    make_transformer_stage as jax_stage
from tensorflowonspark_tpu_torch.parallel import mesh as port_mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding as port_sh
from tensorflowonspark_tpu_torch.parallel.ring_attention import (ring_attention,
                                                                 reference_attention)
from tensorflowonspark_tpu_torch.parallel.ulysses import ulysses_attention
from tensorflowonspark_tpu_torch.util import get_free_port

pytestmark = pytest.mark.integration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, T, H, D = 2, 16, 4, 8
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
STAGE = {"hidden": 16, "heads": 4, "ffn": 32, "B": 2, "T": 8}
ATTENTION_CASES = [f"{impl}-{mesh}-{variant}" for impl in ("ring", "ulysses")
                   for mesh in ("dp2_sp2", "sp4") for variant in ("causal", "mask")]


def _jax_mesh(name):
    from tensorflowonspark_tpu.parallel.mesh import MeshSpec

    sizes = {"dp2_sp2": dict(dp=2, sp=2), "sp4": dict(dp=1, sp=4),
             "tp2_sp2": dict(dp=1, sp=2, tp=2)}[name]
    return jax_make_mesh(MeshSpec(**sizes), devices=jax.devices()[:WORLD])


def _qkv(seed, causal):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((B, T, H, D), dtype=np.float32) for _ in range(4))
    mask = None
    if not causal:
        lens = np.array([12, 9])                  # keys past these are padding
        mask = np.arange(T)[None, :] < lens[:, None]
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask, "causal": causal}


def _jax_attention(fn, mesh, case):
    mask = None if case["mask"] is None else jnp.asarray(case["mask"])

    def loss(q, k, v):
        out = fn(mesh, q, k, v, mask=mask, causal=case["causal"])
        return jnp.sum(out * case["cot"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[n]) for n in "qkv"))
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]),
            "dv": np.asarray(grads[2])}


def _jax_stage(impl, case):
    from jax.sharding import PartitionSpec as JP

    stage_fn, _, specs = jax_stage(STAGE["hidden"], STAGE["heads"], STAGE["ffn"], tp=2,
                                   causal=True, sp_impl=impl)
    fn = compat.shard_map(stage_fn, mesh=_jax_mesh("tp2_sp2"),
                          in_specs=(specs, JP(None, "sp", None)),
                          out_specs=JP(None, "sp", None))

    def loss(params, x):
        out = fn(params, x)
        return jnp.sum(out * case["cot"]), out

    params = jax.tree.map(jnp.asarray, case["params"])
    (_, out), (dp, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(case["x"]))
    return {"out": np.asarray(out), "dx": np.asarray(dx),
            "grads": jax.tree.map(np.asarray, dp)}


def _jax_train(strategy, params, tx, loss_fn, batch, steps):
    state = strategy.init_state(lambda: jax.tree.map(jnp.asarray, params), tx)
    step = strategy.build_train_step(loss_fn)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, strategy.shard_batch(batch))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


def _cases():
    """The cases' inputs (the transformer's and the FSDP model's weights from
    the JAX package's initialisers)."""
    cases = {"attention": {key: _qkv(i, key.split("-")[2] == "causal")
                           for i, key in enumerate(ATTENTION_CASES)}}
    cases["window"] = {**_qkv(100, True), "window": 5}
    rng = np.random.default_rng(7)
    _, init_fn, _ = jax_stage(STAGE["hidden"], STAGE["heads"], STAGE["ffn"], tp=2)
    cases["transformer"] = {
        **{k: STAGE[k] for k in ("hidden", "heads", "ffn")},
        "params": jax.tree.map(np.asarray, init_fn(jax.random.key(0))),
        "x": rng.standard_normal((STAGE["B"], STAGE["T"], STAGE["hidden"]), dtype=np.float32),
        "cot": rng.standard_normal((STAGE["B"], STAGE["T"], STAGE["hidden"]),
                                   dtype=np.float32)}
    x = rng.standard_normal((16, 4), dtype=np.float32)
    cases["hybrid"] = {"batch": {"x": x, "y": rng.standard_normal(16, dtype=np.float32)},
                       "lr": 0.1, "steps": 3}
    params = jax.tree.map(np.asarray, {"w": jax.random.normal(jax.random.key(1), (4, 1)) * 0.1,
                                       "b": jnp.zeros((1,))})
    cases["fsdp"] = {"params": params, "lr": 0.05, "steps": 3, "batch": {
        "x": rng.standard_normal((8, 4), dtype=np.float32),
        "y": rng.standard_normal((8, 1), dtype=np.float32)}}
    return cases


def _jax_results(cases):
    """The JAX package's results on ``cases``, each case's compile and run
    in a thread of its own (XLA compiles without the GIL)."""
    jobs = {key: functools.partial(
        _jax_attention, {"ring": jax_ring, "ulysses": jax_ulysses}[key.split("-")[0]],
        _jax_mesh(key.split("-")[1]), case) for key, case in cases["attention"].items()}
    jobs["window"] = functools.partial(
        _jax_attention, functools.partial(jax_ulysses, attn_fn=functools.partial(
            jax_flash, window=5, block_q=8, block_k=8)), _jax_mesh("dp2_sp2"), cases["window"])
    for impl in ("ring", "ulysses"):
        jobs[f"transformer-{impl}"] = functools.partial(_jax_stage, impl, cases["transformer"])
    hybrid, fsdp = cases["hybrid"], cases["fsdp"]
    mesh = jax_hybrid(ici=dict(tp=2), dcn=dict(dp=2), devices=jax.devices()[:WORLD],
                      slice_key=lambda d: d.id // 2)
    jobs["hybrid"] = functools.partial(
        _jax_train, JaxMeshStrategy(mesh=mesh), {"w": np.zeros(4, np.float32)},
        optax.sgd(0.1), lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
        hybrid["batch"], 3)
    jobs["fsdp"] = functools.partial(
        _jax_train, JaxFSDP(devices=jax.devices()[:WORLD], min_shard_size=1), fsdp["params"],
        optax.sgd(0.05), lambda p, b: jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2),
        fsdp["batch"], 3)
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX package here and through the port's
    4-rank gloo group once: ``(jax results, rank 0's results)``."""
    wd = tmp_path_factory.mktemp("torch_parallel")
    port = get_free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker",
                               str(r), str(WORLD), str(port), str(wd)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        cases = _cases()
        tmp = wd / "inputs.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(cases, f)
        os.rename(tmp, wd / "inputs.pkl")               # the ranks wait for it
        want = _jax_results(cases)                      # while the ranks run
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    with open(wd / "out.0.pkl", "rb") as f:
        got = pickle.load(f)
    with open(wd / "out.3.pkl", "rb") as f:
        got["rank3"] = pickle.load(f)
    return want, got


# -- mesh --------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jax_mesh_mod, port_mesh_mod], ids=["jax", "port"])
def test_mesh_resolve_errors_name_axis_and_device_count(mod):
    """The JAX package's ``test_parallel.py`` cases, through both packages:
    one-line errors naming the axis and the device count."""
    MeshSpec = mod.MeshSpec
    with pytest.raises(ValueError, match=r"'dp'.*'tp': 3.*8 devices"):
        MeshSpec(tp=3).resolve(8)
    with pytest.raises(ValueError, match=r"'tp': 3.*require 3 devices.*8"):
        MeshSpec(dp=1, tp=3).resolve(8)
    with pytest.raises(ValueError, match=r"axis 'tp' has invalid size 0"):
        MeshSpec(tp=0).resolve(8)
    with pytest.raises(ValueError, match=r"axis 'sp' has invalid size -2"):
        MeshSpec(sp=-2).resolve(8)
    with pytest.raises(ValueError, match=r"'dp'.*'tp'"):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    with pytest.raises(ValueError, match=r"unknown mesh axes \['xp'\]"):
        mod.make_mesh(xp=2)
    assert mod.AXES == ("pp", "dp", "fsdp", "ep", "sp", "tp")
    assert MeshSpec(tp=4).resolve(8) == MeshSpec(dp=2, tp=4)


def test_meshes_keep_every_axis_and_infer_the_free_one(runs):
    _, got = runs
    full = dict.fromkeys(port_mesh_mod.AXES, 1)
    assert got["shapes"]["tp2"] == {**full, "dp": 2, "tp": 2}
    assert got["shapes"]["num_ps2"] == {**full, "dp": 2, "ep": 2}
    assert got["shapes"]["dp2_sp2"] == {**full, "dp": 2, "sp": 2}
    # dp across the two slices {0, 1} and {2, 3}, tp inside each
    assert got["shapes"]["hybrid"] == {**full, "dp": 2, "tp": 2}
    assert np.asarray(got["hybrid_grid"]).reshape(2, 2).tolist() == [[0, 1], [2, 3]]
    assert got["placements"] == "[Replicate(), Replicate(), Replicate(), Replicate(), " \
        "Shard(dim=1), Shard(dim=1)]"


def test_partition_rules_path_matching():
    """The reference's rule cases, state-dict names in the port."""
    from jax.sharding import PartitionSpec as JP

    jax_rules = JaxRules([(r".*emb.*", JP("tp", None)), (r".*kernel", JP(None, "tp")),
                          (r".*", JP())])
    port_rules = port_sh.PartitionRules([(r".*emb.*", port_sh.P("tp", None)),
                                         (r".*weight", port_sh.P(None, "tp")),
                                         (r".*", port_sh.P())])
    jax_specs = jax_rules.tree_specs({"dense": {"kernel": jnp.ones((8, 16)),
                                                "bias": jnp.ones((16,))},
                                      "emb": {"embedding": jnp.ones((32, 8))}})
    port_specs = port_rules.tree_specs({"dense.weight": torch.ones(16, 8),
                                        "dense.bias": torch.ones(16),
                                        "emb.weight": torch.ones(32, 8)})
    assert tuple(jax_specs["emb"]["embedding"]) == tuple(port_specs["emb.weight"]) \
        == ("tp", None)
    assert tuple(jax_specs["dense"]["kernel"]) == tuple(port_specs["dense.weight"]) \
        == (None, "tp")
    assert tuple(jax_specs["dense"]["bias"]) == tuple(port_specs["dense.bias"]) == ()
    assert port_sh.batch_pspec() == port_sh.P(("dp", "fsdp"))


def test_shard_params_places_dtensors_by_the_rules(runs):
    """``shard_params`` puts each tensor on the mesh as a DTensor with its
    rule's placements (this rank's block is ``local_block``'s), and
    ``constrain`` redistributes one (to replicated here)."""
    _, got = runs
    for result in (got, got["rank3"]):
        placements, local, block = result["shard_params"]["w"]
        np.testing.assert_array_equal(local, block)
        assert local.shape == (4, 4)
        assert placements == "(Replicate(), Replicate(), Replicate(), Replicate(), " \
            "Replicate(), Shard(dim=0))"
    assert got["shard_params"]["b"] == "(" + ", ".join(["Replicate()"] * 6) + ")"
    assert got["shard_params"]["constrained"] == got["shard_params"]["b"]
    assert got["rank3"]["shard_params"]["w"][1][0, 0] == 16.0     # tp rank 1's rows


# -- sequence-parallel attention --------------------------------------------

@pytest.mark.parametrize("key", ATTENTION_CASES)
def test_sequence_parallel_attention_matches_jax(runs, key):
    """Ring and Ulysses at sp 2 (x dp 2) and sp 4, causal and with a
    padding mask: outputs and q/k/v gradients."""
    want, got = runs
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key][name], want[key][name], **ATTN_TOL, err_msg=name)
        # the global gradient comes back whole on every rank
        np.testing.assert_array_equal(got["rank3"][key][name], got[key][name])


def test_ulysses_with_windowed_flash_matches_jax(runs):
    """The sliding-window recipe: the port's flash attention (its plain
    version here) with ``window=5`` inside Ulysses, against the JAX
    package's flash kernel inside its Ulysses."""
    want, got = runs
    for name in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got["window"][name], want["window"][name], **ATTN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention], ids=["ring", "ulysses"])
def test_world_of_one_falls_through(fn):
    case = _qkv(3, True)
    q, k, v = (torch.from_numpy(case[n]) for n in "qkv")
    want = reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(fn(q, k, v, causal=True).numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_missing_axis_raises_instead_of_attending_locally(runs, impl):
    _, got = runs
    kind, msg = got["missing_axis"][impl]
    assert kind == "NameError" and "sq_typo" in msg


# -- the tp x sp transformer stage ------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_transformer_stage_tp2_sp2_matches_jax(runs, impl):
    """``make_transformer_stage`` at tp 2 x sp 2 with the JAX stage's
    weights: outputs, the input's gradient and every parameter's (the
    LayerNorms' included, which Megatron's conjugate pair completes)."""
    want, got = (r[f"transformer-{impl}"] for r in runs)
    np.testing.assert_allclose(got["out"], want["out"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=1e-4, atol=1e-4)
    flat_want = jax.tree_util.tree_leaves_with_path(want["grads"])
    for path, w in flat_want:
        g = got["grads"]
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=str(path))


# -- strategies ----------------------------------------------------------------

def _assert_train_equal(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    for name, w in want["params"].items():
        np.testing.assert_allclose(np.asarray(got["params"][name]).reshape(w.shape), w,
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_mesh_strategy_on_a_hybrid_mesh_matches_jax(runs):
    """3 SGD steps of ``MeshStrategy`` over dp 2 (across two slices) x tp 2
    against the JAX package's over its hybrid mesh: every loss and the
    weights."""
    want, got = runs
    _assert_train_equal(got["hybrid"], want["hybrid"])


def test_fsdp_three_steps_match_jax(runs):
    """``FSDPStrategy(min_shard_size=1)`` over 4 ranks: ``w`` (4, 1) is
    sharded, ``b`` (1,) stays replicated; 3 SGD steps against the JAX
    package's FSDP strategy."""
    want, got = runs
    _assert_train_equal(got["fsdp"], want["fsdp"])


def test_fsdp_shards_large_params(runs):
    _, got = runs
    placement = got["fsdp_placement"]
    assert placement["big"] == ("(Shard(dim=0),)", (16, 8))
    assert placement["tiny"] == ("None", (3,))
    assert got["rank3"]["fsdp_placement"]["big"] == ("(Shard(dim=0),)", (16, 8))


def test_mesh_strategy_routes_extras_and_rng_as_the_reference(runs):
    """A three-argument loss named ``extras`` gets ``state.extras`` (and
    writes them back); a defaulted third argument does not, and ``rng``
    gets a generator; ``**kwargs`` gets nothing; activations pass the
    anchor unchanged."""
    _, got = runs
    assert got["routing"] == {"scale": 4.0, "rng": True, "kwargs": [], "anchor": True}


def test_strategies_over_one_mesh_share_one_gradient_group(runs):
    """Two ``MeshStrategy`` objects over one mesh and a direct
    ``group_over`` of the same axes return the same process group on every
    rank: building a strategy a run leaves no new group behind."""
    _, got = runs
    assert got["one_group"] is True
    assert got["rank3"]["one_group"] is True
