"""The port's expert-parallel MoE (``parallel/moe.py``) against the JAX
package's.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (``moe_apply`` under ``shard_map``, the gradient of
``mean(y**2) + 0.01 * aux``); the port's side runs once for the whole
file in one gloo group of 4 CPU processes
(``tests/torch_model_parallel_worker.py``, suite ``moe``): each rank routes
its own block of the tokens over ``dp`` x ``ep``, ``MeshStrategy`` keeps
its block of the expert stacks (``P("ep", None, None)``) and reduces the
gradients, over the same tokens and weights, drawn here with numpy.  The
cases mirror ``tests/test_moe.py``: (ep, dp, top_k) = (2, 1, 1) (both
halves of the world), (2, 2, 2) and (4, 1, 2); the dropped tokens at
capacity factor 0.25; the bad expert count; and a checkpoint of the
expert blocks (whole on disk, each rank's block back on restore).

Tolerances (float32 both sides): ``y`` and ``aux`` ``rtol=atol=1e-5``,
gradients ``rtol=5e-4, atol=1e-6`` (``tests/test_moe.py``'s).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.parallel import make_mesh
from tensorflowonspark_tpu.parallel.mesh import MeshSpec
from tensorflowonspark_tpu.parallel.moe import make_moe_layer as jax_moe_layer
from tensorflowonspark_tpu.parallel.moe import moe_apply as jax_moe_apply
from tensorflowonspark_tpu_torch.parallel.moe import make_moe_layer
from tests.torch_world import run_world

pytestmark = pytest.mark.integration

HID, FFN, EXPERTS, T_LOCAL = 8, 16, 4, 6
MESHES = {"2-1-1": (2, 1, 1), "2-2-2": (2, 2, 2), "4-1-2": (4, 1, 2)}
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    for key, (ep, dp, top_k) in MESHES.items():
        _, init_fn, _ = make_moe_layer(HID, FFN, EXPERTS, top_k=top_k)
        cases[key] = {"hid": HID, "ffn": FFN, "experts": EXPERTS, "top_k": top_k,
                      "params": {k: v.numpy() for k, v in init_fn(int(rng.integers(99))).items()},
                      "x": rng.standard_normal((ep * dp * T_LOCAL, HID), dtype=np.float32)}
    return {"moe": cases}


def _jax_moe(case, ep, dp):
    mesh = make_mesh(MeshSpec(ep=ep, dp=dp), devices=jax.devices()[:ep * dp])
    moe_fn, _, specs = jax_moe_layer(HID, FFN, EXPERTS, top_k=case["top_k"], ep=ep)
    params = jax.tree.map(jnp.asarray, case["params"])
    x = jnp.asarray(case["x"])

    def loss(p):
        y, aux = jax_moe_apply(mesh, moe_fn, p, x, param_specs=specs)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)
    (value, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return {"y": np.asarray(y), "aux": float(aux), "loss": float(value),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX package here and through the port's
    4-rank gloo group once: ``(jax results, [each rank's results])``."""
    cases = _cases()

    def jax_side():                 # a thread a case: XLA compiles without the GIL
        with ThreadPoolExecutor(len(MESHES)) as pool:
            futures = {key: pool.submit(_jax_moe, cases["moe"][key], ep, dp)
                       for key, (ep, dp, _) in MESHES.items()}
            return {key: f.result() for key, f in futures.items()}
    return run_world("moe", cases, jax_side, tmp_path_factory.mktemp("torch_moe"))


@pytest.mark.parametrize("key", sorted(MESHES))
def test_moe_matches_jax(runs, key):
    """``y`` (every token shard's rows), the aux loss averaged over the
    token shards, the loss and every gradient (the router's summed over
    the token shards, each rank's experts' over ``dp``) against
    ``moe_apply``'s at (ep, dp, top_k); each rank kept ``EXPERTS / ep``
    experts."""
    ep = MESHES[key][0]
    want = runs[0][key]
    for rank in runs[1]:
        got = rank[key]
        np.testing.assert_allclose(got["y"], want["y"], **FWD)
        np.testing.assert_allclose(got["aux"], want["aux"], **FWD)
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        for name, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], w, **GRAD, err_msg=name)
        assert got["experts_here"] == EXPERTS // ep


def test_checkpoint_holds_every_expert_and_restores_each_rank_s_block(runs):
    """At ep 4, an Adam step's state saved through ``CheckpointManager``
    holds the expert stacks whole (each rank wrote its block) and a fresh
    state restored from it gets back each rank's parameters and Adam
    moments bit for bit."""
    for rank in runs[1]:
        assert rank["4-1-2"]["checkpoint"] == {"whole": True, "restored": True}


def test_capacity_drops_the_same_tokens_as_jax():
    """Capacity factor 0.25 (one slot an expert): the port drops exactly
    the tokens the JAX layer drops (zero rows), and the kept rows agree."""
    jax_fn, _, _ = jax_moe_layer(HID, FFN, EXPERTS, top_k=1, capacity_factor=0.25)
    moe_fn, init_fn, _ = make_moe_layer(HID, FFN, EXPERTS, top_k=1, capacity_factor=0.25)
    params = init_fn(3)
    x = np.random.default_rng(1).standard_normal((16, HID), dtype=np.float32)
    want, _ = jax.jit(jax_fn)({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                              jnp.asarray(x))
    got, _ = moe_fn(params, torch.from_numpy(x))
    kept = np.abs(np.asarray(want)).sum(-1) > 1e-7
    np.testing.assert_array_equal(np.abs(got.numpy()).sum(-1) > 1e-7, kept)
    assert 0 < kept.sum() <= EXPERTS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_bad_expert_count_raises_as_jax():
    with pytest.raises(ValueError, match="must divide") as want:
        jax_moe_layer(HID, FFN, 6, ep=4)
    with pytest.raises(ValueError, match="must divide") as got:
        make_moe_layer(HID, FFN, 6, ep=4)
    assert str(got.value) == str(want.value)
