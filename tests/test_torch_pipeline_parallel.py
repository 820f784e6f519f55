"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (its ``pipeline_apply`` and
``pipeline_value_and_grad`` under ``shard_map``, its ``PipelineStrategy``
steps); the port's side runs once for the whole file, in one gloo group of
4 CPU processes (``tests/torch_model_parallel_worker.py``, suite
``pipeline``), each rank holding its stage's block of the stacked
parameters and its rows of the batch, over the same inputs and weights,
drawn here from a seed with numpy (the transformer stage's from the JAX
package's initialiser).

The cases mirror ``tests/test_pipeline_parallel.py``: GPipe forward and
stage gradients at (pp, dp, M) = (2, 1, 2) and (2, 2, 4), the microbatching
errors, a ``PipelineStrategy`` step (with a tied table feeding stage 0),
1F1B's loss, stage and head gradients and ``dx`` at (2, 1, 4) and (2, 2,
4), over the tp-sharded transformer stage at pp 2 x tp 2, with the
sequence cut over sp, the 1F1B strategy step, its within-stage-axes guard
and the bubble fraction.

Tolerances (float32 on both sides, other summation orders): outputs and
losses ``rtol=atol=1e-5``, gradients and updated parameters ``rtol=5e-4``
(``tests/test_moe.py``'s), ``atol=1e-6``.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tensorflowonspark_tpu.parallel import (PipelineStrategy, make_mesh,
                                            make_transformer_stage, pipeline_apply,
                                            pipeline_value_and_grad, stack_stage_params)
from tensorflowonspark_tpu.parallel.mesh import MeshSpec
from tests.torch_world import run_world

pytestmark = pytest.mark.integration

HID = 16
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=5e-4, atol=1e-6)
GPIPE = {"2-1": (2, 1, 2), "2-2": (2, 2, 4)}
F1B = {"2-1": (2, 1, 4), "2-2": (2, 2, 4)}
TP = {"hidden": 16, "heads": 2, "ffn": 32, "M": 4, "B": 8, "T": 8}


def _stage_fn(params, x):
    return x + jnp.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def _head_fn(hp, y, tgt):
    return jnp.mean((y @ hp["wo"] - tgt) ** 2)


def _mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return make_mesh(MeshSpec(**{"dp": 1, **sizes}), devices=jax.devices()[:n])


def _stacked(rng, stages=2):
    return {"w1": rng.standard_normal((stages, HID, HID), dtype=np.float32) * 0.1,
            "b1": rng.standard_normal((stages, HID), dtype=np.float32) * 0.01,
            "w2": rng.standard_normal((stages, HID, HID), dtype=np.float32) * 0.1}


def _cases():
    rng = np.random.default_rng(0)
    cases = {"hid": HID, "gpipe": {}, "1f1b": {}}
    for key, (pp, dp, M) in GPIPE.items():
        cases["gpipe"][key] = {"stacked": _stacked(rng), "M": M,
                               "x": rng.standard_normal((2 * M * dp, HID), dtype=np.float32)}
    cases["strategy-gpipe"] = {"stacked": _stacked(rng), "M": 4, "lr": 0.1,
                               "head": rng.standard_normal((HID, 4), dtype=np.float32) * 0.1,
                               "emb": rng.standard_normal((4, HID), dtype=np.float32) * 0.5,
                               "ids": rng.integers(0, 4, 8).astype(np.int32),
                               "y": rng.integers(0, 4, 8).astype(np.int32)}

    def f1b(B, shape=(HID,)):
        return {"stacked": _stacked(rng), "M": 4,
                "wo": rng.standard_normal((HID, HID), dtype=np.float32) * 0.2,
                "x": rng.standard_normal((B, *shape), dtype=np.float32),
                "tgt": rng.standard_normal((B, *shape), dtype=np.float32)}
    for key, (pp, dp, M) in F1B.items():
        cases["1f1b"][key] = f1b(2 * M * dp)
    _, init_fn, _ = make_transformer_stage(TP["hidden"], TP["heads"], TP["ffn"], tp=2,
                                           causal=True)
    stacked = stack_stage_params([init_fn(k) for k in jax.random.split(jax.random.key(0), 2)])
    cases["1f1b-tp"] = {**f1b(TP["B"], (TP["T"], TP["hidden"])), **TP,
                        "stacked": jax.tree.map(np.asarray, stacked)}
    cases["1f1b-sp"] = f1b(8, (4, HID))
    cases["strategy-1f1b"] = {**f1b(16), "lr": 0.1}
    return cases


def _jax_gpipe(case, pp, dp):
    mesh = _mesh(pp=pp, dp=dp)
    stacked = jax.tree.map(jnp.asarray, case["stacked"])
    def loss(p):
        y = pipeline_apply(mesh, _stage_fn, p, jnp.asarray(case["x"]),
                           num_microbatches=case["M"])
        return jnp.mean(y ** 2), y
    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    return {"y": np.asarray(y), "grads": jax.tree.map(np.asarray, g)}


def _jax_errors():
    stacked = jax.tree.map(jnp.asarray, _stacked(np.random.default_rng(1)))
    out = []
    for mesh, rows in ((_mesh(pp=2), 6), (_mesh(pp=2, dp=2), 4)):
        with pytest.raises(ValueError, match="must divide") as e:
            pipeline_apply(mesh, _stage_fn, stacked, jnp.zeros((rows, HID)), num_microbatches=4)
        out.append(str(e.value))
    return out


def _jax_1f1b(case, mesh, stage_fn=_stage_fn, **kw):
    args = [jax.tree.map(jnp.asarray, a) for a in
            (case["stacked"], {"wo": case["wo"]}, case["x"], case["tgt"])]
    loss, ds, dh, dx = jax.jit(lambda s, h, x, t: pipeline_value_and_grad(
        mesh, stage_fn, _head_fn, s, h, x, t, num_microbatches=case["M"], **kw))(*args)
    return {"loss": float(loss), "ds": jax.tree.map(np.asarray, ds),
            "dh": jax.tree.map(np.asarray, dh), "dx": np.asarray(dx)}


def _jax_strategy(case, one_f_one_b: bool):
    strat = PipelineStrategy(_stage_fn, num_stages=2, num_microbatches=case["M"], dp=2,
                             devices=jax.devices()[:4])
    head = {"wo": case["wo"]} if one_f_one_b else {"head": case["head"], "emb": case["emb"]}
    state = strat.init_state(lambda: jax.tree.map(jnp.asarray, {"stages": case["stacked"],
                                                                **head}),
                             optax.sgd(case["lr"]))
    if one_f_one_b:
        step = strat.build_train_step_1f1b(_head_fn)
        batch = (jax.device_put(case["x"], strat.batch_sharding()),
                 jax.device_put(case["tgt"], strat.batch_sharding()))
    else:
        def loss_fn(params, batch):
            h = strat.apply(params["stages"], params["emb"][batch["ids"]])
            logits = h @ params["head"] + h @ params["emb"].T
            return optax.softmax_cross_entropy_with_integer_labels(logits, batch["y"]).mean()
        step = strat.build_train_step(loss_fn)
        batch = {k: jax.device_put(case[k], strat.batch_sharding()) for k in ("ids", "y")}
    state, metrics = step(state, batch)
    params = jax.device_get(state.params)
    flat = {f"stages.{k}": np.asarray(v) for k, v in params.pop("stages").items()}
    flat.update({k: np.asarray(v) for k, v in params.items()})
    return {"loss": float(metrics["loss"]), "params": flat, "bubble": strat.bubble_fraction}


def _jax_guard():
    strat = PipelineStrategy(_stage_fn, num_stages=2, num_microbatches=4, tp=2, dp=1,
                             devices=jax.devices()[:4])
    strat.init_state(lambda: {"stages": jax.tree.map(jnp.asarray, _stacked(
        np.random.default_rng(2))), "wo": jnp.eye(HID)}, optax.sgd(0.1))
    with pytest.raises(ValueError, match="within-stage axes") as e:
        strat.build_train_step_1f1b(lambda hp, y, t: jnp.mean(y))
    return str(e.value)


def _jax_results(cases):
    from jax.sharding import PartitionSpec as JP

    tp_fn, _, tp_specs = make_transformer_stage(TP["hidden"], TP["heads"], TP["ffn"], tp=2,
                                                causal=True)
    seq = JP(("dp", "fsdp"), "sp", None)
    jobs = {f"gpipe-{k}": functools.partial(_jax_gpipe, cases["gpipe"][k], pp, dp)
            for k, (pp, dp, _) in GPIPE.items()}
    jobs.update({f"1f1b-{k}": functools.partial(_jax_1f1b, cases["1f1b"][k], _mesh(pp=pp, dp=dp))
                 for k, (pp, dp, _) in F1B.items()})
    jobs["1f1b-tp"] = functools.partial(_jax_1f1b, cases["1f1b-tp"], _mesh(pp=2, tp=2),
                                        stage_fn=tp_fn, param_specs=tp_specs)
    jobs["1f1b-sp"] = functools.partial(_jax_1f1b, cases["1f1b-sp"], _mesh(pp=2, sp=2),
                                        data_spec=seq, target_spec=seq)
    jobs["errors"] = _jax_errors
    jobs["strategy-gpipe"] = functools.partial(_jax_strategy, cases["strategy-gpipe"], False)
    jobs["strategy-1f1b"] = functools.partial(_jax_strategy, cases["strategy-1f1b"], True)
    jobs["guard"] = _jax_guard
    with ThreadPoolExecutor(4) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the JAX package here and through the port's
    4-rank gloo group once: ``(jax results, [each rank's results])``."""
    cases = _cases()
    return run_world("pipeline", cases, lambda: _jax_results(cases),
                     tmp_path_factory.mktemp("torch_pipeline_parallel"))


def _assert_tree(got, want, tol, what):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("key", sorted(GPIPE))
def test_gpipe_forward_and_stage_grads_match_jax(runs, key):
    """``pipeline_apply`` at (pp, dp, M) = (2, 1, 2) (both halves of the
    world) and (2, 2, 4): the output on every stage and the stacked
    gradients of the global mean of its square."""
    want = runs[0][f"gpipe-{key}"]
    for rank in runs[1]:
        np.testing.assert_allclose(rank[f"gpipe-{key}"]["y"], want["y"], **FWD)
        _assert_tree(rank[f"gpipe-{key}"]["grads"], want["grads"], GRAD, "grad")


def test_microbatching_errors_are_the_jax_package_s(runs):
    want, got = runs[0]["errors"], runs[1][0]["errors"]
    assert got == want
    assert "global batch 6 must divide by num_microbatches (4) x data shards (1)" in got[0]


def test_pipeline_strategy_step_matches_jax(runs):
    """One SGD step of ``PipelineStrategy`` (pp 2 x dp 2, M 4, the
    cross-entropy of a linear head plus a table that is both stage 0's
    embedding and tied into the logits): the loss, the stacked stages
    (each rank kept its own), the replicated head and the table, whose
    gradients come whole from stage 0 (a table's from the last stage, or
    summed over pp, would miss or double a part)."""
    want = runs[0]["strategy-gpipe"]
    for rank in runs[1]:
        got = rank["strategy-gpipe"]
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        assert got["placement"] == (1, HID, HID)
        _assert_tree(got["params"], want["params"], GRAD, "param")
    assert runs[1][0]["strategy-gpipe"]["bubble"] == want["bubble"] == pytest.approx(0.2)


@pytest.mark.parametrize("key", ["1f1b-2-1", "1f1b-2-2", "1f1b-tp", "1f1b-sp"])
def test_1f1b_value_and_grad_matches_jax(runs, key):
    """``pipeline_value_and_grad`` at (pp, dp, M) = (2, 1, 4) and (2, 2,
    4), over the tp-sharded transformer stage at pp 2 x tp 2 (its
    ``param_specs``), and with the activations and targets cut over sp
    (the returned ``dx`` carries the dp x sp divisor): the loss, the stage
    and head gradients and ``dx``, the same on every rank."""
    want = runs[0][key]
    for rank in runs[1]:
        got = rank[key]
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        _assert_tree(got["ds"], want["ds"], GRAD, "stage grad")
        _assert_tree(got["dh"], want["dh"], GRAD, "head grad")
        np.testing.assert_allclose(got["dx"], want["dx"], **GRAD)


def test_pipeline_strategy_1f1b_step_matches_jax(runs):
    want = runs[0]["strategy-1f1b"]
    for rank in runs[1]:
        got = rank["strategy-1f1b"]
        np.testing.assert_allclose(got["loss"], want["loss"], **FWD)
        _assert_tree(got["params"], want["params"], GRAD, "param")


def test_1f1b_guards_within_stage_axes(runs):
    """A tp 2 mesh without ``param_specs`` raises, as the JAX strategy does."""
    want, got = runs[0]["guard"], runs[1][0]["guard"]
    assert got is not None and "within-stage axes" in got and "within-stage axes" in want
