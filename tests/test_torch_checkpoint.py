"""The port's checkpoints and serving export (``checkpoint.py``) against
the JAX package's, on the CPU.

- ``CheckpointManager``: the same save sequences (skip, force,
  ``save_interval_steps``, ``max_to_keep``, listeners) give the JAX
  package's (orbax's) returns, ``all_steps()`` and ``latest_step()``, sync
  and async; restores are bit for bit; an async save is a snapshot and
  ``close()`` makes it durable; a training state restored into a fresh
  replica trains on exactly as the unbroken run.
- ``export_model`` / ``ExportedModel``: the JAX package's export tests,
  ported; an MNIST export of flax parameters carried into the port writes
  the reference's ``export_meta.json`` and serves the reference export's
  probabilities within 1e-5 (float32, another summation order) at a batch
  other than the example's; a small BERT exports and serves through the
  ``tfos::flash_fwd`` custom op, counting no launch on the CPU.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import checkpoint as jckpt
from tensorflowonspark_tpu.models.mnist import MNISTNet as JaxMNISTNet
from tensorflowonspark_tpu_torch import bert_inference, bert_train, mnist_train
from tensorflowonspark_tpu_torch import checkpoint as ckpt
from tensorflowonspark_tpu_torch.models.bert import build_qa_model, init_params
from tensorflowonspark_tpu_torch.models.mnist import MNISTNet, params_from_flax
from tensorflowonspark_tpu_torch.ops import flash_attention
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, adam, sgd

#: (save sequence of (step, force), manager options)
SEQUENCES = {
    "interval": ([(1, False), (2, False), (3, False), (4, False), (6, False), (5, False),
                  (5, True), (9, False), (7, False)], {"save_interval_steps": 3,
                                                       "max_to_keep": 3}),
    "force_older_step": ([(3, False), (4, False), (5, False), (2, True), (2, False),
                          (6, False)], {"max_to_keep": 3}),
    "replace_keeps_save_order": ([(3, False), (6, False), (2, True), (7, False), (8, False),
                                  (6, True), (9, False)], {"max_to_keep": 3}),
    "interval_from_zero": ([(0, False), (1, False), (2, False)], {"save_interval_steps": 2}),
}


def _drive(make, seq, value):
    saved, listened, trail = [], [], []
    mngr = make()
    mngr.add_save_listener(lambda step, state: listened.append(step))
    mngr.add_save_listener(lambda step, state: 1 / 0)     # swallowed, logged
    for step, force in seq:
        saved.append(mngr.save(step, value(step), force=force))
        trail.append((list(mngr.all_steps()), mngr.latest_step()))
    mngr.close()
    reopened = make()
    kept = list(reopened.all_steps())
    values = {s: reopened.restore(s) for s in kept}
    reopened.close()
    return saved, listened, trail, kept, values


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_manager_semantics_match_the_jax_package(tmp_path, name, async_save):
    seq, opts = SEQUENCES[name]
    want = _drive(lambda: jckpt.CheckpointManager(str(tmp_path / "jax"), async_save=False,
                                                  **opts),
                  seq, lambda s: {"x": np.full(3, s, np.float32)})
    got = _drive(lambda: ckpt.CheckpointManager(str(tmp_path / "port"), async_save=async_save,
                                                **opts),
                 seq, lambda s: {"x": torch.full((3,), float(s))})
    assert got[:4] == want[:4]
    for step in got[3]:
        np.testing.assert_array_equal(got[4][step]["x"].numpy(), want[4][step]["x"])
    # the force-replaced step holds the second save's value, and the
    # directory holds exactly the kept steps
    assert sorted(os.listdir(tmp_path / "port")) == sorted(str(s) for s in got[3])


def _state():
    g = torch.Generator().manual_seed(0)
    return {"model": {"w": torch.randn(3, 4, generator=g), "b16": torch.randn(5).bfloat16(),
                      "n": torch.arange(4)},
            "optim": {"state": {"w": {"momentum_buffer": torch.randn(3, 4, generator=g)}},
                      "param_groups": [{"lr": 0.1, "params": ["w"]}]},
            "step": 7, "data": {"elements_consumed": 3}, "name": "run", "lst": [1.5, 2]}


def _assert_bitwise(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(str(k) for k in want)
        for k in want:
            _assert_bitwise(got[str(k)], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_bitwise(a, b)
    elif torch.is_tensor(want):
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got, want.cpu())
    else:
        assert got == want and type(got) is type(want)


def test_restore_without_a_target_gives_host_values_bit_for_bit(tmp_path):
    state = _state()
    ckpt.save_checkpoint(str(tmp_path / "m"), state, step=7)
    _assert_bitwise(ckpt.restore_checkpoint(str(tmp_path / "m")), state)
    assert ckpt.restore_checkpoint(str(tmp_path / "missing")) is None
    ckpt.save_checkpoint(str(tmp_path / "m"), {**state, "step": 9}, step=9)
    assert ckpt.restore_checkpoint(str(tmp_path / "m"), step=7)["step"] == 7
    assert ckpt.restore_checkpoint(str(tmp_path / "m"))["step"] == 9


def test_restore_into_a_target_loads_in_place(tmp_path):
    state = _state()
    ckpt.save_checkpoint(str(tmp_path / "m"), state)
    target = {"model": {k: torch.zeros_like(v) for k, v in state["model"].items()}}
    w = target["model"]["w"]
    out = ckpt.restore_checkpoint(str(tmp_path / "m"), target=target)
    assert out is target and out["model"]["w"] is w
    assert torch.equal(w, state["model"]["w"])


def test_async_save_is_a_snapshot_made_durable_by_close(tmp_path):
    """The state is copied before ``save`` returns; a manager closed at
    once leaves every step restorable."""
    state = _state()
    before = state["model"]["w"].clone()
    mngr = ckpt.CheckpointManager(str(tmp_path / "m"), async_save=True)
    assert mngr.save(1, state)
    state["model"]["w"].add_(1.0)                   # the next step, in place
    assert mngr.save(2, state)
    mngr.close()
    assert torch.equal(ckpt.restore_checkpoint(str(tmp_path / "m"), step=1)["model"]["w"],
                       before)
    assert torch.equal(ckpt.restore_checkpoint(str(tmp_path / "m"))["model"]["w"], before + 1)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "sgd_no_momentum"])
def test_a_restored_train_state_trains_on_as_the_unbroken_run(tmp_path, optimizer):
    """``TrainState.state_dict`` through a checkpoint into a fresh replica:
    3 + 3 steps equal 6 unbroken steps bit for bit.  Without the restored
    optimizer state (momentum, Adam's moments) they do not; plain SGD has
    none, and its checkpoint holds no optimizer state at all."""
    opt = {"sgd": sgd(0.1), "adam": adam(1e-2),
           "sgd_no_momentum": sgd(0.1, momentum=0.0)}[optimizer]
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.standard_normal((8, 5), dtype=np.float32)),
                torch.from_numpy(rng.integers(0, 3, 8))) for _ in range(6)]

    def fresh():
        torch.manual_seed(0)
        strategy = DataParallelStrategy("cpu")
        model = torch.nn.Sequential(torch.nn.Linear(5, 6), torch.nn.BatchNorm1d(6),
                                    torch.nn.Linear(6, 3))
        return strategy.init_state(model, opt), strategy.build_train_step(
            lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]))

    def run(state, step, bs):
        for b in bs:
            state, _ = step(state, b)
        return state

    unbroken = run(*fresh(), batches).module.state_dict()
    state, step = fresh()
    state = run(state, step, batches[:3])
    with ckpt.CheckpointManager(str(tmp_path / "m")) as mngr:
        mngr.save(state.step, state.state_dict())
    restored = ckpt.restore_checkpoint(str(tmp_path / "m"))
    assert restored["step"] == 3
    assert ("state" in restored["optim"]) == (optimizer != "sgd_no_momentum")
    state, step = fresh()
    state.load_state_dict(restored)
    resumed = run(state, step, batches[3:]).module.state_dict()
    assert all(torch.equal(resumed[k], unbroken[k]) for k in unbroken)
    if optimizer == "sgd_no_momentum":
        return
    state, step = fresh()
    state.load_state_dict({**restored, "optim": {**restored["optim"], "state": {}}})
    faulty = run(state, step, batches[3:]).module.state_dict()
    assert not torch.equal(faulty["0.weight"], unbroken["0.weight"])


# ----------------------------------------------------------------- export

def _linear(params, x):
    return x @ params["w"] + params["b"]


def _load(d):
    return ckpt.ExportedModel.load(d, device="cpu")


class TestExportedModel:
    """The JAX package's ``tests/test_checkpoint.py::TestExportedModel``,
    ported."""

    def test_export_load_call(self, tmp_path):
        params = {"w": torch.full((3, 2), 2.0), "b": torch.ones(2)}
        x = np.ones((4, 3), np.float32)
        d = ckpt.export_model(str(tmp_path / "export"), _linear, params, [x],
                              input_names=["features"], output_names=["logits"])
        out = _load(d).signature()(x)
        np.testing.assert_allclose(out["logits"].numpy(), np.full((4, 2), 7.0))

    def test_batch_polymorphic(self, tmp_path):
        params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
        d = ckpt.export_model(str(tmp_path / "e"), _linear, params,
                              [np.ones((4, 3), np.float32)])
        model = _load(d)
        for batch in (1, 4, 17):
            assert model(np.ones((batch, 3), np.float32))["output_0"].shape == (batch, 2)

    def test_named_inputs_and_signature_key(self, tmp_path):
        params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
        d = ckpt.export_model(
            str(tmp_path / "e"), _linear, params, [np.ones((2, 3), np.float32)],
            input_names=["x"], signature_name="score",
            extra_signatures={"double": (lambda p, x: 2 * _linear(p, x),
                                         [np.ones((2, 3), np.float32)])})
        model = _load(d)
        a = model.signature("score")(x=np.ones((2, 3), np.float32))["output_0"]
        b = model.signature("double")(np.ones((2, 3), np.float32))["output_0"]
        torch.testing.assert_close(b, 2 * a)
        with pytest.raises(KeyError):
            model.signature("missing")

    def test_tag_mismatch_raises(self, tmp_path):
        params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
        d = ckpt.export_model(str(tmp_path / "e"), _linear, params,
                              [np.ones((2, 3), np.float32)], tags=("serve",))
        ckpt.ExportedModel.load(d, tag_set="serve", device="cpu")  # ok
        with pytest.raises(ValueError):
            ckpt.ExportedModel.load(d, tag_set="serve,gpu", device="cpu")

    def test_non_chief_skips(self, tmp_path):
        assert ckpt.export_model(str(tmp_path / "e"), _linear, {}, [], is_chief=False) is None
        assert not os.path.exists(str(tmp_path / "e"))

    def test_multi_input_polymorphic(self, tmp_path):
        def fn(p, x, mask):
            return (x @ p["w"]) * mask

        d = ckpt.export_model(str(tmp_path / "e"), fn, {"w": torch.ones(3, 2)},
                              [np.ones((4, 3), np.float32), np.ones((4, 2), np.float32)],
                              input_names=["x", "mask"])
        out = _load(d)(np.ones((9, 3), np.float32), np.ones((9, 2), np.float32))
        assert out["output_0"].shape == (9, 2)

    def test_extra_signature_different_arity(self, tmp_path):
        d = ckpt.export_model(
            str(tmp_path / "e"), lambda p, x: x @ p["w"], {"w": torch.ones(3, 2)},
            [np.ones((2, 3), np.float32)], input_names=["features"],
            extra_signatures={"masked": (lambda p, x, m: (x @ p["w"]) * m,
                                         [np.ones((2, 3), np.float32),
                                          np.ones((2, 2), np.float32)])})
        sig = _load(d).signature("masked")
        assert sig.input_names == ["input_0", "input_1"]
        out = sig(input_0=np.ones((5, 3), np.float32), input_1=np.zeros((5, 2), np.float32))
        np.testing.assert_allclose(out["output_0"].numpy(), np.zeros((5, 2)))

    def test_scalar_output_shape_meta(self, tmp_path):
        d = ckpt.export_model(str(tmp_path / "e"), lambda p, x: torch.sum(x @ p["w"]),
                              {"w": torch.ones(3)}, [np.ones((2, 3), np.float32)])
        model = _load(d)
        assert model.signature().spec["outputs"][0]["shape"] == []
        assert model(np.ones((4, 3), np.float32))["output_0"].shape == ()

    def test_name_arity_mismatch_raises(self, tmp_path):
        with pytest.raises(ValueError, match="names"):
            ckpt.export_model(str(tmp_path / "e"), _linear,
                              {"w": torch.ones(3, 2), "b": torch.zeros(2)},
                              [np.ones((2, 3), np.float32)], input_names=["a", "b"])

    def test_loads_without_model_code(self, tmp_path):
        d = ckpt.export_model(str(tmp_path / "e"), _linear,
                              {"w": torch.eye(3), "b": torch.zeros(3)},
                              [np.ones((2, 3), np.float32)])
        x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
        np.testing.assert_allclose(_load(d)(x)["output_0"].numpy(), x, rtol=1e-6)


def test_mnist_export_matches_the_reference_export(tmp_path):
    """``mnist_spark.py``'s export of flax parameters, and the port's of
    the same parameters carried across: one ``export_meta.json``, and the
    same probabilities at a batch of 3 (the example is a batch of 1)."""
    images, _ = mnist_train.synthetic_mnist(3, seed=1)
    x = images[..., None]
    model = JaxMNISTNet()
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(
        model.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"]))

    def serve(p, x):
        return jax.nn.softmax(model.apply({"params": p}, x), axis=-1)

    jdir = jckpt.export_model(str(tmp_path / "jax"), serve, params,
                              [np.zeros((1, 28, 28, 1), np.float32)],
                              input_names=["image"], output_names=["prob"])
    port = MNISTNet()
    port.load_state_dict(params_from_flax(params))
    pdir = mnist_train.export(str(tmp_path / "port"), port)
    with open(os.path.join(jdir, "export_meta.json")) as a, \
            open(os.path.join(pdir, "export_meta.json")) as b:
        assert json.load(b) == json.load(a)
    want = np.asarray(jckpt.ExportedModel.load(jdir)(x)["prob"])
    got = _load(pdir)(image=x)["prob"]
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bert_export_serves_through_the_flash_op(tmp_path):
    """A 2-layer BERT with head dim 16 (hidden 64 over 4 heads) exported
    by ``bert_train.export``: the program calls ``tfos::flash_fwd`` once a
    layer, serves a batch of 3 (traced at 2) as the eager model does, and
    on the CPU counts no kernel launch."""
    config = {"vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
              "intermediate_size": 128, "max_position_embeddings": 64, "dtype": "float32"}
    cfg = bert_inference.qa_config(config)
    sd = init_params(cfg, 3)
    eager = build_qa_model(cfg, sd, "cpu")
    d = bert_train.export(str(tmp_path / "bert"), eager, seq_len=24)
    program = torch.export.load(os.path.join(d, "signatures", "serving_default.pt2"))
    assert [n.target for n in program.graph.nodes].count(torch.ops.tfos.flash_fwd.default) == 2
    with open(os.path.join(d, "export_meta.json")) as f:
        meta = json.load(f)["signatures"]["serving_default"]
    assert [i["name"] for i in meta["inputs"]] == list(bert_train.SERVE_INPUTS)
    assert meta["outputs"][0] == {"name": "start_logits", "dtype": "float32",
                                  "shape": [None, 24]}
    rows = bert_inference.make_rows(3, 24, 128, seed=5)
    cols = [np.stack([r[c] for r in rows]) for c in range(3)]
    launches = flash_attention.launches
    exported = _load(d)
    got = bert_inference.forward_batch(exported, cols, 4, "cpu")
    with torch.no_grad():
        want = bert_inference.forward_batch(eager, cols, 4, "cpu")
    assert flash_attention.launches == launches
    for a, b in zip(got, want):
        assert a.shape == (3, 24)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.integration
def test_bert_trains_exports_and_serves_through_the_cluster(tmp_path):
    """``bert_train`` checkpoints into ``model_dir`` and its chief exports;
    ``bert_inference`` serves rows from the export through
    ``cluster.inference`` as the eager model of the checkpoint's weights
    does."""
    config = {"vocab_size": 128, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
              "intermediate_size": 128, "max_position_embeddings": 64, "dtype": "float32"}
    rows = bert_train.make_train_rows(8, 24, 128, seed=0)
    model_dir, export_dir = str(tmp_path / "model"), str(tmp_path / "export")
    env = {"OMP_NUM_THREADS": "1"}
    stats, weights = bert_train.run_training(
        rows, config, seed=0, batch_size=4, steps=2, lr=1e-3, dropout=0.0, num_workers=1,
        device="cpu", model_dir=model_dir, export_dir=export_dir, timeout=120,
        worker_env=env, working_dir=str(tmp_path / "a"))
    assert len(stats[0]["losses"]) == 2
    saved = ckpt.restore_checkpoint(model_dir)
    assert saved["step"] == 2 and set(saved["optim"]["state"]) == set(weights)

    serve = bert_inference.make_rows(6, 24, 128, seed=1)
    results, st = bert_inference.run_inference(
        serve, export_dir=export_dir, batch_size=4, num_workers=1, device="cpu",
        working_dir=str(tmp_path / "b"), timeout=120, worker_env=env)
    assert st[0]["rows"] == 6 and st[0]["launches"] == 0
    eager = build_qa_model(bert_inference.qa_config(config), weights, "cpu")
    with torch.no_grad():
        want = bert_inference.forward_batch(eager, [np.stack([r[c] for r in serve])
                                                    for c in range(3)], 8, "cpu")
    for j in range(2):
        np.testing.assert_allclose(np.stack([r[j] for r in results]), want[j],
                                   atol=1e-5, rtol=1e-5)
