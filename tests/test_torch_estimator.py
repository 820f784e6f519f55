"""The port's Estimator surface: train_and_evaluate, max_steps, resume.

Each test of the JAX package's ``tests/test_estimator.py`` has a
counterpart here, on the CPU (``DataParallelStrategy("cpu")``), except
``test_enable_compilation_cache``: it tests JAX's persistent compilation
cache, which PyTorch's eager execution has no counterpart of.  The
reference's estimator-to-serve case trains a GPT and serves it through
the serving tier, which the port does not have yet (ROADMAP A7/A8); here
a BERT QA model trained through ``train_and_evaluate`` is exported and
served by ``TFModel.transform`` against the eager model restored from the
same checkpoint.

The parity cases run the same linear-regression problem with the same
batches through the reference's ``Estimator`` (in a child process, as the
reference's own estimator tests run: a native crash of JAX's CPU runtime
must not take the test session down) and the port's, under ``sgd(0.1)``
and ``adam(1e-3)``: the weights after ``train_and_evaluate`` agree within
1e-6; the ``global_step`` sequence, the sidecar files' keys and integers
are equal and their floats, the eval dicts and the ``train/`` and
``eval/`` scalars read back from both event files agree within 1e-5
relative (float32 sums in another order; the losses near convergence are
differences of close numbers, off by up to 1.5e-6 relative).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from tensorflowonspark_tpu_torch.checkpoint import ExportedModel, restore_checkpoint
from tensorflowonspark_tpu_torch.estimator import (Estimator, EvalSpec, TrainSpec,
                                                   train_and_evaluate)
from tensorflowonspark_tpu_torch.observability import read_scalars
from tensorflowonspark_tpu_torch.parallel.strategy import DataParallelStrategy, adam, sgd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = DataParallelStrategy("cpu")


class _Linear(nn.Module):
    def __init__(self, shape=(4, 1)):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(shape))

    def forward(self, x):
        return x @ self.w


def _linreg_problem(seed=0, n=64, d=4):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d, 1)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x, x @ w_true


def _loss(model, batch):
    return torch.mean((model(batch["x"]) - batch["y"]) ** 2)


def _metrics(model, batch):
    pred = model(batch["x"])
    return {"mse": torch.mean((pred - batch["y"]) ** 2),
            "mae": torch.mean(torch.abs(pred - batch["y"]))}


def _make_estimator(model_dir, save_every=10, opt=None, **kwargs):
    return Estimator(_Linear(), _loss, opt or sgd(0.1, momentum=0.0), str(model_dir),
                     strategy=CPU, eval_metrics_fn=_metrics, save_every_steps=save_every,
                     **kwargs)


def _batches(x, y, bs=16):
    def input_fn():
        for i in range(0, len(x), bs):
            yield {"x": x[i:i + bs], "y": y[i:i + bs]}
    return input_fn


def test_train_and_evaluate_learns_and_reports(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        baseline = est.evaluate(_batches(x, y), steps=2)["mse"]
        final = train_and_evaluate(
            est, TrainSpec(input_fn=_batches(x, y), max_steps=40),
            EvalSpec(input_fn=_batches(x, y), steps=4, throttle_steps=15))
        assert final["global_step"] == 40
        assert final["mse"] < baseline * 0.1, (baseline, final)
        assert "mae" in final


def test_max_steps_is_total_budget_and_resume_works(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=12)
        assert est.global_step == 12
        w_after = est.params["w"].clone()

    # "restart": a fresh Estimator on the same model_dir resumes at step 12
    with _make_estimator(tmp_path / "m") as est2:
        assert est2.global_step == 12
        assert torch.equal(est2.params["w"], w_after)
        est2.train(_batches(x, y), max_steps=20)  # only the remaining 8
        assert est2.global_step == 20


def test_resume_ignores_sidecars_and_an_incomplete_step(tmp_path):
    """The sidecars beside the checkpoints (``input_state/``,
    ``early_stop/``, ``tensorboard/``) and a step directory that a killed
    worker left without its ``.metadata`` are not steps: a relaunch
    resumes from the last complete one."""
    x, y = _linreg_problem()
    model_dir = tmp_path / "m"
    with _make_estimator(model_dir, save_every=4) as est:
        train_and_evaluate(est, TrainSpec(_batches(x, y), 8),
                           EvalSpec(_batches(x, y), steps=1, throttle_steps=4,
                                    early_stopping_patience=3, metric="mse"))
        w8 = est.params["w"].clone()
    (model_dir / "12").mkdir()                       # a save cut before its metadata
    (model_dir / "12" / "__0_0.distcp").write_bytes(b"partial")
    assert {"input_state", "early_stop", "tensorboard"} <= set(os.listdir(model_dir))
    with _make_estimator(model_dir) as est:
        assert est.global_step == 8
        assert torch.equal(est.params["w"], w8)
        assert est._pending_input_resume == {"epoch": 0, "batches": 4}


def test_resume_at_max_steps_still_runs_final_eval(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=10)
    with _make_estimator(tmp_path / "m") as est2:
        final = train_and_evaluate(
            est2, TrainSpec(input_fn=_batches(x, y), max_steps=10),
            EvalSpec(input_fn=_batches(x, y), steps=2, throttle_steps=5))
        assert final["global_step"] == 10
        assert "mse" in final


def test_export_serves_trained_params(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=30)
        w = est.params["w"].numpy().copy()
        out = est.export(str(tmp_path / "export"), lambda m, x: m(x),
                         [np.zeros((4, 4), np.float32)])
    assert out is not None
    served = ExportedModel.load(str(tmp_path / "export"), device="cpu")
    pred = next(iter(served(x[:8]).values())).numpy()
    np.testing.assert_allclose(pred, x[:8] @ w, rtol=1e-5)

    # non-chief writes nothing
    with _make_estimator(tmp_path / "m") as est2:
        assert est2.export(str(tmp_path / "e2"), lambda m, x: m(x),
                           [np.zeros((4, 4), np.float32)], is_chief=False) is None


def test_goodput_accounting(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=8)
        g = est.goodput()
    assert g["counts"]["step"] == 8
    assert 0.0 < g["goodput"] <= 1.0
    for cat in ("init", "data", "step", "checkpoint", "idle"):
        assert g["secs"].get(cat, 0) >= 0
    assert {"init", "data", "step", "checkpoint", "idle"} <= set(g["secs"])


def test_predict_streams_batches(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=30)
        w = est.params["w"].numpy().copy()
        preds = list(est.predict(_batches(x, y), lambda m, b: m(b["x"])))
    assert len(preds) == 4  # 64 samples / bs 16
    np.testing.assert_allclose(np.concatenate(preds), x @ w, rtol=1e-5)

    with _make_estimator(tmp_path / "m") as est2:
        with pytest.raises(ValueError, match="predict_fn"):
            next(est2.predict(_batches(x, y)))


def test_predict_params_override_and_goodput(tmp_path):
    """``predict(params=...)`` scores a candidate state dict without
    touching the trained state, and predict's input waits land in
    goodput()'s ``data`` bucket like train's."""
    x, y = _linreg_problem()
    ones = {"w": torch.ones(4, 1)}
    with _make_estimator(tmp_path / "m") as est:
        est.train(_batches(x, y), max_steps=20)
        base = est.goodput()
        w_trained = est.params["w"].clone()

        preds = list(est.predict(_batches(x, y), lambda m, b: m(b["x"]), params=ones))
        np.testing.assert_allclose(np.concatenate(preds), x @ ones["w"].numpy(), rtol=1e-5)
        # the override was per-call: trained params still serve by default
        assert torch.equal(est.params["w"], w_trained)
        preds2 = list(est.predict(_batches(x, y), lambda m, b: m(b["x"])))
        np.testing.assert_allclose(np.concatenate(preds2), x @ w_trained.numpy(), rtol=1e-5)

        g = est.goodput()
        assert g["counts"]["data"] > base["counts"]["data"]
        assert g["secs"]["data"] >= base["secs"]["data"]
        assert g["counts"]["step"] > base["counts"]["step"]


def test_profile_steps_writes_trace(tmp_path):
    x, y = _linreg_problem()
    model_dir = str(tmp_path / "m")
    with Estimator(_Linear(), _loss, sgd(0.1, momentum=0.0), model_dir, strategy=CPU,
                   profile_steps=(2, 4)) as est:
        est.train(_batches(x, y), max_steps=6)
        assert not est._profiling
    traces = glob.glob(os.path.join(model_dir, "tensorboard", "plugins", "profile", "*"))
    assert traces, "no profiler trace written"


def test_throttle_steps_must_be_positive():
    with pytest.raises(ValueError, match="throttle_steps"):
        EvalSpec(input_fn=lambda: iter(()), throttle_steps=0)


def test_empty_input_fn_raises(tmp_path):
    with _make_estimator(tmp_path / "m") as est:
        with pytest.raises(ValueError, match="no batches"):
            est.train(lambda: iter(()), max_steps=5)
        with pytest.raises(ValueError, match="no batches"):
            est.evaluate(lambda: iter(()), steps=2)


def _scalar_problem(record=None, n=100, loss="quadratic"):
    """``(model, loss_fn, input_fn)`` over a scalar weight: the loss is
    ``w**2`` (or constant 1, a plateau) and ignores the batch values."""
    model = _Linear(())

    def loss_fn(m, batch):
        base = m.w ** 2 if loss == "quadratic" else 1.0 + 0.0 * m.w
        return base + 0.0 * batch["i"].sum()

    def input_fn():
        for i in range(n):
            if record is not None:
                record.append(i)
            yield {"i": np.full((8,), i, np.float32)}

    return model, loss_fn, input_fn


def test_input_state_resumes_pipeline_after_restart(tmp_path):
    """A restarted estimator continues the data stream where the saved
    checkpoint left it instead of re-training the epoch's first batches."""
    seen_a, seen_b = [], []
    model, loss_fn, input_fn = _scalar_problem(seen_a)
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"),
                   strategy=CPU, save_every_steps=5, summary_dir="") as est:
        est.train(input_fn, max_steps=7)  # final save at step 7

    model, loss_fn, input_fn = _scalar_problem(seen_b)
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"),
                   strategy=CPU, save_every_steps=5, summary_dir="") as est:
        assert est.global_step == 7
        assert est._pending_input_resume == {"epoch": 0, "batches": 7}
        est.train(input_fn, max_steps=10)

    # the resumed run TRAINS on batches 7, 8, 9 (the replayed prefix 0..6 is
    # only skipped through, never stepped on)
    assert seen_b[:7] == list(range(7))
    assert seen_b[7:10] == [7, 8, 9], seen_b


def test_input_state_disabled_restarts_epoch(tmp_path):
    kw = dict(strategy=CPU, save_every_steps=5, summary_dir="",
              checkpoint_input_state=False)
    seen = []
    model, loss_fn, input_fn = _scalar_problem(n=50)
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"), **kw) as est:
        est.train(input_fn, max_steps=6)
    model, loss_fn, input_fn = _scalar_problem(seen, n=50)
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"), **kw) as est:
        assert est._pending_input_resume is None
        est.train(input_fn, max_steps=8)
    assert seen[:2] == [0, 1]


def test_early_stopping_halts_on_plateau(tmp_path):
    model, loss_fn, input_fn = _scalar_problem(n=16, loss="plateau")
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"),
                   strategy=CPU, summary_dir="") as est:
        final = train_and_evaluate(
            est, TrainSpec(input_fn=input_fn, max_steps=1000),
            EvalSpec(input_fn=input_fn, steps=2, throttle_steps=4,
                     early_stopping_patience=2))
        # 1 improving round (first) + 2 stale rounds = stop at step 12
        assert est.global_step == 12, est.global_step
        assert final["loss"] == pytest.approx(1.0)


def test_early_stopping_patience_validation():
    with pytest.raises(ValueError, match="early_stopping_patience"):
        EvalSpec(input_fn=lambda: [], early_stopping_patience=0)


def test_early_stopping_state_survives_restart(tmp_path):
    spec = dict(steps=2, throttle_steps=4, early_stopping_patience=3)

    def run(max_steps):
        model, loss_fn, input_fn = _scalar_problem(n=16, loss="plateau")
        with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"),
                       strategy=CPU, summary_dir="") as est:
            train_and_evaluate(est, TrainSpec(input_fn=input_fn, max_steps=max_steps),
                               EvalSpec(input_fn=input_fn, **spec))
            return est.global_step

    # exactly 2 eval rounds (1 improving + 1 stale), then "crash"
    assert run(8) == 8
    # resumed: stale=1 carried over, so only 2 more stale rounds (not 3)
    # before the stop — step 16, not 20
    assert run(1000) == 16
    # a third launch of an already-stopped run must not train at all
    assert run(1000) == 16


def test_early_stopping_unknown_metric_raises(tmp_path):
    model, loss_fn, input_fn = _scalar_problem(n=8)
    with Estimator(model, loss_fn, sgd(0.1, momentum=0.0), str(tmp_path / "m"),
                   strategy=CPU, summary_dir="") as est:
        with pytest.raises(ValueError, match="accuracy"):
            train_and_evaluate(
                est, TrainSpec(input_fn=input_fn, max_steps=8),
                EvalSpec(input_fn=input_fn, steps=2, throttle_steps=4,
                         early_stopping_patience=1, metric="accuracy"))


def test_negative_min_delta_rejected():
    with pytest.raises(ValueError, match="min_delta"):
        EvalSpec(input_fn=lambda: [], early_stopping_patience=1, min_delta=-0.1)


def test_warm_start_loads_params_but_not_step(tmp_path):
    x, y = _linreg_problem()
    with _make_estimator(tmp_path / "donor") as est:
        est.train(_batches(x, y), max_steps=20)
        trained_w = est.params["w"].clone()
    assert not torch.allclose(trained_w, torch.zeros_like(trained_w))

    def fresh(model_dir, donor):
        return Estimator(_Linear(), _loss, sgd(0.1, momentum=0.0), str(model_dir),
                         strategy=CPU, summary_dir="", warm_start_from=str(donor))

    with fresh(tmp_path / "fresh", tmp_path / "donor") as est:
        assert est.global_step == 0  # step starts fresh...
        assert torch.equal(est.params["w"], trained_w)
        assert not est._state.optimizer.state  # ...and so does the optimizer

    # a dir with a checkpoint ignores warm_start_from
    with fresh(tmp_path / "donor", tmp_path / "fresh") as est:
        assert est.global_step == 20

    with pytest.raises(ValueError, match="no\\s+checkpoint"):
        fresh(tmp_path / "x", tmp_path / "empty")


def test_estimator_to_serve_parity(tmp_path):
    """Estimator → serve parity: a BERT QA model trained through
    ``train_and_evaluate`` (checkpoints under ``model_dir``, dropout from
    the step generators), exported with ``Estimator.export`` and served by
    ``TFModel.transform``, gives the logits of the eager model restored from
    the checkpoint (same float32 operations: atol 1e-6)."""
    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch import pipeline as pl
    from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

    config = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                  intermediate_size=64, max_position_embeddings=16, dtype="float32")
    rows = bt.make_train_rows(32, 16, 64, seed=3)
    batches = [bt.pad_batch([np.stack([r[c] for r in rows[i:i + 8]]) for c in range(5)], 8)
               for i in range(0, 32, 8)]
    model_dir = str(tmp_path / "ckpt")
    model = bt.build_train_model({"config": config, "seed": 0, "dropout": 0.1}, "cpu")
    with Estimator(model, bt.squad_loss, bt.adamw(1e-2), model_dir,
                   strategy=DataParallelStrategy("cpu", seed=0),
                   eval_metrics_fn=bt.squad_metrics, save_every_steps=2,
                   handle_preemption=False, summary_dir="") as est:
        final = train_and_evaluate(est, TrainSpec(input_fn=lambda: batches, max_steps=4),
                                   EvalSpec(input_fn=lambda: batches, steps=1,
                                            throttle_steps=4))
        assert final["global_step"] == 4
        est.export(str(tmp_path / "export"),
                   lambda m, ids, mask, types: m(ids.long(), mask, types.long()),
                   [np.zeros((2, 16), np.int32)] * 3, input_names=bt.SERVE_INPUTS,
                   output_names=bt.SERVE_OUTPUTS)

    names = list(bt.SERVE_INPUTS)
    df = DataFrame([Row(_fields=names, _values=list(r[:3])) for r in rows], num_partitions=2)
    served = (pl.TFModel(device="cpu").setExportDir(str(tmp_path / "export"))
              .setBatchSize(8).transform(df).collect())
    eager = bi.build_model({"config": config, "state_dict": restore_checkpoint(model_dir)["model"]},
                           torch.device("cpu"), "flash")
    with torch.no_grad():
        want = bi.forward_batch(eager, [np.stack([r[c] for r in rows]) for c in range(3)],
                                32, "cpu")
    for name, w in zip(bt.SERVE_OUTPUTS, want):
        got = np.stack([np.asarray(getattr(r, name)) for r in served])
        np.testing.assert_allclose(got, w, atol=1e-6, rtol=0)


# -- parity with the JAX package's Estimator ----------------------------------

PARITY_STEPS, PARITY_THROTTLE, PARITY_SAVE = 12, 4, 4
PARITY_OPTS = {"sgd": 0.1, "adam": 1e-3}

_REFERENCE_RUN = '''
import json, os, sys
import numpy as np, jax.numpy as jnp, optax
from tensorflowonspark_tpu.estimator import Estimator, EvalSpec, TrainSpec, train_and_evaluate
out, steps, throttle, save = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
opts = json.loads(sys.argv[5])
rng = np.random.default_rng(0)
w_true = rng.normal(size=(4, 1)).astype(np.float32)
x = rng.normal(size=(64, 4)).astype(np.float32)
y = x @ w_true
def input_fn():
    for i in range(0, 64, 16):
        yield {"x": x[i:i + 16], "y": y[i:i + 16]}
def loss_fn(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
def metrics_fn(p, b):
    pred = b["x"] @ p["w"]
    return {"loss": jnp.mean((pred - b["y"]) ** 2), "mae": jnp.mean(jnp.abs(pred - b["y"]))}
for name, lr in opts.items():
    tx = optax.sgd(lr) if name == "sgd" else optax.adam(lr)
    d = os.path.join(out, name)
    with Estimator(lambda: {"w": jnp.zeros((4, 1))}, loss_fn, tx, d, eval_metrics_fn=metrics_fn,
                   save_every_steps=save, log_every_steps=1) as est:
        evals = []
        orig = est.evaluate
        est.evaluate = lambda *a, **k: evals.append(orig(*a, **k)) or evals[-1]
        train_and_evaluate(est, TrainSpec(input_fn, steps),
                           EvalSpec(input_fn, steps=2, throttle_steps=throttle,
                                    early_stopping_patience=5))
        w = np.asarray(est.params["w"]).tolist()
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump({"w": w, "evals": evals}, f)
'''


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("reference_estimator"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_RUN, out, str(PARITY_STEPS), str(PARITY_THROTTLE),
         str(PARITY_SAVE), json.dumps(PARITY_OPTS)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


def _sidecars(model_dir):
    out = {}
    for sub in ("input_state", "early_stop"):
        for path in sorted(glob.glob(os.path.join(model_dir, sub, "*.json"))):
            with open(path) as f:
                out[f"{sub}/{os.path.basename(path)}"] = json.load(f)
    return out


def _scalars(model_dir):
    (path,) = glob.glob(os.path.join(model_dir, "tensorboard", "events.out.tfevents.*"))
    return [(step, tag, value) for _, step, tag, value in read_scalars(path)]


def _approx_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _approx_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _approx_tree(u, v)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("opt", sorted(PARITY_OPTS))
def test_train_and_evaluate_matches_reference(tmp_path, reference_runs, opt):
    x, y = _linreg_problem()
    lr = PARITY_OPTS[opt]
    optimizer = sgd(lr, momentum=0.0) if opt == "sgd" else adam(lr)
    model_dir = str(tmp_path / opt)

    def metrics_fn(model, batch):
        pred = model(batch["x"])
        return {"loss": torch.mean((pred - batch["y"]) ** 2),
                "mae": torch.mean(torch.abs(pred - batch["y"]))}

    with Estimator(_Linear(), _loss, optimizer, model_dir, strategy=CPU,
                   eval_metrics_fn=metrics_fn, save_every_steps=PARITY_SAVE,
                   log_every_steps=1) as est:
        evals = []
        orig = est.evaluate
        est.evaluate = lambda *a, **k: evals.append(orig(*a, **k)) or evals[-1]
        train_and_evaluate(est, TrainSpec(_batches(x, y), PARITY_STEPS),
                           EvalSpec(_batches(x, y), steps=2, throttle_steps=PARITY_THROTTLE,
                                    early_stopping_patience=5))
        w = est.params["w"].numpy()

    ref_dir = os.path.join(reference_runs, opt)
    with open(os.path.join(ref_dir, "result.json")) as f:
        ref = json.load(f)
    np.testing.assert_allclose(w, np.asarray(ref["w"], np.float32), atol=1e-6, rtol=0)
    assert [e["global_step"] for e in evals] == [e["global_step"] for e in ref["evals"]] \
        == list(range(PARITY_THROTTLE, PARITY_STEPS + 1, PARITY_THROTTLE))
    _approx_tree(evals, ref["evals"])
    _approx_tree(_sidecars(model_dir), _sidecars(ref_dir))
    assert set(_sidecars(model_dir)) == {f"input_state/{s}.json" for s in (4, 8, 12)} \
        | {"early_stop/state.json"}
    got, want = _scalars(model_dir), _scalars(ref_dir)
    assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want]
    np.testing.assert_allclose([v for *_, v in got], [v for *_, v in want], rtol=1e-5)
