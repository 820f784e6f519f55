"""The port's pipeline layer, against the JAX package's.

Each test of ``tests/test_pipeline.py`` has a counterpart here
(TFEstimator.fit → TFModel.transform end to end on a small model with CPU
workers, input/output mapping, signature selection, the model cache, the
Param machinery, grid search).  The parity cases apply the same Param
operations to both packages' classes and compare ``explainParams()``,
``merge_args_params()`` and ``ParamGridBuilder.build()`` exactly; run
``TrainValidationSplit`` and ``CrossValidator`` with the same seed on both
(the same numpy shuffles: equal metrics and the same best model); and
serve a linear export written by each package through that package's
``TFModel.transform`` over the same rows (equal rows: the inputs are
multiples of 1/4, so ``3x - 1`` is exact in float32).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import dataframe as port_df
from tensorflowonspark_tpu_torch import pipeline as pl
from tensorflowonspark_tpu_torch.checkpoint import export_model
from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

# A worker imports this module to find its function: the JAX package is
# imported inside the tests that need it, so that no worker loads JAX.


# -- Param machinery --------------------------------------------------------

def test_mixin_accessors_and_defaults():
    est = pl.TFEstimator(lambda a, c: None, pl.Namespace())
    assert est.getBatchSize() == 100          # default
    est.setBatchSize(32).setClusterSize(4).setEpochs(2)
    assert est.getBatchSize() == 32
    assert est.getClusterSize() == 4
    assert est.getOrDefault("num_ps") == 0    # every mixin default registered
    assert est.getTagSet() == "serve"
    assert est.getSignatureDefKey() == "serving_default"
    assert "batch_size" in est.explainParams()


def test_setparams_rejects_unknown():
    est = pl.TFEstimator(lambda a, c: None)
    with pytest.raises(ValueError, match="no param"):
        est.setParams(nonexistent=1)


def test_tfparams_merge_args_params():
    args = pl.Namespace(lr=0.5, batch_size=7)
    est = pl.TFEstimator(lambda a, c: None, args)
    est.setBatchSize(64)
    merged = est.merge_args_params()
    assert merged.lr == 0.5
    assert merged.batch_size == 64            # set param wins over tf_args
    assert merged.epochs == 1                 # defaults flow in too


def test_params_copy_is_isolated():
    est = pl.TFEstimator(lambda a, c: None)
    est.setBatchSize(8)
    clone = est.copy({"batch_size": 16})
    assert est.getBatchSize() == 8
    assert clone.getBatchSize() == 16
    clone2 = est.copy({est.getParam("epochs"): 5})
    assert clone2.getEpochs() == 5


def test_param_grid_builder():
    est = pl.TFEstimator(lambda a, c: None)
    grid = (pl.ParamGridBuilder()
            .addGrid(est.getParam("batch_size"), [8, 16])
            .addGrid(est.getParam("epochs"), [1, 2, 3])
            .build())
    assert len(grid) == 6
    assert {frozenset((p.name, v) for p, v in g.items()) for g in grid} == {
        frozenset({("batch_size", b), ("epochs", e)})
        for b in (8, 16) for e in (1, 2, 3)}


# -- Pipeline / grid search over a dummy estimator --------------------------

def _mean_estimator(mod, frame):
    """``(estimator class, model class)`` predicting mean(y) + shift, built
    on package ``mod``'s pipeline classes and DataFrame ``frame``."""
    has_shift = mod._mixin("shift", "test shift", 0.0)

    class MeanModel(mod.Transformer):
        def _transform(self, df):
            return frame.DataFrame([frame.Row(y=r.y, pred=self._mean) for r in df.collect()],
                                   num_partitions=df.num_partitions)

    class MeanEstimator(mod.Estimator, has_shift):
        def _fit(self, df):
            model = MeanModel()
            model._mean = float(np.mean([r.y for r in df.collect()])) + self.getShift()
            return model

    return MeanEstimator


_MeanEstimator = _mean_estimator(pl, port_df)


def _neg_mse(out):  # higher is better
    return -float(np.mean([(r.pred - r.y) ** 2 for r in out.collect()]))


def test_pipeline_chains_stages():
    df = DataFrame([Row(y=float(i)) for i in range(8)])
    model = pl.Pipeline([_MeanEstimator()]).fit(df)
    assert isinstance(model, pl.PipelineModel)
    out = model.transform(df)
    assert out.columns == ["y", "pred"]
    assert out.collect()[0].pred == pytest.approx(3.5)


def test_train_validation_split_picks_best():
    df = DataFrame([Row(y=1.0) for _ in range(20)])
    est = _MeanEstimator()
    grid = pl.ParamGridBuilder().addGrid(est.getParam("shift"), [-1.0, 0.0, 2.0]).build()
    best = pl.TrainValidationSplit(est, _neg_mse, grid, trainRatio=0.5).fit(df)
    assert np.argmax(best.validationMetrics) == 1     # shift=0 wins
    assert best.transform(df).collect()[0].pred == pytest.approx(1.0)


def test_train_validation_split_empty_grid_raises():
    tvs = pl.TrainValidationSplit(_MeanEstimator(), lambda d: 0.0, [])
    with pytest.raises(ValueError, match="empty"):
        tvs.fit(DataFrame([Row(y=1.0)]))


def test_train_validation_split_shuffles_sorted_input():
    # rows sorted by y: a prefix cut would train only on low values
    df = DataFrame([Row(y=float(i)) for i in range(100)])
    est = _MeanEstimator()
    grid = pl.ParamGridBuilder().addGrid(est.getParam("shift"), [0.0]).build()
    best = pl.TrainValidationSplit(est, _neg_mse, grid, trainRatio=0.5).fit(df)
    # with a random split, train mean ≈ global mean (49.5), not prefix mean (24.5)
    assert abs(best.transform(df).collect()[0].pred - 49.5) < 8.0


def test_cross_validator_kfold_picks_best_and_refits_on_full_data():
    df = DataFrame([Row(y=1.0) for _ in range(21)])
    est = _MeanEstimator()
    grid = pl.ParamGridBuilder().addGrid(est.getParam("shift"), [-1.0, 0.0, 2.0]).build()
    best = pl.CrossValidator(est, _neg_mse, grid, numFolds=3).fit(df)
    assert len(best.avgMetrics) == 3
    assert int(np.argmax(best.avgMetrics)) == 1       # shift=0 wins
    # winner refit on the FULL frame (pyspark contract)
    assert best.transform(df).collect()[0].pred == pytest.approx(1.0)


def test_cross_validator_validates_inputs():
    est = _MeanEstimator()
    with pytest.raises(ValueError, match="numFolds"):
        pl.CrossValidator(est, lambda d: 0.0, [{}], numFolds=1)
    cv = pl.CrossValidator(est, lambda d: 0.0, [], numFolds=2)
    with pytest.raises(ValueError, match="empty"):
        cv.fit(DataFrame([Row(y=1.0) for _ in range(4)]))
    grid = pl.ParamGridBuilder().addGrid(est.getParam("shift"), [0.0]).build()
    cv = pl.CrossValidator(est, lambda d: 0.0, grid, numFolds=4)
    with pytest.raises(ValueError, match="folds"):
        cv.fit(DataFrame([Row(y=1.0) for _ in range(3)]))


def test_cross_validator_accepts_string_keyed_param_maps(caplog):
    import logging

    df = DataFrame([Row(y=1.0) for _ in range(9)])
    with caplog.at_level(logging.INFO):
        best = pl.CrossValidator(_MeanEstimator(), _neg_mse,
                                 [{"shift": 0.0}, {"shift": 2.0}], numFolds=3).fit(df)
    assert int(np.argmax(best.avgMetrics)) == 0


# -- TFModel.transform against a real export --------------------------------

def _export_linear(export_dir, w=3.0, b=-1.0):
    """Export ``y = w x + b`` as a serving signature (in-process, CPU)."""
    export_model(export_dir, lambda p, x: p["w"] * x + p["b"],
                 {"w": torch.tensor(w), "b": torch.tensor(b)},
                 [np.zeros((2,), np.float32)], input_names=["x"], output_names=["y"],
                 is_chief=True)
    return export_dir


@pytest.fixture()
def linear_export(tmp_path):
    return _export_linear(str(tmp_path / "export"))


def test_tfmodel_transform_with_mappings(linear_export):
    df = DataFrame([Row(feature=np.float32(i), other="junk") for i in range(10)],
                   num_partitions=3)
    model = pl.TFModel(device="cpu")
    model.setExportDir(linear_export).setBatchSize(4)
    model.setInputMapping({"feature": "x"}).setOutputMapping({"y": "prediction"})
    out = model.transform(df)
    assert out.columns == ["prediction"]
    preds = [float(r.prediction) for r in out.collect()]
    assert preds == pytest.approx([3.0 * i - 1.0 for i in range(10)])
    assert out.num_partitions == 3


def test_tfmodel_bad_signature_and_missing_export(linear_export):
    model = pl.TFModel(device="cpu")
    model.setExportDir(linear_export).setInputMapping({"x": "x"})
    model.setSignatureDefKey("nope")
    with pytest.raises(KeyError, match="nope"):
        model.transform(DataFrame([Row(x=np.float32(0))]))
    with pytest.raises(ValueError, match="export_dir"):
        pl.TFModel(device="cpu").transform(DataFrame([Row(x=np.float32(0))]))


def test_model_cache_is_singleton(linear_export):
    a = pl._load_model_cached(linear_export, "serve", "cpu")
    b = pl._load_model_cached(linear_export, "serve", "cpu")
    assert a is b


def test_model_cache_invalidated_on_reexport(linear_export):
    # grid search re-exports every point to the same dir: the cache must
    # serve the new weights, not the first fit's
    model = pl.TFModel(device="cpu")
    model.setExportDir(linear_export).setInputMapping({"x": "x"})
    df = DataFrame([Row(x=np.float32(1.0))])
    assert float(model.transform(df).collect()[0].y) == pytest.approx(2.0)  # 3x-1

    time.sleep(0.01)
    _export_linear(linear_export, w=10.0, b=0.0)
    os.utime(os.path.join(linear_export, "export_meta.json"))
    assert float(model.transform(df).collect()[0].y) == pytest.approx(10.0)


def test_transform_runs_partitions_concurrently(monkeypatch):
    """Partitions are processed in parallel threads, like the reference's
    mapPartitions on all executors."""
    active, peak = [0], [0]
    lock = threading.Lock()

    class _Sig:
        output_names = ["y"]

        def __call__(self, **feed):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.15)
            with lock:
                active[0] -= 1
            return {"y": torch.as_tensor(np.asarray(feed["x"]) * 2.0)}

    class _Model:
        def signature(self, key):
            return _Sig()

    monkeypatch.setattr(pl, "_load_model_cached", lambda d, t, dev: _Model())
    df = DataFrame.from_partitions(
        [[Row(x=float(i + 10 * p)) for i in range(3)] for p in range(4)])
    model = pl.TFModel(device="cpu")
    model.setExportDir("/nonexistent-fake")
    model.setBatchSize(8)
    got = sorted(r.y for r in model.transform(df).collect())
    assert got == sorted(float(i + 10 * p) * 2.0 for p in range(4) for i in range(3))
    assert peak[0] >= 2, f"partitions ran serially (peak concurrency {peak[0]})"


def test_driver_ps_nodes_rejected():
    from tensorflowonspark_tpu_torch.cluster import TPUCluster

    with pytest.raises(ValueError, match="driver_ps_nodes"):
        TPUCluster.run(_train_linear_export, {}, num_workers=2, num_ps=1,
                       driver_ps_nodes=True)


# -- end to end: fit on a real cluster, transform the export -----------------

def _train_linear_export(args, ctx):
    """Train ``y ≈ w x + b`` from the feed by SGD; the chief exports the
    serving signature that TFModel.transform loads back."""
    feed = ctx.get_data_feed(train_mode=True)
    w, b = torch.zeros(()), torch.zeros(())
    while not feed.should_stop():
        batch = feed.next_batch_arrays(args.batch_size, timeout=30)
        if batch is None:
            break
        x, y = (torch.as_tensor(np.asarray(a, np.float32)) for a in batch)
        err = w * x + b - y
        w, b = w - args.lr * 2 * (err * x).mean(), b - args.lr * 2 * err.mean()
    if ctx.is_chief:
        _export_linear(args.export_dir, w, b)


@pytest.mark.integration
def test_estimator_fit_then_transform(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 256).astype(np.float32)
    y = (2.0 * x).astype(np.float32)
    df = DataFrame([Row(x=float(a), y=float(b)) for a, b in zip(x, y)], num_partitions=4)
    args = pl.Namespace(lr=0.5, export_dir=str(tmp_path / "export"))
    est = pl.TFEstimator(_train_linear_export, args, device="cpu",
                         worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    (est.setClusterSize(1).setEpochs(4).setBatchSize(32)
        .setInputMapping({"x": "x"}).setOutputMapping({"y": "pred"}))
    model = est.fit(df)
    assert isinstance(model, pl.TFModel)
    out = model.transform(DataFrame([Row(x=np.float32(a)) for a in x], num_partitions=4))
    preds = np.array([float(r.pred) for r in out.collect()])
    np.testing.assert_allclose(preds, 2.0 * x, atol=0.15)


# -- parity with the JAX package's pipeline ----------------------------------

def _param_ops(mod):
    args = mod.Namespace(lr=0.5, batch_size=7, extra="kept")
    est = mod.TFEstimator(lambda a, c: None, args)
    est.setBatchSize(64).setEpochs(3).setInputMapping({"a": "x"}).setTagSet("serve,gpu")
    clone = est.copy({"cluster_size": 4, est.getParam("steps"): 9})
    grid = (mod.ParamGridBuilder().addGrid(est.getParam("batch_size"), [8, 16])
            .addGrid(est.getParam("epochs"), [1, 2]).baseOn({est.getParam("steps"): 5})
            .build())
    model = mod.TFModel(args).setBatchSize(3).setOutputMapping({"y": "p"})
    return (est.explainParams(), clone.explainParams(), model.explainParams(),
            vars(est.merge_args_params()), vars(clone.merge_args_params()),
            vars(model.merge_args_params()),
            [{p.name: v for p, v in g.items()} for g in grid])


def test_param_operations_match_reference():
    from tensorflowonspark_tpu import pipeline as jax_pl

    assert _param_ops(pl) == _param_ops(jax_pl)


def test_grid_search_matches_reference():
    from tensorflowonspark_tpu import dataframe as jax_df
    from tensorflowonspark_tpu import pipeline as jax_pl

    rows = [float(v) for v in np.random.default_rng(5).normal(size=30)]
    results = []
    for mod, frame in ((pl, port_df), (jax_pl, jax_df)):
        est = _mean_estimator(mod, frame)()
        grid = mod.ParamGridBuilder().addGrid(est.getParam("shift"), [-0.5, 0.0, 0.3]).build()
        df = frame.DataFrame([frame.Row(y=v) for v in rows], num_partitions=3)
        tvs = mod.TrainValidationSplit(est, _neg_mse, grid, trainRatio=0.6, seed=7).fit(df)
        cv = mod.CrossValidator(est, _neg_mse, grid, numFolds=4, seed=7).fit(df)
        results.append((tvs.validationMetrics, tvs.bestModel._mean,
                        cv.avgMetrics, cv.bestModel._mean))
    assert results[0] == results[1]


def test_linear_export_transform_matches_reference(tmp_path):
    from tensorflowonspark_tpu import dataframe as jax_df
    from tensorflowonspark_tpu import pipeline as jax_pl
    from tensorflowonspark_tpu.checkpoint import export_model as jax_export_model

    # multiples of 1/4: 3x - 1 is exact in float32 with or without a fused
    # multiply-add (XLA fuses, PyTorch's CPU kernels do not)
    xs = [np.float32(np.round(v * 4) / 4) for v in np.random.default_rng(1).normal(size=11) * 5]
    port_dir = _export_linear(str(tmp_path / "port"))
    jax_export_model(str(tmp_path / "jax"), lambda p, x: p["w"] * x + p["b"],
                     {"w": np.float32(3.0), "b": np.float32(-1.0)},
                     [np.zeros((2,), np.float32)], input_names=["x"], output_names=["y"],
                     is_chief=True)
    port = (pl.TFModel(device="cpu").setExportDir(port_dir).setBatchSize(4)
            .setOutputMapping({"y": "prediction"})
            .transform(DataFrame([Row(x=x) for x in xs], num_partitions=3)))
    ref = (jax_pl.TFModel().setExportDir(str(tmp_path / "jax")).setBatchSize(4)
           .setOutputMapping({"y": "prediction"})
           .transform(jax_df.DataFrame([jax_df.Row(x=x) for x in xs], num_partitions=3)))
    assert port.columns == ref.columns == ["prediction"]
    assert port.num_partitions == ref.num_partitions
    assert [float(r.prediction) for r in port.collect()] == \
        [float(r.prediction) for r in ref.collect()]
