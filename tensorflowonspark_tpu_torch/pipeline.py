"""ML-pipeline integration: Estimator/Model wrappers around the cluster.

Port of ``tensorflowonspark_tpu/pipeline.py``, the equivalent of the
reference's ``tensorflowonspark/pipeline.py``: a Spark-ML-style ``TFEstimator`` whose
``fit(df)`` runs distributed training via the cluster layer and returns a
``TFModel`` whose ``transform(df)`` runs batch inference from an exported
model with a per-process singleton model cache.

pyspark.ml itself is not in this environment, so the minimal Param /
Estimator / Transformer / Pipeline machinery the reference inherits from
``pyspark.ml.param`` and ``pyspark.ml.Pipeline`` is provided here with the
same shape (``Param``, ``Params.getOrDefault``, ``Has*`` mixins with
``set*/get*`` accessors, ``ParamGridBuilder``, ``TrainValidationSplit``) —
enough that the reference's headline capability, *hyperparameter grid search
over TF models with standard ML tooling* (``pipeline.py::TFEstimator``
docstring), works end to end.

Mapping to the reference:

- ``TFParams`` + ``Has*`` mixins → same names (``pipeline.py::TFParams``,
  ``HasBatchSize`` … ``HasTFRecordDir``).
- ``TFEstimator(train_fn, tf_args)._fit(df)`` → ``TPUCluster.run`` +
  ``cluster.train(df rows as positional lists)`` + ``shutdown`` →
  ``TFModel`` (``pipeline.py::TFEstimator._fit``).
- ``TFModel._transform(df)`` → per-partition batched inference against an
  :class:`~tensorflowonspark_tpu_torch.checkpoint.ExportedModel` loaded
  once per process by (export_dir, tag_set, device) and selected by
  ``signature_def_key`` (``pipeline.py::TFModel._transform`` /
  ``_run_model`` singleton), in threads of the driver, one a partition.

``TFModel`` loads the export on the card unless it is built with
``device="cpu"`` (``TFEstimator(..., device=...)`` hands its device to the
model it returns), as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import copy as _copy
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from tensorflowonspark_tpu_torch.cluster import InputMode, Partitioned, TPUCluster
from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Param machinery (the pyspark.ml.param subset the reference builds on)
# --------------------------------------------------------------------------

class Param:
    """A named parameter of a Params object (pyspark ``Param`` analogue)."""

    def __init__(self, parent: "Params", name: str, doc: str):
        self.parent = parent
        self.name = name
        self.doc = doc

    def __repr__(self) -> str:
        return f"Param({self.name})"


class Params:
    """Base class holding params, defaults, and user-set values."""

    def __init__(self):
        self._params: dict[str, Param] = {}
        self._defaults: dict[str, Any] = {}
        self._values: dict[str, Any] = {}
        # collect params + defaults declared by Has* mixins anywhere in the MRO
        for klass in type(self).__mro__:
            for pname, pdoc in klass.__dict__.get("_param_decls", {}).items():
                if pname not in self._params:
                    self._params[pname] = Param(self, pname, pdoc)
            for pname, pdefault in klass.__dict__.get("_param_defaults", {}).items():
                self._defaults.setdefault(pname, pdefault)

    # -- core accessors ------------------------------------------------------
    def hasParam(self, name: str) -> bool:
        return name in self._params

    def getParam(self, name: str) -> Param:
        return self._params[name]

    @property
    def params(self) -> list[Param]:
        return [self._params[n] for n in sorted(self._params)]

    def isSet(self, param: "Param | str") -> bool:
        return self._name_of(param) in self._values

    def isDefined(self, param: "Param | str") -> bool:
        name = self._name_of(param)
        return name in self._values or name in self._defaults

    def getOrDefault(self, param: "Param | str"):
        name = self._name_of(param)
        if name in self._values:
            return self._values[name]
        return self._defaults[name]

    def get(self, param: "Param | str", default=None):
        name = self._name_of(param)
        if name in self._values:
            return self._values[name]
        return self._defaults.get(name, default)

    def set(self, param: "Param | str", value) -> "Params":
        self._values[self._name_of(param)] = value
        return self

    def setParams(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if not self.hasParam(name):
                raise ValueError(f"{type(self).__name__} has no param '{name}'")
            self._values[name] = value
        return self

    def _setDefault(self, **kwargs) -> "Params":
        self._defaults.update(kwargs)
        return self

    def copy(self, extra: dict | None = None) -> "Params":
        """Deep-ish copy with optional {Param/name: value} overrides — the
        pyspark ``Params.copy(extra)`` used by grid search."""
        new = _copy.copy(self)
        new._values = dict(self._values)
        new._defaults = dict(self._defaults)
        new._params = {n: Param(new, p.name, p.doc) for n, p in self._params.items()}
        for k, v in (extra or {}).items():
            new._values[self._name_of(k)] = v
        return new

    def explainParams(self) -> str:
        lines = []
        for p in self.params:
            cur = (f"current: {self._values[p.name]}" if p.name in self._values
                   else (f"default: {self._defaults[p.name]}"
                         if p.name in self._defaults else "undefined"))
            lines.append(f"{p.name}: {p.doc} ({cur})")
        return "\n".join(lines)

    @staticmethod
    def _name_of(param: "Param | str") -> str:
        return param.name if isinstance(param, Param) else param


def _mixin(name: str, doc: str, default=None, has_default: bool = True):
    """Build a ``Has<name>`` mixin class with pyspark-style accessors.

    The reference declares ~19 of these one class at a time
    (``pipeline.py::HasBatchSize`` etc.); generating them keeps the public
    surface identical (``setBatchSize``/``getBatchSize``) without 400 lines
    of boilerplate.
    """
    # acronyms the reference capitalizes in accessor names (setNumPS,
    # setDriverPSNodes, setTFRecordDir — pipeline.py::Has* upstream)
    acronyms = {"ps": "PS", "tfrecord": "TFRecord"}
    cap = "".join(acronyms.get(part, part[0].upper() + part[1:])
                  for part in name.split("_") if part)

    def setter(self, value):
        return self.set(name, value)

    def getter(self):
        return self.getOrDefault(name)

    attrs = {
        "_param_decls": {name: doc},
        f"set{cap}": setter,
        f"get{cap}": getter,
    }
    if has_default:
        # declarative: Params.__init__ collects these across the whole MRO
        # (a per-mixin __init__ would be shadowed under multiple inheritance)
        attrs["_param_defaults"] = {name: default}
    return type(f"Has{cap}", (Params,), attrs)


# The reference's mixin family, defaults mirroring TFCluster/TFSparkNode
# defaults.
HasBatchSize = _mixin("batch_size", "number of samples per batch", 100)
HasClusterSize = _mixin("cluster_size", "number of nodes in the cluster", 1)
HasNumPS = _mixin("num_ps", "number of ps/embedding-shard nodes", 0)
HasEpochs = _mixin("epochs", "number of epochs to train", 1)
HasSteps = _mixin("steps", "max steps to train", 1000)
HasInputMode = _mixin("input_mode", "InputMode.SPARK or InputMode.TENSORFLOW",
                      InputMode.SPARK)
HasInputMapping = _mixin("input_mapping", "{df column: signature input name}", None)
HasOutputMapping = _mixin("output_mapping", "{signature output name: df column}", None)
HasModelDir = _mixin("model_dir", "directory for training checkpoints", None)
HasExportDir = _mixin("export_dir", "directory for the exported serving model", None)
HasSignatureDefKey = _mixin("signature_def_key", "serving signature to run",
                            "serving_default")
HasTagSet = _mixin("tag_set", "export tag set (CSV or list)", "serve")
HasProtocol = _mixin("protocol", "transport: 'grpc'|'grpc+verbs' (advisory on TPU)",
                     "grpc")
HasTensorboard = _mixin("tensorboard", "launch TensorBoard on the chief", False)
HasMasterNode = _mixin("master_node", "job name of the master/chief node", None)
# reference default is 30s; here feeding is synchronous (train() returns only
# after delivery), so shutdown rarely needs a grace period — default 0.
HasGraceSecs = _mixin("grace_secs", "grace period before shutdown", 0)
HasDriverPSNodes = _mixin("driver_ps_nodes", "run ps nodes on the driver", False)
HasReaders = _mixin("readers", "number of reader threads per node", 1)
HasTFRecordDir = _mixin("tfrecord_dir", "directory of TFRecord input data", None)


class Namespace(argparse.Namespace):
    """Attribute bag for tf_args; the reference re-exports an equivalent
    (``pipeline.py::Namespace``) so user code can build args without
    argparse."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__(**(dict(d or {}) | kwargs))


class TFParams(Params):
    """Params + the argv merge: combine the estimator's set params into the
    user's ``tf_args`` namespace.  Reference: ``pipeline.py::TFParams.merge_args_params``.
    """

    def __init__(self, tf_args=None):
        super().__init__()
        self.args = tf_args if tf_args is not None else Namespace()

    def merge_args_params(self) -> argparse.Namespace:
        merged = Namespace(vars(self.args) if hasattr(self.args, "__dict__") else {})
        for p in self.params:
            if self.isSet(p):                      # explicit set* wins over tf_args
                setattr(merged, p.name, self._values[p.name])
            elif p.name in self._defaults and not hasattr(merged, p.name):
                setattr(merged, p.name, self._defaults[p.name])  # defaults fill gaps
        return merged


# --------------------------------------------------------------------------
# Estimator / Transformer / Pipeline (pyspark.ml analogues)
# --------------------------------------------------------------------------

class Estimator(Params):
    def fit(self, df: DataFrame, params: dict | None = None):
        if params:
            return self.copy(params).fit(df)
        return self._fit(df)

    def _fit(self, df: DataFrame):
        raise NotImplementedError


class Transformer(Params):
    def transform(self, df: DataFrame, params: dict | None = None) -> DataFrame:
        if params:
            return self.copy(params).transform(df)
        return self._transform(df)

    def _transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError


class Pipeline(Estimator):
    """Chain of estimators/transformers (pyspark ``Pipeline`` analogue)."""

    def __init__(self, stages: Sequence):
        super().__init__()
        self.stages = list(stages)

    def _fit(self, df: DataFrame) -> "PipelineModel":
        fitted = []
        for i, stage in enumerate(self.stages):
            if isinstance(stage, Estimator):
                model = stage.fit(df)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"stage {i} is neither Estimator nor Transformer")
            fitted.append(model)
            if i < len(self.stages) - 1:
                df = model.transform(df)
        return PipelineModel(fitted)


class PipelineModel(Transformer):
    def __init__(self, stages: Sequence[Transformer]):
        super().__init__()
        self.stages = list(stages)

    def _transform(self, df: DataFrame) -> DataFrame:
        for stage in self.stages:
            df = stage.transform(df)
        return df


class ParamGridBuilder:
    """Cartesian-product param grids for search (pyspark analogue)."""

    def __init__(self):
        self._grid: dict[Param, list] = {}

    def addGrid(self, param: Param, values: Iterable) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *pairs) -> "ParamGridBuilder":
        for param, value in (pairs[0].items() if len(pairs) == 1
                             and isinstance(pairs[0], dict) else pairs):
            self._grid[param] = [value]
        return self

    def build(self) -> list[dict]:
        import itertools

        keys = list(self._grid)
        combos = itertools.product(*(self._grid[k] for k in keys))
        return [dict(zip(keys, c)) for c in combos]


class TrainValidationSplit(Estimator):
    """Single train/validation split over a param grid — the simplest grid
    searcher (pyspark ``TrainValidationSplit`` analogue; the reference's
    README demonstrates TFoS under exactly this kind of tuning)."""

    def __init__(self, estimator: Estimator, evaluator: Callable[[DataFrame], float],
                 estimatorParamMaps: Sequence[dict], trainRatio: float = 0.75,
                 seed: int = 0):
        super().__init__()
        self.estimator = estimator
        self.evaluator = evaluator  # model-transformed df -> metric (higher better)
        self.estimatorParamMaps = list(estimatorParamMaps)
        self.trainRatio = trainRatio
        self.seed = seed

    def _fit(self, df: DataFrame) -> "TrainValidationSplitModel":
        if not self.estimatorParamMaps:
            raise ValueError("estimatorParamMaps is empty — nothing to search")
        rows = df.collect()
        # seeded random split (pyspark randomSplit analogue) — an order-based
        # prefix cut would bias train/val when rows arrive sorted
        order = np.random.default_rng(self.seed).permutation(len(rows))
        cut = int(len(rows) * self.trainRatio)
        train = DataFrame([rows[i] for i in order[:cut]], columns=df.columns,
                          num_partitions=df.num_partitions)
        val = DataFrame([rows[i] for i in order[cut:]], columns=df.columns,
                        num_partitions=df.num_partitions)
        best_model, best_metric, metrics = None, -float("inf"), []
        for params in self.estimatorParamMaps:
            model = self.estimator.fit(train, params)
            metric = self.evaluator(model.transform(val))
            metrics.append(metric)
            logger.info("grid point %s -> %.6f",
                        {getattr(p, "name", p): v for p, v in params.items()},
                        metric)
            if best_model is None or metric > best_metric:
                best_model, best_metric = model, metric
        return TrainValidationSplitModel(best_model, metrics)


class TrainValidationSplitModel(Transformer):
    def __init__(self, bestModel: Transformer, validationMetrics: list[float]):
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics

    def _transform(self, df: DataFrame) -> DataFrame:
        return self.bestModel.transform(df)


class CrossValidator(Estimator):
    """K-fold grid search (pyspark ``CrossValidator`` analogue).

    Each grid point is scored as the mean of ``numFolds`` held-out-fold
    metrics (seeded shuffle → contiguous fold slices, pyspark's scheme);
    the winner is refit on the FULL DataFrame — the pyspark contract.
    """

    def __init__(self, estimator: Estimator,
                 evaluator: Callable[[DataFrame], float],
                 estimatorParamMaps: Sequence[dict], numFolds: int = 3,
                 seed: int = 0):
        super().__init__()
        if numFolds < 2:
            raise ValueError(f"numFolds must be >= 2, got {numFolds}")
        self.estimator = estimator
        self.evaluator = evaluator  # transformed df -> metric (higher better)
        self.estimatorParamMaps = list(estimatorParamMaps)
        self.numFolds = numFolds
        self.seed = seed

    def _fit(self, df: DataFrame) -> "CrossValidatorModel":
        if not self.estimatorParamMaps:
            raise ValueError("estimatorParamMaps is empty — nothing to search")
        rows = df.collect()
        if len(rows) < self.numFolds:
            raise ValueError(
                f"{len(rows)} rows cannot form {self.numFolds} folds")
        order = np.random.default_rng(self.seed).permutation(len(rows))
        bounds = np.linspace(0, len(rows), self.numFolds + 1).astype(int)

        def fold(i):
            val_idx = order[bounds[i]:bounds[i + 1]]
            train_idx = np.concatenate([order[:bounds[i]],
                                        order[bounds[i + 1]:]])
            mk = lambda idx: DataFrame(  # noqa: E731
                [rows[j] for j in idx], columns=df.columns,
                num_partitions=df.num_partitions)
            return mk(train_idx), mk(val_idx)

        folds = [fold(i) for i in range(self.numFolds)]  # seed-fixed; share
        avg_metrics = []
        for params in self.estimatorParamMaps:
            scores = []
            for train, val in folds:
                model = self.estimator.fit(train, params)
                scores.append(self.evaluator(model.transform(val)))
            avg_metrics.append(float(np.mean(scores)))
            logger.info("cv grid point %s -> %.6f",
                        {getattr(p, "name", p): v for p, v in params.items()},
                        avg_metrics[-1])
        best = int(np.argmax(avg_metrics))
        best_model = self.estimator.fit(df, self.estimatorParamMaps[best])
        return CrossValidatorModel(best_model, avg_metrics)


class CrossValidatorModel(Transformer):
    def __init__(self, bestModel: Transformer, avgMetrics: list[float]):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics

    def _transform(self, df: DataFrame) -> DataFrame:
        return self.bestModel.transform(df)


# --------------------------------------------------------------------------
# TFEstimator / TFModel
# --------------------------------------------------------------------------

class TFEstimator(TFParams, Estimator,
                  HasBatchSize, HasClusterSize, HasNumPS, HasEpochs, HasSteps,
                  HasInputMode, HasInputMapping, HasOutputMapping, HasModelDir,
                  HasExportDir, HasSignatureDefKey, HasTagSet, HasProtocol,
                  HasTensorboard, HasMasterNode, HasGraceSecs, HasDriverPSNodes,
                  HasReaders, HasTFRecordDir):
    """Train a model on a cluster from a DataFrame; returns a :class:`TFModel`.

    Reference: ``pipeline.py::TFEstimator`` — ``train_fn(args, ctx)`` is the
    user's distributed training function (same signature as
    ``TPUCluster.run``'s ``map_fun``), ``tf_args`` the opaque namespace it
    receives, ``export_fn`` an optional driver-side post-training export hook.
    ``device`` is where the returned :class:`TFModel` serves (the card
    unless ``"cpu"``); the workers pick their own device in ``train_fn``.
    """

    def __init__(self, train_fn: Callable, tf_args=None,
                 export_fn: Callable | None = None, backend_factory=None,
                 worker_env: dict | None = None, device=None):
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.backend_factory = backend_factory  # for tests / custom backends
        self.worker_env = worker_env
        self.device = device
        super().__init__(tf_args)

    def _fit(self, df: DataFrame) -> "TFModel":
        args = self.merge_args_params()
        num_workers = self.getOrDefault("cluster_size")
        input_mode = self.getOrDefault("input_mode")
        logger.info("TFEstimator.fit: %d workers, input_mode=%s",
                    num_workers, input_mode)
        if self.getOrDefault("tensorboard"):
            raise NotImplementedError(
                "tensorboard=True: the port does not launch TensorBoard yet "
                "(ROADMAP A2r); the Estimator writes event files under "
                "model_dir/tensorboard")
        backend = self.backend_factory() if self.backend_factory else None
        cluster = TPUCluster.run(
            self.train_fn, args, num_workers,
            num_ps=self.getOrDefault("num_ps"),
            input_mode=input_mode,
            master_node=self.getOrDefault("master_node"),
            driver_ps_nodes=self.getOrDefault("driver_ps_nodes"),
            backend=backend, worker_env=self.worker_env)
        try:
            if input_mode == InputMode.SPARK:
                # rows are fed as positional lists, one feed-partition per df
                # partition — the reference's `df.rdd.map(list)` (SURVEY §3.4)
                cluster.train(Partitioned(df.to_lists()),
                              num_epochs=self.getOrDefault("epochs"))
        except BaseException:
            # a failed feed must not leak the worker cluster (each failed
            # grid point would otherwise strand a full process group)
            for cleanup in (cluster.backend.terminate, cluster.server.stop):
                try:
                    cleanup()
                except Exception:
                    logger.warning("cluster cleanup after failed train() also "
                                   "failed in %s", cleanup.__name__, exc_info=True)
            raise
        cluster.shutdown(grace_secs=self.getOrDefault("grace_secs"))
        if self.export_fn is not None:
            self.export_fn(args)
        # hand the model only explicitly-set params; args already carries the
        # merged view, and copying defaults as set values would mask tf_args
        return TFModel(args, device=self.device).copy(
            {p.name: self._values[p.name] for p in self.params if self.isSet(p)})


# per-process singleton cache: (export_dir, tag_set, export mtime, device) -> model.
# Reference: the module-global SavedModel singleton in pipeline.py::_run_model
# ("per-executor singleton SavedModel cache").  The mtime of the export's
# metadata file is part of the key so a re-export to the same directory (every
# grid point of a TrainValidationSplit writes args.export_dir) invalidates the
# cached weights instead of silently serving the first grid point's model.
_MODEL_CACHE: dict[tuple, Any] = {}
_MODEL_CACHE_LOCK = threading.Lock()


def _load_model_cached(export_dir: str, tag_set, device=None):
    from tensorflowonspark_tpu_torch.checkpoint import ExportedModel, _META_NAME
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device(device)
    meta_path = os.path.join(export_dir, _META_NAME)
    version = os.path.getmtime(meta_path) if os.path.exists(meta_path) else -1.0
    key = (export_dir,
           tuple(tag_set.split(",")) if isinstance(tag_set, str)
           else tuple(tag_set or ()),
           str(device), version)
    # lock: _transform's partition threads race to the first load
    with _MODEL_CACHE_LOCK:
        if key not in _MODEL_CACHE:
            # drop superseded versions of this export so re-fits don't accumulate
            for stale in [k for k in _MODEL_CACHE if k[:3] == key[:3]]:
                del _MODEL_CACHE[stale]
            _MODEL_CACHE[key] = ExportedModel.load(export_dir, tag_set, device=device)
        return _MODEL_CACHE[key]


def _to_numpy(t) -> np.ndarray:
    """A signature output (a tensor on any device) as a host array; bf16,
    which numpy lacks, as float32."""
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class TFModel(TFParams, Transformer,
              HasBatchSize, HasInputMapping, HasOutputMapping, HasModelDir,
              HasExportDir, HasSignatureDefKey, HasTagSet):
    """Batch inference from an exported model over a DataFrame.

    Reference: ``pipeline.py::TFModel._transform`` — plain per-partition
    mapping (no cluster): load the export once per process, select the
    signature by ``signature_def_key``, feed ``input_mapping`` columns,
    emit ``output_mapping`` columns, batching rows by ``batch_size``.
    The export serves on ``device``: the card unless ``"cpu"``.
    """

    def __init__(self, tf_args=None, device=None):
        self.device = device
        super().__init__(tf_args)

    def _transform(self, df: DataFrame) -> DataFrame:
        # merge_args_params fills every declared default, so args is the
        # single source of truth here — no per-field literal fallbacks
        args = self.merge_args_params()
        export_dir = args.export_dir
        if not export_dir:
            raise ValueError("TFModel requires export_dir (setExportDir or tf_args)")
        batch_size = args.batch_size
        if not isinstance(batch_size, int) or batch_size < 1:
            raise ValueError(f"batch_size must be a positive int, got {batch_size!r}")
        sig_key = args.signature_def_key
        tag_set = args.tag_set
        input_mapping = args.input_mapping or {c: c for c in df.columns}
        output_mapping = args.output_mapping

        in_columns = list(input_mapping)          # df columns to read
        in_names = [input_mapping[c] for c in in_columns]  # signature inputs
        col_idx = [df.columns.index(c) for c in in_columns]

        def _run_partition(rows: list[Row]) -> list[Row]:
            model = _load_model_cached(export_dir, tag_set, self.device)
            sig = model.signature(sig_key)
            out_names = list(output_mapping) if output_mapping else sig.output_names
            out_cols = ([output_mapping[n] for n in out_names] if output_mapping
                        else out_names)
            results: list[Row] = []
            for start in range(0, len(rows), batch_size):
                chunk = rows[start:start + batch_size]
                feed = {name: np.stack([np.asarray(r[i]) for r in chunk])
                        for name, i in zip(in_names, col_idx)}
                outs = sig(**feed)
                batched = [_to_numpy(outs[n]) for n in out_names]
                for j in range(len(chunk)):
                    results.append(Row(
                        _fields=out_cols,
                        _values=[col[j] if col.ndim else col for col in batched]))
            return results

        # Partitions run CONCURRENTLY, as the reference's transform ran on
        # all executors in parallel via mapPartitions.  On the card the
        # exported program is host-bound, and threads that share one
        # interpreter and one stream were measured slower than a single
        # partition (PERF.md §6); the reference's thread count is kept.
        # cap: threads block on device compute/IO, not the host CPU, so the
        # pool is sized by partition count, not cpu_count (which is 1 in
        # constrained containers and would serialize everything)
        parts = df.partitions
        workers = min(len(parts), 8)
        if workers <= 1:
            out_parts = [_run_partition(p) for p in parts]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                out_parts = list(pool.map(_run_partition, parts))
        return DataFrame.from_partitions(out_parts)
