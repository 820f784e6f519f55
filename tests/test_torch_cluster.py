"""The port's first slice end to end on the CPU: driver-fed BERT QA inference.

Two CPU workers run ``TPUCluster.run`` + ``cluster.inference`` over SQuAD-
shaped rows at a tiny width, with weights carried across from the JAX
package's flax module.  The answers must come back in row order, equal a
single-process port forward of the same rows, and agree with the flax
model (its flash path, Pallas in interpret mode).

Tolerances: against the in-process port forward ``atol=1e-5`` (float32;
the workers run one torch thread, so matmul sums may be blocked
differently); against flax ``atol=1e-4``, as in ``test_torch_bert.py``.
"""

import ast
import importlib
import json
import os
import subprocess
import sys

import flax
import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models.bert import BertConfig as JaxBertConfig
from tensorflowonspark_tpu.models.bert import \
    BertForQuestionAnswering as JaxBertQA
from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu_torch.bert_inference import (build_model,
                                                        forward_batch,
                                                        make_rows, map_fun,
                                                        run_inference)
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.models.bert import params_from_flax
from tensorflowonspark_tpu_torch.shm import SEG_PREFIX

pytestmark = pytest.mark.integration

TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64, dtype="float32")
T = 40
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _leftover_segments(pids) -> list[str]:
    """``/dev/shm`` segments created by these processes (the segment name
    carries its creator's pid), so other tests' live segments don't count."""
    tags = {f"-{pid}-" for pid in pids}
    return [n for n in os.listdir("/dev/shm")
            if n.startswith(SEG_PREFIX) and any(t in n for t in tags)]


def test_two_worker_inference_matches_port_and_flax(tmp_path):
    rows = make_rows(20, T, TINY["vocab_size"], seed=1, min_len=12)
    ids, mask, types = (np.stack([r[i] for r in rows]) for i in range(3))
    jcfg = JaxBertConfig(**{**TINY, "dtype": jax.numpy.float32}, dropout_rate=0.0,
                         attention_fn=lambda q, k, v, mask=None: jax_flash(
                             q, k, v, mask=mask, block_q=16, block_k=16,
                             interpret=True))
    variables = JaxBertQA(jcfg).init(jax.random.key(0), ids[:2], mask[:2], types[:2])
    params = jax.tree_util.tree_map(
        np.asarray, flax.core.meta.unbox(variables["params"]))
    state_dict = params_from_flax(params)

    results, stats = run_inference(
        rows, TINY, batch_size=4, num_workers=2, device="cpu",
        state_dict=state_dict, worker_env=WORKER_ENV,
        working_dir=str(tmp_path), timeout=120)

    assert len(results) == len(rows)
    assert [s["rows"] for s in stats] == [10, 10]
    assert [s["batches"] for s in stats] == [3, 3]      # 4 + 4 + a padded 2
    assert [s["launches"] for s in stats] == [0, 0]     # CPU: the plain version
    got_start = np.stack([r[0] for r in results])
    got_end = np.stack([r[1] for r in results])
    assert got_start.dtype == np.float32 and got_start.shape == (20, T)

    # the same rows, one process, partitioned and batched as the workers were
    model = build_model({"config": TINY, "state_dict": state_dict}, torch.device("cpu"))
    want = []
    with torch.inference_mode():
        for part in (rows[:10], rows[10:]):
            for i in range(0, 10, 4):
                batch = [np.stack([r[c] for r in part[i:i + 4]]) for c in range(3)]
                want.append(forward_batch(model, batch, 4, "cpu"))
    np.testing.assert_allclose(got_start, np.concatenate([w[0] for w in want]), atol=1e-5)
    np.testing.assert_allclose(got_end, np.concatenate([w[1] for w in want]), atol=1e-5)

    j_start, j_end = JaxBertQA(jcfg).apply({"params": params}, ids, mask, types)
    np.testing.assert_allclose(got_start, np.asarray(j_start), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_end, np.asarray(j_end), atol=1e-4, rtol=0)
    assert _leftover_segments([os.getpid()]) == []


def test_map_fun_error_surfaces_at_shutdown(tmp_path):
    rows = make_rows(2, T, TINY["vocab_size"], seed=2)
    rows[1][0][3] = TINY["vocab_size"] + 7          # a token past the vocab
    args = {"config": TINY, "seed": 0, "batch_size": 8, "device": "cpu",
            "feed_timeout": 60}
    cluster = TPUCluster.run(map_fun, args, 1, input_mode=InputMode.SPARK,
                             reservation_timeout=60, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path))
    pids = [os.getpid()] + [p.pid for p in cluster.backend.procs]
    # the worker needs the EndPartition marker before it runs the batch, so
    # the feed completes and the failure can only come back at shutdown
    cluster.train(rows)
    with pytest.raises(RuntimeError, match="IndexError"):
        cluster.shutdown(timeout=60)
    assert _leftover_segments(pids) == []


def _allreduce_fun(args, ctx):
    """Join the cluster's torch.distributed group and sum executor ids + 1."""
    import torch
    import torch.distributed as dist

    ctx.initialize_distributed(device="cpu")
    t = torch.tensor([float(ctx.executor_id + 1)])
    dist.all_reduce(t)
    dist.destroy_process_group()
    with open(os.path.join(ctx.working_dir, f"allreduce.{ctx.executor_id}"), "w") as f:
        f.write(str(t.item()))


def test_initialize_distributed_joins_a_gloo_group(tmp_path):
    cluster = TPUCluster.run(_allreduce_fun, {}, 2, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=60, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path))
    cluster.shutdown(timeout=60)
    assert [(tmp_path / f"allreduce.{i}").read_text() for i in range(2)] == ["3.0", "3.0"]


def test_device_default_is_the_card():
    from tensorflowonspark_tpu_torch.util import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(None)


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transformers", "tensorflowonspark_tpu")
PACKAGE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "tensorflowonspark_tpu_torch")


def _forbidden(name: str) -> bool:
    # "tensorflowonspark_tpu_torch" shares the JAX package's prefix: compare
    # whole top-level names, never prefixes
    return name.split(".")[0] in _FORBIDDEN


def test_port_imports_no_jax_nor_the_jax_package():
    """Importing every module of the port, in a fresh interpreter, loads no
    JAX-family module and no module of ``tensorflowonspark_tpu``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import tensorflowonspark_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'imported': names, 'new': sorted(set(sys.modules) - before)}))\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(PACKAGE_DIR), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tensorflowonspark_tpu_torch.ops.flash_attention" in report["imported"]
    assert "tensorflowonspark_tpu_torch.bert_inference" in report["imported"]
    assert "tensorflowonspark_tpu_torch.bert_train" in report["imported"]
    assert "tensorflowonspark_tpu_torch.parallel.strategy" in report["imported"]
    for name in ("models.resnet", "models.mnist", "data", "device_info", "gpu_info",
                 "resnet_train", "mnist_train", "bench_resnet", "filesystem", "tfrecord",
                 "example_proto", "dataframe", "dfutil", "preemption", "checkpoint",
                 "pipeline", "estimator", "examples.mnist.mnist_pipeline",
                 "examples.mnist.mnist_estimator", "examples.bert.bert_squad",
                 "models.gpt", "models.kv_pages", "models.convert", "ops.quant", "ops.xent",
                 "examples.gpt.gpt_tiny", "bench_gpt_decode", "models.serving",
                 "examples.gpt.serving_demo", "examples.gpt.cluster_serving",
                 "bench_batcher"):
        assert f"tensorflowonspark_tpu_torch.{name}" in report["imported"], name
    assert [m for m in report["new"] if _forbidden(m)] == []


def _reference_root_imports() -> list[tuple[str, str]]:
    """``(module, name)`` for every name the JAX package's root imports:
    ``from tensorflowonspark_tpu.<module> import <name>`` gives
    ``(module, name)``, ``from tensorflowonspark_tpu import <module>``
    gives ``(module, None)``."""
    root = os.path.join(os.path.dirname(PACKAGE_DIR), "tensorflowonspark_tpu", "__init__.py")
    with open(root) as fh:
        tree = ast.parse(fh.read(), root)
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "tensorflowonspark_tpu":
            out += [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "tensorflowonspark_tpu."):
            module = node.module.split(".", 1)[1]
            out += [(module, a.name) for a in node.names if not a.name.startswith("_")]
    return out


def test_root_exports_what_the_reference_root_exports_for_ported_modules():
    """For every module of the JAX package's root imports that the port
    has, the port's root exports the same names (the same objects as the
    port module's), and ``from tensorflowonspark_tpu_torch import
    Dataset`` and the rest work — in a fresh interpreter that loads no JAX
    module on the way."""
    expected = []
    for module, name in _reference_root_imports():
        if not os.path.exists(os.path.join(PACKAGE_DIR, *module.split(".")) + ".py"):
            continue                              # not ported yet
        if name is None:
            expected.append((module, None))
        elif hasattr(importlib.import_module(f"tensorflowonspark_tpu_torch.{module}"), name):
            expected.append((module, name))
    names = {name for _, name in expected}
    assert {"Dataset", "device_prefetch", "DataFrame", "Row", "CheckpointManager",
            "ExportedModel", "export_model", "save_checkpoint", "restore_checkpoint",
            "PreemptionGuard", "TPUCluster", "InputMode", "DataFeed", "NodeContext",
            "run_with_recovery", "Estimator", "EvalSpec", "TrainSpec", "train_and_evaluate",
            "Namespace", "Pipeline", "ParamGridBuilder", "TFEstimator", "TFModel",
            "TrainValidationSplit", "CrossValidator"} <= names
    code = (
        "import importlib, json, sys\n"
        "import tensorflowonspark_tpu_torch as p\n"
        f"expected = {expected!r}\n"
        "def exported(m, n):\n"
        "    mod = importlib.import_module('tensorflowonspark_tpu_torch.' + m)\n"
        "    return getattr(p, m, None) is mod if n is None else "
        "getattr(p, n, None) is getattr(mod, n)\n"
        "bad = [(m, n) for m, n in expected if not exported(m, n)]\n"
        "from tensorflowonspark_tpu_torch import (Dataset, device_prefetch, DataFrame, Row, "
        "CheckpointManager, ExportedModel, export_model, save_checkpoint, restore_checkpoint, "
        "PreemptionGuard)\n"
        "print(json.dumps({'bad': bad, 'jax': sorted(m for m in sys.modules "
        "if m.split('.')[0] in %r)}))\n" % (_FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(PACKAGE_DIR), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"bad": [], "jax": []}


def _reference_package_imports(package: str) -> list[tuple[str, str]]:
    """``(module, name)`` for every ``from tensorflowonspark_tpu.<package>.<module>
    import <name>`` in the JAX package's ``<package>/__init__.py``."""
    path = os.path.join(os.path.dirname(PACKAGE_DIR), "tensorflowonspark_tpu", package,
                        "__init__.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    prefix = f"tensorflowonspark_tpu.{package}."
    return [(node.module[len(prefix):], a.name) for node in tree.body
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(prefix)
            for a in node.names]


#: names the port leaves out, each waiting for its queue item:
#: ``shard_quantized`` and the serving package's gang replica, both for
#: A6 part 2's serving half
NOT_PORTED_YET = {("ops", "quant", "shard_quantized"),
                  ("serving", "sharded", "GangShardLost"),
                  ("serving", "sharded", "GangSpec"),
                  ("serving", "sharded", "serve_sharded_replica")}

#: packages whose ``__init__`` re-exports every submodule's names: a name
#: of a module the port has not got counts as missing there, so each wait
#: is listed in :data:`NOT_PORTED_YET` rather than skipped
WHOLE_PACKAGES = {"serving", "batch", "continual", "parallel"}


@pytest.mark.parametrize("package", ["models", "ops", "parallel", "serving", "batch",
                                     "continual"])
def test_models_and_ops_export_the_reference_names_of_ported_modules(package):
    """For every module of the JAX package's ``models``/``ops``/``parallel``
    imports that the port has — and every name of its ``serving``, ``batch``
    and ``continual`` packages —
    the port's package exports the same names (the port module's objects),
    the only gaps being :data:`NOT_PORTED_YET` — in a fresh interpreter
    that loads no JAX-family module."""
    expected, missing = [], set()
    for module, name in _reference_package_imports(package):
        if not os.path.exists(os.path.join(PACKAGE_DIR, package, module + ".py")):
            if package in WHOLE_PACKAGES:
                missing.add((package, module, name))
            continue                              # not ported yet
        mod = importlib.import_module(f"tensorflowonspark_tpu_torch.{package}.{module}")
        if hasattr(mod, name):
            expected.append((module, name))
        else:
            missing.add((package, module, name))
    assert missing == {m for m in NOT_PORTED_YET if m[0] == package}
    assert {"gpt", "convert", "quant", "xent", "embedding", "scheduler", "job",
            "publisher"} & {m for m, _ in expected}
    if package == "batch":
        assert {"BatchJob", "GridSearch", "expand_param_grid", "ProgressLedger", "Shard",
                "ShardManifest", "batch_worker", "ShardWriter", "iter_part", "iter_results",
                "read_results"} <= {n for _, n in expected}
    if package == "continual":
        assert {"CONTINUAL_QUEUES", "PUBLISH_QUEUE", "CheckpointPublisher", "Publication",
                "PublicationCollector", "build_published_full", "diff_params",
                "flatten_params", "payload_digest", "payload_nbytes", "replace_leaves",
                "OUTCOMES", "ContinualPipeline", "OfflineEval",
                "candidate_trial_params"} <= {n for _, n in expected}
    if package == "serving":
        assert {"AOTExecutableCache", "ServingCluster", "ServeFrontend", "ServeClient",
                "FrontendUnavailable", "serve_replica", "StandbyPool", "serve_standby",
                "ReplicaScheduler", "RequestRejected", "DeadlineExceeded",
                "Autoscaler", "AutoscalerConfig", "serve_disagg_replica", "resume_driver",
                "resume_rollouts", "ControlPlaneJournal", "JournalState", "ModelRegistry",
                "ModelVersion", "RolloutController", "RolloutError", "RolloutPolicy",
                "apply_adapter"} \
            <= {n for _, n in expected}
    if package == "parallel":
        assert {"PipelineStrategy", "pipeline_apply", "pipeline_value_and_grad",
                "stack_stage_params", "make_moe_layer", "moe_apply"} <= {n for _, n in expected}
    if package == "models":
        assert {"WideDeep", "InceptionV3", "UNet", "BertForSequenceClassification",
                "ContinuousBatcher", "DraftModel"} <= {n for _, n in expected}
    code = (
        "import importlib, json, sys\n"
        f"pkg = importlib.import_module('tensorflowonspark_tpu_torch.{package}')\n"
        f"expected = {expected!r}\n"
        "bad = [(m, n) for m, n in expected if getattr(pkg, n, None) is not getattr("
        f"importlib.import_module('tensorflowonspark_tpu_torch.{package}.' + m), n)]\n"
        "print(json.dumps({'bad': bad, 'jax': sorted(m for m in sys.modules "
        "if m.split('.')[0] in %r)}))\n" % (_FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(PACKAGE_DIR), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"bad": [], "jax": []}


def test_port_sources_name_no_jax_import():
    """No import statement in the port's sources or in ``chip_smoke.py``
    names a forbidden module, even one a code path has not reached yet."""
    paths = [os.path.join(os.path.dirname(PACKAGE_DIR), "chip_smoke.py")]
    for root, _, files in os.walk(PACKAGE_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_device_info_over_torch_cuda():
    from tensorflowonspark_tpu_torch import device_info, gpu_info

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert device_info.num_local_devices() == gpu_info.num_local_devices() == n
    assert [d["id"] for d in device_info.device_summary()] == list(range(n))
    assert device_info.visibility_env([0, 2]) == {"CUDA_VISIBLE_DEVICES": "0,2"}
    assert device_info.visibility_env() == {}
    assert gpu_info.get_gpus(2) == ",".join(map(str, range(min(n, 2))))
    # no card: the worker's index modulo the (empty) device count, as the JAX shim
    assert device_info.get_gpus(1, worker_index=3, format_as_csv=False) == [0]
