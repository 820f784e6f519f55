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


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflowonspark_tpu")
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
                 "resnet_train", "mnist_train", "bench_resnet"):
        assert f"tensorflowonspark_tpu_torch.{name}" in report["imported"], name
    assert [m for m in report["new"] if _forbidden(m)] == []


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
