"""The port's reference-named front door and its observability helpers.

``TFCluster.run(None, map_fun, args, num_executors, num_ps, tensorboard,
input_mode, ...)`` in the reference's positional call shape, driving real
CPU workers; a callable ``sc`` raises; ``TFNode``, ``TFManager`` and
``TFSparkNode`` carry every public name of the JAX package's façades (the
port's objects); ``tensorboard=True`` spawns TensorBoard on the chief
through a stub ``tensorboard`` package (a tiny HTTP server) and
``tensorboard_url`` finds it, while a process without the package gets
``None``; ``profile_trace`` and the profiler server write
``torch.profiler`` traces.
"""

import json
import os
import sys
import urllib.request

import pytest
import torch

from tensorflowonspark_tpu_torch import (TFCluster, TFManager, TFNode, TFSparkNode,
                                         observability)
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tests import cluster_funcs as funcs

pytestmark = pytest.mark.integration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}

#: ``python -m tensorboard.main --logdir D --port P ...`` of the stub package
STUB_MAIN = '''
import argparse, http.server
p = argparse.ArgumentParser()
p.add_argument("--logdir"); p.add_argument("--port", type=int)
p.add_argument("--host"); p.add_argument("--load_fast")
a = p.parse_args()
class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200); self.end_headers(); self.wfile.write(a.logdir.encode())
http.server.HTTPServer(("127.0.0.1", a.port), H).serve_forever()
'''


def fn_hold_until_released(args, ctx):
    """Stay up (and so keep the chief's TensorBoard up) until the test
    writes ``release`` into the working dir."""
    import time

    deadline = time.monotonic() + 60
    while not os.path.exists(os.path.join(ctx.working_dir, "release")):
        if time.monotonic() > deadline:
            raise TimeoutError("never released")
        time.sleep(0.05)


def test_tfcluster_run_in_the_reference_call_shape(tmp_path):
    """``TFCluster.run(sc, map_fun, tf_args, num_executors, num_ps,
    tensorboard, input_mode)`` positionally, ``sc=None``: the SPARK-mode
    feed reaches both executors, then a TENSORFLOW-mode cluster with a ps
    node gets the reference's roles."""
    cluster = TFCluster.run(None, funcs.fn_sum_feed, {"batch_size": 8}, 2, 0, False,
                            TFCluster.InputMode.SPARK, reservation_timeout=60,
                            worker_env=WORKER_ENV, working_dir=str(tmp_path / "feed"))
    assert isinstance(cluster, TFCluster.TFCluster) and TFCluster.TFCluster is TPUCluster
    try:
        cluster.train(list(range(40)), 1)
    finally:
        cluster.shutdown(timeout=60)
    sums = [tuple(map(int, (tmp_path / "feed" / f"sum.{i}").read_text().split(":")))
            for i in range(2)]
    assert sum(t for t, _ in sums) == sum(range(40)) and all(c for _, c in sums)

    wd = tmp_path / "roles"
    wd.mkdir()
    TFCluster.run(None, funcs.fn_write_role, {}, 3, 1, False, InputMode.TENSORFLOW,
                  reservation_timeout=60, worker_env=WORKER_ENV,
                  working_dir=str(wd)).shutdown(timeout=60)
    roles = sorted((wd / f"role.{i}").read_text() for i in range(3))
    assert roles == ["ps:0:0:3", "worker:0:1:3", "worker:1:0:3"]


def test_tfcluster_run_rejects_a_map_fun_in_the_sc_slot():
    with pytest.raises(TypeError, match="SparkContext"):
        TFCluster.run(funcs.fn_noop, {}, {}, 1)


@pytest.mark.parametrize("name", ["TFCluster", "TFManager", "TFNode", "TFSparkNode"])
def test_facades_carry_the_reference_names(name):
    """Every public name of the JAX package's façade module exists in the
    port's (``TFNode.export_saved_model`` is ``checkpoint.export_model``)."""
    import importlib

    ref = importlib.import_module(f"tensorflowonspark_tpu.{name}")
    port = importlib.import_module(f"tensorflowonspark_tpu_torch.{name}")
    public = {n for n in vars(ref) if not n.startswith("_")
              and not isinstance(getattr(ref, n), type(sys)) and n not in ("annotations",
                                                                          "logger", "logging")}
    assert public - set(vars(port)) == set()
    from tensorflowonspark_tpu_torch import checkpoint, datafeed, node, queues, util

    assert TFNode.DataFeed is datafeed.DataFeed and TFNode.hdfs_path is util.hdfs_path
    assert TFNode.export_saved_model is checkpoint.export_model
    assert TFNode.start_cluster_server is node.start_cluster_server
    assert TFSparkNode.TFNodeContext is node.NodeContext and TFSparkNode.run is node.run
    assert TFManager.TFManager is queues.QueueServer


def test_tfmanager_start_and_connect_round_trip():
    key = b"k" * 16
    mgr = TFManager.start(key, queues=["input", "output"], mode="local")
    try:
        client = TFManager.connect(mgr.addr, key)
        client.put("input", [1, 2, 3], timeout=5)
        assert mgr.queue_get("input", timeout=5) == [1, 2, 3]
        TFNode.batch_results(mgr, (4, 5))
        assert client.get("output", timeout=5) == [4, 5]
        client.close()
    finally:
        mgr.stop()


def test_tensorboard_url_through_a_stub_tensorboard(tmp_path):
    """``tensorboard=True``: the chief-designate spawns ``python -m
    tensorboard.main`` (the stub's, first on the workers' PYTHONPATH) on the
    logdir; exactly one node registers a ``tb_port``; the URL serves."""
    stub = tmp_path / "stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    (stub / "main.py").write_text(STUB_MAIN)
    logdir = tmp_path / "tblog"
    env = {**WORKER_ENV, "PYTHONPATH": str(stub.parent) + os.pathsep + ROOT}
    wd = tmp_path / "wd"
    cluster = TFCluster.run(None, fn_hold_until_released, {}, 2, 0, True,
                            InputMode.TENSORFLOW, str(logdir), reservation_timeout=60,
                            worker_env=env, working_dir=str(wd))
    try:
        url = cluster.tensorboard_url()
        assert url is not None and url.startswith("http://")
        assert sum(1 for n in cluster.cluster_info if n.get("tb_port")) == 1
        port = url.rsplit(":", 1)[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert r.status == 200 and r.read().decode() == str(logdir)
    finally:
        (wd / "release").write_text("")
        cluster.shutdown(timeout=60)


def test_start_tensorboard_without_the_package_returns_none(monkeypatch, tmp_path, caplog):
    monkeypatch.setitem(sys.modules, "tensorboard", None)     # import raises ImportError
    assert observability.start_tensorboard(str(tmp_path)) is None
    assert "not installed" in caplog.text
    assert observability.tensorboard_url([{"host": "h", "tb_port": 0}]) is None


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path):
    """``profile_trace`` (and ``NodeContext.profile_trace`` into the
    context's TensorBoard logdir) write a ``*.pt.trace.json`` naming the
    ops traced; ``annotate`` names a span; the profiler server traces on
    request."""
    from tensorflowonspark_tpu_torch.node import NodeContext

    ctx = NodeContext(0, "worker", 0, [{"host": "h", "port": 1}],
                      working_dir=str(tmp_path))
    with ctx.profile_trace():
        with observability.annotate("tfos-span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    traces = observability._trace_files(ctx.tensorboard_logdir)
    assert len(traces) == 1 and ctx.tensorboard_logdir == str(tmp_path / "tensorboard")
    names = observability.trace_kernel_names(traces[0])
    assert "tfos-span" in names and "aten::mm" in names

    port = observability.start_profiler_server(logdir=str(tmp_path / "live"))
    got = observability.capture_profile("127.0.0.1", port, duration_ms=50)
    assert len(got) == 1 and got[0].endswith(".pt.trace.json")
    with open(got[0]) as f:
        assert "traceEvents" in json.load(f)
