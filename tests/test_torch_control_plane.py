"""The control plane the serving tier imports, held to the JAX package's:
the metrics exposition (``render_prometheus``, ``merge_snapshots``,
``render_cluster_text``, ``MetricsHTTPServer``), ``LatencyHistogram``,
``chaos`` plan parsing, ``tracing``'s stitching, and the cluster's live
membership and ``/metrics`` endpoint (``TPUCluster.add_workers``,
``retire_worker``, ``metrics_text``, ``serve_metrics``).

The JAX package's copies of these modules import no JAX, and neither does
this file: its map function runs in spawned CPU workers.
"""

import json
import urllib.request

import numpy as np
import pytest

from tensorflowonspark_tpu import chaos as ref_chaos
from tensorflowonspark_tpu import metrics as ref_metrics
from tensorflowonspark_tpu import observability as ref_obs
from tensorflowonspark_tpu import tracing as ref_tracing
from tensorflowonspark_tpu_torch import chaos, metrics, observability, tracing
from tensorflowonspark_tpu_torch.cluster import LocalProcessBackend, TPUCluster
from tensorflowonspark_tpu_torch.marker import EndOfFeed

WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}


def _fill(mod):
    """One registry of ``mod`` driven by the same operations; its snapshot."""
    reg = mod.MetricsRegistry()
    c = reg.counter("tfos_test_requests_total", "Requests\nby outcome.",
                    labelnames=("outcome",))
    c.inc(3, outcome="ok")
    c.inc(outcome='bad "quote"\\')
    reg.gauge("tfos_test_depth_count", "Queue depth.").set(2.5)
    h = reg.histogram("tfos_test_latency_seconds", "Latency.")
    for v in (0.001, 0.02, 0.3, 4.0, 70.0):
        h.record(v)
    return reg.snapshot()


def test_exposition_renders_the_jax_packages_text():
    ref, port = _fill(ref_metrics), _fill(metrics)
    assert port == ref
    assert metrics.render_prometheus(port) == ref_metrics.render_prometheus(ref)
    nodes = {0: {"metrics": port}, 3: {"metrics": _fill(metrics)}, 5: {}}
    assert metrics.merge_snapshots({"driver": port, "0": port}) \
        == ref_metrics.merge_snapshots({"driver": ref, "0": ref})
    text = metrics.render_cluster_text(port, nodes)
    assert text == ref_metrics.render_cluster_text(ref, nodes)
    assert 'tfos_test_requests_total{node="3",outcome="ok"} 3' in text
    assert 'tfos_test_latency_seconds_bucket{node="driver",le="+Inf"} 5' in text


def test_metrics_http_server_serves_text_and_status():
    server = metrics.MetricsHTTPServer(lambda: "tfos_x_total 1\n",
                                       statusz=lambda: {"ok": True})
    host, port = server.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            assert r.read().decode() == "tfos_x_total 1\n"
            assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        with urllib.request.urlopen(f"http://{host}:{port}/statusz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=10)
    finally:
        server.stop()


@pytest.mark.parametrize("cap", [4096, 7])
def test_latency_histogram_matches_the_jax_package(cap):
    rng = np.random.default_rng(cap)
    samples = rng.exponential(0.05, 40).tolist()
    ref, port = ref_obs.LatencyHistogram(cap), observability.LatencyHistogram(cap)
    assert port.summary() == ref.summary() and port.percentile(50) is None
    for s in samples:
        ref.record(s)
        port.record(s)
    assert len(port) == len(ref) == 40
    assert port.summary() == ref.summary()
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert port.percentile(q) == ref.percentile(q)
    for since in (0, 10, 39, 40):
        assert port.window_summary(since) == ref.window_summary(since)


@pytest.mark.parametrize("spec", [
    "kill node=1 at_step=3",
    "term node=0 after_secs=1.5 grace=2; stall node=2 at_step=4 secs=3",
    "kill driver after_secs=2",
    "flap node=1 every=0.5 count=3",
    "replace node=1 at_step=8, drop node=0 after_secs=1",
    "kill node=1",
    "explode node=1 at_step=2",
    "kill at_step=2",
    "stall node=1 at_step=x",
])
def test_chaos_plans_parse_as_the_jax_package(spec):
    def parse(mod):
        try:
            return [a.describe() for a in mod.parse_plan(spec)]
        except mod.ChaosPlanError as e:
            return ("error", str(e))

    assert parse(chaos) == parse(ref_chaos)


def test_tracing_stitch_and_list_round_trip(tmp_path):
    """Spans written through the port's tracer and event logs stitch into
    the JAX package's timeline, and list the same traces."""
    trace, other = tracing.new_trace_id(), tracing.new_trace_id()
    tracer = tracing.Tracer(str(tmp_path / tracing.TRACE_FILENAME))
    events = observability.EventLog(str(tmp_path / "serving_events.jsonl"), echo=False)
    try:
        events.emit("request_admitted", trace=trace, rid=1)
        tracer.event("replica_intake", trace, rid=1, replica=0)
        events.emit("replica_dead", replica=0)
        events.emit("request_requeued", trace=trace, rid=1, from_replica=0)
        tracer.event("replica_intake", other, rid=2, replica=1)
        tracer.event("replica_done", trace, rid=1, replica=1)
        events.emit("request_done", trace=trace, rid=1)
    finally:
        tracer.close()
        events.close()
    got = tracing.stitch_trace(str(tmp_path), trace)
    assert got == ref_tracing.stitch_trace(str(tmp_path), trace)
    assert [r["kind"] for r in got if not r.get("_context")] == [
        "request_admitted", "replica_intake", "request_requeued", "replica_done",
        "request_done"]
    assert tracing.list_traces(str(tmp_path)) == ref_tracing.list_traces(str(tmp_path))
    assert tracing.format_timeline(got) == ref_tracing.format_timeline(got)


# ------------------------------------------------------ live membership

def _echo(args, ctx):
    """Worker: answer each fed item ``x`` with ``x + args["add"]`` until
    the end of the feed."""
    feed = ctx.get_data_feed()
    while not feed.should_stop():
        try:
            batch = feed.next_batch(4, timeout=0.5)
        except TimeoutError:
            continue
        if batch:
            feed.batch_results([x + args["add"] for x in batch])


def test_backend_add_workers_keeps_ids_contiguous():
    backend = LocalProcessBackend()
    with pytest.raises(ValueError, match="non-contiguous executor id 2"):
        backend.add_workers([2], _echo, {}, {}, ())


def test_cluster_grows_retires_and_serves_its_metrics(tmp_path):
    """``add_workers`` spawns a live newcomer that joins ``cluster_info``
    and the feed; ``retire_worker`` takes it out of the feed (stopped by
    its own end-of-feed marker); ``metrics_text`` is the JAX package's
    rendering of ``metrics()``; ``serve_metrics`` serves it over HTTP."""
    cluster = TPUCluster.run(_echo, {"add": 1}, 1, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path), reservation_timeout=120)
    try:
        with pytest.raises(ValueError):
            cluster.add_workers(0)
        added = cluster.add_workers(1, timeout=120)
        assert [a["executor_id"] for a in added] == [1]
        assert [n["executor_id"] for n in cluster.cluster_info] == [0, 1]
        assert cluster.inference(list(range(8)), feed_timeout=120) == list(range(1, 9))
        cluster.retire_worker(1)
        assert [n["executor_id"] for n in cluster._feedable_nodes()] == [0]
        cluster._client_for(1).put("input", EndOfFeed(), timeout=10)
        m = cluster.metrics()
        assert metrics.render_cluster_text(m["driver"], m["nodes"]) \
            == ref_metrics.render_cluster_text(m["driver"], m["nodes"])
        assert cluster.metrics_text().startswith("# ")
        host, port = cluster.serve_metrics()
        assert cluster.serve_metrics() == (host, port)
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            assert b"# TYPE tfos_" in r.read()
        with urllib.request.urlopen(f"http://{host}:{port}/statusz", timeout=10) as r:
            assert set(json.loads(r.read())) >= {"driver", "nodes"}
    finally:
        cluster.shutdown(timeout=120)
    with pytest.raises(RuntimeError, match="shut down"):
        cluster.add_workers(1)
