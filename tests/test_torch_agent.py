"""The port's multi-host agent backend: real agent daemons on localhost.

Ports of ``tests/test_agent.py``'s cases to
``tensorflowonspark_tpu_torch.agent``: two ``python -m
tensorflowonspark_tpu_torch.agent`` daemons (one pair for the file) with a
shared authkey, and the full ``TPUCluster`` contract through
``AgentBackend`` against them — train and inference round trips, error
propagation, a bad authkey, ping and status, oversubscription, the failed
worker's log tail through the agent, and the reconnect after a reset.
The map_funs are ``tests/cluster_funcs.py``'s (numpy only).
"""

import glob
import os
import secrets
import subprocess
import sys

import pytest

from tensorflowonspark_tpu_torch.agent import AgentBackend, HostAgent, _AgentConn
from tensorflowonspark_tpu_torch.cluster import TPUCluster
from tests import cluster_funcs as funcs

pytestmark = pytest.mark.integration  # spawns real agent daemons

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}


@pytest.fixture(scope="module")
def agent_fleet():
    """Two real host-agent daemons on localhost with a shared authkey."""
    key = secrets.token_bytes(16)
    procs, addrs = [], []
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    try:
        for _ in range(2):
            p = subprocess.Popen(
                [sys.executable, "-m", "tensorflowonspark_tpu_torch.agent",
                 "--port", "0", "--authkey-hex", key.hex()],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, cwd=ROOT, env=env)
            procs.append(p)
            line = p.stdout.readline().strip()  # "AGENT host:port"
            assert line.startswith("AGENT "), f"unexpected agent banner {line!r}"
            host, port = line.split(" ", 1)[1].rsplit(":", 1)
            addrs.append((host, int(port)))
        yield key, addrs
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_agent_train_roundtrip(agent_fleet, tmp_path):
    key, addrs = agent_fleet
    backend = AgentBackend(addrs, authkey=key, worker_env=WORKER_ENV)
    cluster = TPUCluster.run(funcs.fn_sum_feed, {"batch_size": 8}, num_workers=2,
                             backend=backend, reservation_timeout=60,
                             working_dir=str(tmp_path))
    try:
        cluster.train(list(range(100)), num_epochs=1)
    finally:
        cluster.shutdown(timeout=120)
    sums = []
    for i in range(2):
        with open(tmp_path / f"sum.{i}") as f:
            sums.append(tuple(map(int, f.read().split(":"))))
    assert sum(t for t, _ in sums) == sum(range(100))
    assert sum(c for _, c in sums) == 100
    # round-robin assignment: both agents hosted one worker each
    assert all(c > 0 for _, c in sums)


def test_agent_inference_roundtrip(agent_fleet, tmp_path):
    key, addrs = agent_fleet
    backend = AgentBackend(addrs, authkey=key, worker_env=WORKER_ENV)
    cluster = TPUCluster.run(funcs.fn_square_inference, {}, num_workers=2, backend=backend,
                             reservation_timeout=60, working_dir=str(tmp_path))
    try:
        preds = cluster.inference(list(range(24)))
        assert sorted(preds) == sorted(x * x for x in range(24))
    finally:
        cluster.shutdown(timeout=120)


def test_agent_error_propagation(agent_fleet, tmp_path):
    key, addrs = agent_fleet
    backend = AgentBackend(addrs[:1], authkey=key, worker_env=WORKER_ENV)
    cluster = TPUCluster.run(funcs.fn_crash, {}, num_workers=1, backend=backend,
                             reservation_timeout=60, working_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="deliberate failure"):
        cluster.shutdown(timeout=120)


def test_agent_rejects_bad_authkey(agent_fleet):
    _, addrs = agent_fleet
    with pytest.raises((PermissionError, EOFError, ConnectionError, OSError)):
        conn = _AgentConn(addrs[0], authkey=b"wrong-key-entirely", timeout=5)
        conn.request({"type": "PING"})


def test_agent_ping_and_status():
    key = b"\x01" * 16
    agent = HostAgent(port=0, authkey=key)
    addr = agent.start()
    conn = _AgentConn(addr, authkey=key)
    try:
        pong = conn.request({"type": "PING"})
        assert pong["ok"] and pong["workers"] == []
        assert conn.request({"type": "STATUS"}) == {}
    finally:
        conn.close()
        agent.stop()


def test_agent_oversubscription(agent_fleet, tmp_path):
    """4 workers over 2 agents — the multiple-executors-per-host shape."""
    key, addrs = agent_fleet
    backend = AgentBackend(addrs, authkey=key, worker_env=WORKER_ENV)
    cluster = TPUCluster.run(funcs.fn_write_role, {}, num_workers=4, backend=backend,
                             reservation_timeout=60, working_dir=str(tmp_path))
    cluster.shutdown(timeout=120)
    roles = []
    for i in range(4):
        with open(tmp_path / f"role.{i}") as f:
            roles.append(f.read())
    assert len(roles) == 4
    assert sum(1 for r in roles if r.split(":")[2] == "1") == 1  # one chief


def test_failed_worker_logs_reach_driver_via_agent(agent_fleet, tmp_path):
    """A worker's stack trace must reach the driver THROUGH THE AGENT (the
    LOGS protocol: the daemon's own log dir), not the shared filesystem:
    the crash files are deleted before shutdown, as on hosts without one."""
    key, addrs = agent_fleet
    backend = AgentBackend(addrs[:1], authkey=key, worker_env=WORKER_ENV)
    cluster = TPUCluster.run(funcs.fn_crash, {}, num_workers=1,
                             working_dir=str(tmp_path), backend=backend,
                             reservation_timeout=60)
    backend.join(timeout=60)  # let the worker crash
    for f in glob.glob(os.path.join(str(tmp_path), "error.*")):
        os.remove(f)
    with pytest.raises(RuntimeError) as ei:
        cluster.shutdown(timeout=60)
    msg = str(ei.value)
    assert "deliberate failure" in msg, msg  # the actual traceback text
    assert "executor 0 log tail" in msg
    logs = backend.fetch_logs([0])
    assert "deliberate failure" in logs[0]
    assert backend.exitcodes() == {0: 1}
    backend.close()


def test_agent_conn_reconnects_after_transient_reset():
    """One transient socket failure must not poison the cached connection:
    ``request`` reconnects and retries once before propagating."""
    key = b"\x03" * 16
    agent = HostAgent(port=0, authkey=key)
    addr = agent.start()
    try:
        conn = _AgentConn(addr, authkey=key, timeout=10)
        assert conn.request({"type": "PING"})["ok"]
        conn._sock.close()  # simulate a reset/timeout poisoning the socket
        pong = conn.request({"type": "PING"})  # must transparently reconnect
        assert pong["ok"] and pong["workers"] == []
        conn.close()
    finally:
        agent.stop()
