"""The port's restart policy and ``run_with_recovery`` on the CPU.

The policy helpers (``classify_failure``, ``classify_restart``,
``backoff_delay``, ``RestartBudget``) are held against the JAX package's
on the same inputs: equal kinds, equal decisions, equal delays under the
same ``random`` seed, equal budget verdicts.  The driver loop runs the
counterparts of ``tests/test_cluster.py``'s recovery cases with real CPU
worker processes (2 where the reference uses 2), with worker functions
defined here: a crash mid-training resumes from the checkpoint with the
step count kept; an error is re-raised after ``max_restarts``; a bootstrap
failure is retried; a user error is not; a restart budget stops an infra
crash loop.  Every comparison is exact.
"""

import os
import random

import pytest
import torch

from tensorflowonspark_tpu_torch import health
from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
from tensorflowonspark_tpu_torch.cluster import LocalProcessBackend, run_with_recovery

# The workers import this module to find their functions: the JAX package is
# imported inside the tests that need it, so that no worker loads JAX.
WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
RUN = dict(reservation_timeout=60, shutdown_timeout=120)


# -- worker functions (spawned by name from this module) ---------------------

def _noop(args, ctx):
    """Registers, does nothing, exits cleanly."""


def _crash(args, ctx):
    raise ValueError("deliberate failure for error-propagation test")


def _crash_infra(args, ctx):
    raise ConnectionError("injected infra failure")


def _train_checkpoint_crash_once(args, ctx):
    """Deterministic 'training' with checkpoints: the chief saves and then
    dies at ``crash_at`` on the first attempt (sentinel file); every attempt
    appends its start step to ``resume.<id>``."""
    total, crash_at = args["total_steps"], args["crash_at"]
    ckpt = CheckpointManager(args["model_dir"], async_save=False)
    start, w = 0, torch.zeros(())
    if ckpt.latest_step() is not None:
        state = ckpt.restore()
        start, w = int(state["step"]), state["w"]
    with open(os.path.join(ctx.working_dir, f"resume.{ctx.executor_id}"), "a") as f:
        f.write(f"{start}\n")
    sentinel = os.path.join(ctx.working_dir, "crash-injected")
    for s in range(start, total):
        w = w + 1.0
        step = s + 1
        if ctx.is_chief and step == crash_at and not os.path.exists(sentinel):
            ckpt.save(step, {"step": step, "w": w}, force=True)
            with open(sentinel, "w"):
                pass
            raise RuntimeError("injected preemption")
    if ctx.is_chief:
        ckpt.save(total, {"step": total, "w": w}, force=True)
    ckpt.close()


# -- the restart policy against the JAX package's ----------------------------

_TB = "Traceback (most recent call last):\n  File \"x.py\", line 1\n"
_FAILURES = [
    health.ClusterFailure(health.CRASH, "worker 0 died", (0,)),
    health.ClusterFailure(health.HANG, "stale heartbeat", (1,)),
    health.ClusterFailure(health.PREEMPTION, "SIGTERM", (0,)),
    ConnectionError("reset"), EOFError(), TimeoutError("slow"),
    ValueError("bad arg"), KeyError("k"), RuntimeError("boom"), OSError("disk"),
    RuntimeError(f"worker 0 failed:\n{_TB}ValueError: bad shape"),
    RuntimeError(f"worker 0 failed:\n{_TB}ValueError: a\n{_TB}OSError: b"),
    RuntimeError(f"2 workers failed:\n{_TB}KeyError: x\n{_TB}TypeError: y"),
    RuntimeError(f"worker 1 failed:\n{_TB}torch.OutOfMemoryError: CUDA out of memory"),
]


@pytest.mark.parametrize("exc", _FAILURES, ids=lambda e: type(e).__name__)
def test_classify_failure_and_restart_match_reference(exc):
    from tensorflowonspark_tpu import health as jax_health

    ref = exc
    if isinstance(exc, health.ClusterFailure):
        ref = jax_health.ClusterFailure(exc.kind, str(exc), exc.failed_workers)
    kind = health.classify_failure(exc)
    assert kind == jax_health.classify_failure(ref)
    assert health.classify_restart(kind) == jax_health.classify_restart(kind)


def test_backoff_delay_and_budget_match_reference():
    from tensorflowonspark_tpu import health as jax_health

    for attempt in range(0, 9):
        for base, cap in ((1.0, 30.0), (0.1, 2.0), (3.0, 5.0)):
            random.seed(attempt)
            port = health.backoff_delay(attempt, base, cap)
            random.seed(attempt)
            assert port == jax_health.backoff_delay(attempt, base, cap)
            assert 0.5 * min(cap, base * 2 ** max(0, attempt - 1)) <= port <= cap
    times = [0.0, 1.0, 2.0, 10.0, 10.5, 11.0, 11.2, 30.0]
    for limit, window in ((2, 5.0), (1, 0.5), (3, 100.0)):
        a, b = health.RestartBudget(limit, window), jax_health.RestartBudget(limit, window)
        assert [a.allow(t) for t in times] == [b.allow(t) for t in times]
    assert health.BUDGET_EXHAUSTED == jax_health.BUDGET_EXHAUSTED


# -- the driver loop ----------------------------------------------------------

@pytest.mark.integration
def test_run_with_recovery_resumes_from_checkpoint(tmp_path):
    """One injected chief crash mid-training: the cluster is relaunched and
    the job completes with the step count kept (resume from the
    checkpoint, not from 0)."""
    model_dir = str(tmp_path / "ckpt")
    run_with_recovery(
        _train_checkpoint_crash_once,
        {"total_steps": 7, "crash_at": 3, "model_dir": model_dir},
        num_workers=2, max_restarts=2, backoff_base=0.1,
        working_dir=str(tmp_path), worker_env=WORKER_ENV, **RUN)
    with CheckpointManager(model_dir) as ckpt:
        assert ckpt.latest_step() == 7
        assert float(ckpt.restore()["w"]) == 7.0  # 3 before the crash + 4 resumed
    with open(tmp_path / "resume.0") as f:
        starts = f.read().split()
    assert starts[0] == "0", starts
    assert "3" in starts[1:], f"chief must resume from step 3, got {starts}"


@pytest.mark.integration
def test_run_with_recovery_gives_up_after_max_restarts(tmp_path):
    restarts = []
    with pytest.raises(RuntimeError, match="injected infra failure"):
        run_with_recovery(_crash_infra, {}, num_workers=1, max_restarts=1,
                          backoff_base=0.1, working_dir=str(tmp_path),
                          worker_env=WORKER_ENV,
                          on_restart=lambda *a: restarts.append(a), **RUN)
    assert len(restarts) == 1


class FlakyBackend:
    """LocalProcessBackend whose first start() raises — the relaunch-during-
    re-provisioning shape."""

    def __init__(self, fail_times=1, worker_env=None):
        self._inner = LocalProcessBackend(worker_env=worker_env)
        self.fail_times = fail_times
        self.start_calls = 0

    def start(self, *a, **kw):
        self.start_calls += 1
        if self.start_calls <= self.fail_times:
            raise ConnectionError("agents still re-provisioning")
        self._inner.start(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.integration
def test_run_with_recovery_retries_bootstrap_failure(tmp_path):
    backend = FlakyBackend(fail_times=1, worker_env=WORKER_ENV)
    run_with_recovery(_noop, {}, num_workers=1, max_restarts=2, backoff_base=0.1,
                      backend=backend, working_dir=str(tmp_path), **RUN)
    assert backend.start_calls == 2  # failed once, relaunched, completed


@pytest.mark.integration
def test_run_with_recovery_user_error_not_retried(tmp_path):
    restarts = []
    with pytest.raises(RuntimeError, match="deliberate failure"):
        run_with_recovery(_crash, {}, num_workers=1, max_restarts=3,
                          on_restart=lambda *a: restarts.append(a),
                          working_dir=str(tmp_path), worker_env=WORKER_ENV, **RUN)
    assert restarts == [], "user error must not be retried"


@pytest.mark.integration
def test_run_with_recovery_restart_budget_window(tmp_path):
    """``restart_budget=(R, T)`` bounds the restart rate below
    ``max_restarts``; giving up is logged as a ``budget_exhausted`` health
    event and counted."""
    from tensorflowonspark_tpu_torch import metrics
    from tensorflowonspark_tpu_torch.observability import EventLog

    def counts():
        snap = metrics.get_registry().snapshot().get("tfos_restarts_total", {})
        return {labels["kind"]: n for labels, n in snap.get("samples", [])}

    before = counts()
    kinds = []
    with pytest.raises(RuntimeError, match="injected infra failure"):
        run_with_recovery(
            _crash_infra, {}, num_workers=1, max_restarts=5,
            restart_budget=(1, 3600.0), backoff_base=0.1,
            on_restart=lambda attempt, exc, kind: kinds.append(kind),
            working_dir=str(tmp_path), worker_env=WORKER_ENV, **RUN)
    assert kinds == ["infra"], kinds  # one restart allowed, then the budget cut
    events = EventLog.read(str(tmp_path / "health_events.jsonl"))
    assert [e["kind"] for e in events if e["kind"] == health.BUDGET_EXHAUSTED] \
        == [health.BUDGET_EXHAUSTED]
    after = counts()
    assert {k: after[k] - before.get(k, 0.0) for k in after} == {
        "infra": 1.0, health.BUDGET_EXHAUSTED: 1.0}
