"""The port's preemption handling (``preemption.py``, the node hook, and
``resnet_train``'s guarded loop) on the CPU.

``preemption.py`` is a copy of the JAX package's: a guard latches SIGTERM
instead of dying mid-step, callbacks fire once, and a guard off the main
thread is inert.  The node harness registers its heartbeat reporter, so a
worker's latched SIGTERM shows as phase ``preempted``.  ``resnet_train``
trains under a guard: a SIGTERM during step 2 makes the worker save step 2
(its input position included) at the step boundary and return; a run over
the same ``model_dir`` trains on from step 2 to the weights of an unbroken
run, bit for bit (the same operations in one process).
"""

import os
import signal
import threading

import pytest
import torch

from tensorflowonspark_tpu_torch import preemption, resnet_train
from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.preemption import PreemptionGuard

WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
TINY = {"model": "CifarResNet", "model_kwargs": {"stage_sizes": (1,), "num_filters": 4},
        "dtype": "float32", "bn": "float32", "image_size": 8, "batch_size": 4, "steps": 5,
        "num_samples": 16, "seed": 1, "device": "cpu"}


@pytest.fixture(autouse=True)
def _clear_latch():
    preemption.reset()
    preemption._CALLBACKS.clear()
    yield
    preemption.reset()
    preemption._CALLBACKS.clear()


def test_guard_latches_sigterm_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.wait(5)
        assert guard.preempted and preemption.is_preempted()
    assert signal.getsignal(signal.SIGTERM) is prev
    assert preemption.is_preempted()          # the process-wide latch survives


def test_guard_off_main_thread_is_inert():
    prev = signal.getsignal(signal.SIGTERM)
    result = {}

    def run():
        with PreemptionGuard() as guard:
            result["guard"] = guard
            result["inside"] = signal.getsignal(signal.SIGTERM)

    t = threading.Thread(target=run)
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert result["inside"] is prev and not result["guard"].preempted
    preemption._PREEMPTED.set()               # ...but it sees a latch set elsewhere
    assert result["guard"].preempted


def test_callbacks_fire_once_and_on_late_registration():
    calls = []
    preemption.on_preempted(lambda: calls.append("early"))
    with PreemptionGuard() as guard:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.wait(5)
        os.kill(os.getpid(), signal.SIGTERM)  # a second signal: no re-notify
        assert guard.wait(5)
    assert calls == ["early"]
    preemption.on_preempted(lambda: calls.append("late"))
    assert calls == ["early", "late"]


def _sigterm_self(args, ctx):
    """A worker that is sent SIGTERM under a guard and records the phase
    its heartbeat reporter now publishes."""
    with PreemptionGuard() as guard:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.wait(10)
    with open(os.path.join(ctx.working_dir, "phase"), "w") as f:
        f.write(ctx._heartbeat._phase)


def test_node_marks_a_preempted_worker(tmp_path):
    cluster = TPUCluster.run(_sigterm_self, {}, 1, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=60, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path))
    cluster.shutdown(timeout=60)
    assert (tmp_path / "phase").read_text() == "preempted"


class _Context:
    """The slice of ``NodeContext`` that ``resnet_train.map_fun`` uses, for
    one in-process worker; ``report_step`` sends SIGTERM at ``kill_at``."""

    executor_id, num_workers, is_chief = 0, 1, True

    def __init__(self, working_dir, kill_at=None):
        self.working_dir, self.kill_at = working_dir, kill_at

    def initialize_distributed(self, device=None):
        pass

    def report_step(self, step):
        if step == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)


@pytest.fixture
def _keep_threads():
    """``map_fun`` pins a CPU worker to one thread; give the test process
    its threads back."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def test_sigterm_mid_training_saves_at_the_step_boundary_and_resumes(tmp_path, _keep_threads):
    model_dir = str(tmp_path / "model")
    args = {**TINY, "model_dir": model_dir}
    prev = signal.getsignal(signal.SIGTERM)
    resnet_train.map_fun(args, _Context(str(tmp_path), kill_at=2))
    assert signal.getsignal(signal.SIGTERM) is prev
    stats = (tmp_path / "resnet_train_stats.0.json").read_text()
    assert '"preempted": true' in stats
    saved = restore_checkpoint(model_dir)
    assert saved["step"] == 2 and saved["data"] == {"elements_consumed": 2}
    assert saved["optim"]["state"]            # the momentum went with it

    preemption.reset()
    resnet_train.map_fun(args, _Context(str(tmp_path)))
    assert restore_checkpoint(model_dir)["step"] == TINY["steps"]
    resumed = restore_checkpoint(model_dir)["model"]
    _, unbroken = resnet_train.train_in_process(TINY, 1, "cpu")
    assert sorted(resumed) == sorted(unbroken)
    assert all(torch.equal(resumed[k], unbroken[k]) for k in unbroken)
