"""The port's examples run as ``python -m`` drivers on CPU workers.

``mnist_pipeline`` (TFEstimator.fit → TFModel.transform) and
``mnist_estimator`` (``train_and_evaluate`` under the cluster) run under
2 gloo workers, at the JAX package's example test sizes
(``tests/test_examples.py``) cut to finish in seconds.  Each must print its
closing line; the estimator's workers must both report the final eval at
the step budget.  ``bert_squad``'s ``train_fn``, rows and mappings run in
``test_torch_pipeline_bert.py``.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.integration

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "mnist_pipeline": (["mnist.mnist_pipeline", "--cpu", "--cluster_size", "2",
                        "--num_samples", "64", "--batch_size", "16"],
                       ["mnist_pipeline: done", "pred="]),
    "mnist_estimator": (["mnist.mnist_estimator", "--cpu", "--cluster_size", "2",
                         "--max_steps", "8", "--throttle_steps", "4", "--batch_size", "16",
                         "--num_samples", "256"],
                        ["mnist_estimator: done", "node 0: final eval step=8",
                         "node 1: final eval step=8"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs(tmp_path, name):
    argv, expected = CASES[name]
    module, *flags = argv
    out_flag = "--model_dir" if name == "mnist_estimator" else "--export_dir"
    cmd = [sys.executable, "-m", f"tensorflowonspark_tpu_torch.examples.{module}", *flags,
           out_flag, str(tmp_path / "out")]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(tmp_path), env=env,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for line in expected:
        assert line in proc.stdout, (line, out[-4000:])
