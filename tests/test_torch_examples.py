"""The port's examples run as ``python -m`` drivers on CPU workers.

``mnist_pipeline`` (TFEstimator.fit → TFModel.transform) and
``mnist_estimator`` (``train_and_evaluate`` under the cluster) run under
2 gloo workers, at the JAX package's example test sizes
(``tests/test_examples.py``) cut to finish in seconds.  Each must print its
closing line; the estimator's workers must both report the final eval at
the step budget.  ``gpt_tiny`` (in-process ``train_and_evaluate``, then
greedy and lookup generation, which must agree) runs both archs, the
llama-class one with the chunked LM-head loss.  ``bert_squad``'s ``train_fn``, rows and mappings run in
``test_torch_pipeline_bert.py``.  ``wide_deep_criteo`` runs two gloo
workers as one embedding group (``--num_ps 2``: each holds half of every
table's rows), ``inception_imagenet`` a 75 px pass and
``unet_segmentation`` the reference example's widths, one worker each.
``serving_demo`` serves its burst with speculation and with decode blocks,
and ``cluster_serving`` through one worker, each against solo greedy runs.
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
    "gpt_tiny_gpt2": (["gpt.gpt_tiny", "--cpu", "--max_steps", "6"],
                      ["gpt_tiny: eval loss", "at step 6", "gpt_tiny: generated [7, 8, 9",
                       "speculative decode matched greedy", "gpt_tiny: done"]),
    "gpt_tiny_llama": (["gpt.gpt_tiny", "--cpu", "--max_steps", "6", "--arch", "llama",
                        "--chunked_xent"],
                       ["gpt_tiny: eval loss", "at step 6", "speculative decode matched greedy",
                        "gpt_tiny: done"]),
    # one embedding group of both workers (--num_ps = the cluster's size)
    "wide_deep_criteo": (["wide_deep.wide_deep_criteo", "--cpu", "--cluster_size", "2",
                          "--num_ps", "2", "--steps", "10", "--vocab_size", "100",
                          "--batch_size", "32"],
                         ["embedding group of 2, 1300 deep rows here", "step 10 logloss",
                          "chief: saved", "wide_deep_criteo: done"]),
    "inception_imagenet": (["imagenet.inception_imagenet", "--cpu", "--steps", "2",
                            "--batch_size", "2", "--image_size", "75", "--num_classes", "10",
                            "--num_samples", "8"],
                           ["node 0: step 2 loss", "inception_imagenet: done"]),
    "unet_segmentation": (["segmentation.unet_segmentation", "--cpu", "--steps", "5",
                           "--image_size", "32", "--batch_size", "4", "--num_samples", "8"],
                          ["node 0: step 5 loss", "IoU", "unet_segmentation: done"]),
    "serving_demo_speculative": (["gpt.serving_demo", "--cpu", "--requests", "6",
                                  "--speculative", "4"],
                                 ["6 requests greedy-exact on cpu", "drafts accepted",
                                  "serving_demo: done"]),
    "serving_demo_blocks": (["gpt.serving_demo", "--cpu", "--requests", "6",
                             "--block-steps", "8"],
                            ["6 requests greedy-exact on cpu", "steps/dispatch",
                             "serving_demo: done"]),
    "cluster_serving": (["gpt.cluster_serving", "--cpu", "--workers", "1"],
                        ["node 0 served 12 requests",
                         "12 requests greedy-exact across 1 workers", "cluster_serving: done"]),
}
#: where each example writes (the serving examples write nothing)
OUT_FLAGS = {"mnist_pipeline": "--export_dir", "serving_demo_speculative": None,
             "serving_demo_blocks": None, "cluster_serving": None}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs(tmp_path, name):
    argv, expected = CASES[name]
    module, *flags = argv
    out_flag = OUT_FLAGS.get(name, "--model_dir")
    cmd = [sys.executable, "-m", f"tensorflowonspark_tpu_torch.examples.{module}", *flags,
           *([out_flag, str(tmp_path / "out")] if out_flag else [])]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(tmp_path), env=env,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    for line in expected:
        assert line in proc.stdout, (line, out[-4000:])
