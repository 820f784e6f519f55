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
``ring_lm`` (ring and Ulysses, two gloo workers at sp 2) starts from the
JAX example's flax init and is held to the JAX example's losses.
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


#: ``ring_lm``'s flags here: a small width, the JAX example's defaults otherwise
RING_LM = {"vocab": 32, "hidden": 32, "seq_len": 64, "batch_size": 4, "max_steps": 4}
#: what the JAX example fixes (and the port's example with it): its depth,
#: heads, Adam rate, and the seed of the data
RING_LM_FIXED = {"num_layers": 2, "num_heads": 4, "lr": 3e-3, "seed": 0}
#: the driver that runs ``ring_lm``'s ``main`` once for each command line
#: it is given as JSON, in one process (one torch import, one fork server)
RING_LM_DRIVER = """import json, sys

from tensorflowonspark_tpu_torch.examples.long_context.ring_lm import main

if __name__ == "__main__":
    for argv in json.loads(sys.argv[1]):
        main(argv)
"""


def _jax_ring_lm():
    """The JAX example's model over ring attention at sp 2 and its loss
    (``examples/long_context/ring_lm.py``), with its mesh."""
    import functools

    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.models import Bert, BertConfig
    from tensorflowonspark_tpu.parallel import make_mesh, ring_self_attention
    from tensorflowonspark_tpu.parallel.mesh import MeshSpec

    c = {**RING_LM, **RING_LM_FIXED}
    mesh = make_mesh(MeshSpec(sp=2, dp=1), devices=jax.devices()[:2])
    cfg = BertConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                     num_layers=c["num_layers"], num_heads=c["num_heads"],
                     intermediate_size=c["hidden"] * 4, max_position_embeddings=c["seq_len"],
                     dropout_rate=0.0, dtype=jnp.float32,
                     attention_fn=functools.partial(ring_self_attention, mesh, causal=True))
    model = Bert(cfg)

    def loss_fn(params, batch):
        ids = batch["ids"]
        h = model.apply({"params": params}, ids)
        table = params["tok_emb"]["embedding"]
        table = getattr(table, "value", table)
        logits = jnp.einsum("bsh,vh->bsv", h.astype(jnp.float32), table.astype(jnp.float32))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], ids[:, 1:]).mean()

    return model, loss_fn, mesh


def _jax_ring_lm_train(loss_fn, mesh, params, batches, steps):
    """The JAX example's training (its ``MeshStrategy``, Adam) of
    ``params`` on ``batches``: each step's loss, and the eval loss of the
    batches after the first ``steps`` before and after."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu.parallel.strategy import MeshStrategy

    evaluate = jax.jit(lambda p: jnp.mean(jnp.stack(
        [loss_fn(p, {"ids": jnp.asarray(b["ids"])}) for b in batches[steps:]])))
    baseline = float(evaluate(params))
    strategy = MeshStrategy(mesh=mesh)
    state = strategy.init_state(lambda: params, optax.adam(RING_LM_FIXED["lr"]))
    step = strategy.build_train_step(loss_fn)
    losses = []
    for b in batches[:steps]:
        state, metrics = step(state, strategy.shard_batch({"ids": jnp.asarray(b["ids"])}))
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "baseline": baseline, "final": float(evaluate(state.params))}


@pytest.fixture(scope="module")
def ring_lm_runs(tmp_path_factory):
    """From flax's init of the JAX example's model at key 0 (carried over
    as the port trunk's state dict in an npz): ``ring_lm``'s command line
    ``--cpu --sp 2`` (two gloo workers through ``TFCluster.run``) for
    ``ring`` and then ``ulysses`` in one child process, while the JAX
    example's run (:func:`_jax_ring_lm_train`) goes on here.  Returns the
    JAX run, the child process and each impl's results."""
    import json

    import flax
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tensorflowonspark_tpu_torch.examples.long_context.ring_lm import make_batches
    from tensorflowonspark_tpu_torch.models.bert import params_from_flax

    c = {**RING_LM, **RING_LM_FIXED}
    wd = tmp_path_factory.mktemp("ring_lm")
    batches = make_batches(c["seed"], c["max_steps"] + 2, c["batch_size"], c["seq_len"],
                           c["vocab"])
    model, loss_fn, mesh = _jax_ring_lm()
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.ones((c["batch_size"], c["seq_len"]), jnp.int32))["params"]
    held = jax.tree.map(np.asarray, flax.core.meta.unbox(params))
    init_path = wd / "init.npz"
    np.savez(init_path, **{k[len("bert."):]: v.numpy()
                           for k, v in params_from_flax({"bert": held}).items()})
    argvs = [["--cpu", "--sp", "2", "--sp_impl", impl,
              *(f"--{k}={v}" for k, v in RING_LM.items()), "--init_params", str(init_path),
              "--model_dir", str(wd / impl)] for impl in ("ring", "ulysses")]
    (wd / "driver.py").write_text(RING_LM_DRIVER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, str(wd / "driver.py"), json.dumps(argvs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(wd), env=env)
    try:
        want = _jax_ring_lm_train(loss_fn, mesh, params, batches, c["max_steps"])
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    results = {impl: json.loads((wd / impl / "ring_lm.json").read_text())
               for impl in ("ring", "ulysses") if (wd / impl / "ring_lm.json").exists()}
    return want, (proc.returncode, out, err), results


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_ring_lm_matches_the_jax_example(ring_lm_runs, impl):
    """``ring_lm``'s run (:func:`ring_lm_runs`: two gloo workers, each
    holding half of every sequence; ``ulysses`` runs the port's flash
    attention, its plain version here, on each rank's heads) from the JAX
    example's initial weights: every training step's loss and the eval
    losses before and after within ``rtol=2e-4`` of the JAX example's model
    over ring attention trained the same way (float32 both sides; the
    attentions sum in other orders, and 4 Adam steps carry the
    difference)."""
    import numpy as np

    want, (rc, out, err), results = ring_lm_runs
    assert rc == 0, (out + err)[-4000:]
    assert out.count("ring_lm: done") == 2
    got = results[impl]
    assert got["sp_impl"] == impl and got["sp"] == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose([got["baseline"], got["final"]],
                               [want["baseline"], want["final"]], rtol=2e-4)
    assert got["final"] < got["baseline"]
