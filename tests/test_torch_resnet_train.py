"""The port's ResNet and MNIST training paths end to end on the CPU, and
the bench's FLOP count.

- ``resnet_train`` in ``InputMode.TENSORFLOW``: two gloo workers, each on
  its own synthetic shard, train a narrow ResNet-50 (stages of one
  bottleneck, 8 filters, 32 px, float32, weights carried from flax) with
  DDP and global-batch BatchNorm.  The chief's weights and BatchNorm
  buffers must equal one process trained on both workers' batches side by
  side (``train_in_process``), and the JAX strategy with
  ``optax.sgd(0.1, momentum=0.9)`` on the same global batches (flax in
  float64).
- ``mnist_train`` in ``InputMode.SPARK``: two gloo workers fed through
  ``cluster.train``; every fed row is consumed, the shared-memory
  transport carries the feed, the loss falls, and the chief's weights
  equal one process trained on both workers' batches side by side.

Tolerances: per tensor, ``||w - w_ref|| / ||w_ref - w0||`` (the error
against the reference's movement): ResNet 1e-3 against one process (seen:
5.5e-5; the two workers all-reduce the BatchNorm sums where one process
runs PyTorch's kernels) and 3e-3 against flax in float64 (seen: 7.2e-4, a
BatchNorm bias that moves little in 3 steps); MNIST 2e-3 (seen: 3e-6;
Adam scales gradient elements near ``eps`` to visible steps).  Losses:
ResNet ``rtol=1e-4`` (seen: 2e-5), MNIST ``rtol=1e-5`` (seen: 1.6e-7).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import resnet as jr
from tensorflowonspark_tpu.parallel.strategy import \
    DataParallelStrategy as JaxDataParallelStrategy
from tensorflowonspark_tpu_torch import bench_resnet, mnist_train, resnet_train
from tensorflowonspark_tpu_torch.models import resnet as pr
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, adam

pytestmark = pytest.mark.integration

WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
NARROW = {"stage_sizes": (1, 1, 1, 1), "num_filters": 8, "num_classes": 10}


def _moved_rel(w: dict, ref: dict, w0: dict) -> dict:
    return {n: float((w[n] - ref[n]).norm() / (ref[n] - w0[n]).norm().clamp_min(1e-30))
            for n in ref}


def _flax_init(seed=0):
    x = np.zeros((2, 32, 32, 3), np.float32)
    v = jax.jit(lambda k: jr.ResNet50(**NARROW, dtype=jnp.float32).init(k, x, train=True))(
        jax.random.key(seed))
    rng = np.random.default_rng(seed + 1)

    def live(d):   # every BatchNorm scale from U(0.5, 1.5): no block is silenced
        return {k: live(a) if isinstance(a, dict) else
                (rng.uniform(0.5, 1.5, a.shape).astype(np.float32) if k == "scale"
                 else np.asarray(a, np.float32)) for k, a in d.items()}
    return live(flax.core.meta.unbox(v["params"])), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), v["batch_stats"])


def _jax_sgd(params, batch_stats, batches):
    """The JAX strategy with optax SGD momentum over ``batches`` of NHWC
    images, flax in float64; returns the port's state dict."""
    model = jr.ResNet50(**NARROW, dtype=jnp.float64, norm_dtype=jnp.float64)

    def loss_fn(p, batch, extras):
        logits, upd = model.apply({"params": p, "batch_stats": extras["batch_stats"]},
                                  batch[0], train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()
        return loss, {"extras": {"batch_stats": upd["batch_stats"]}}
    loss_fn.has_aux = True

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        strategy = JaxDataParallelStrategy(devices=jax.devices()[:1])
        state = strategy.init_state(lambda: f64(params), optax.sgd(0.1, momentum=0.9))
        state.extras["batch_stats"] = f64(batch_stats)
        step = strategy.build_train_step(loss_fn)
        for x, y in batches:
            state, _ = step(state, strategy.shard_batch((jnp.asarray(x, jnp.float64),
                                                         jnp.asarray(y))))
        return pr.params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                   jax.tree_util.tree_map(np.asarray,
                                                          state.extras["batch_stats"]))


def test_resnet_train_two_workers_match_one_process_and_jax(tmp_path):
    params, batch_stats = _flax_init()
    w0 = pr.params_from_flax(params, batch_stats)
    args = {"model": "ResNet50", "model_kwargs": NARROW, "dtype": "float32", "bn": "float32",
            "image_size": 32, "batch_size": 4, "steps": 3, "num_samples": 32, "seed": 5,
            "device": "cpu", "state_dict": w0}
    stats, weights = resnet_train.run_training(args, 2, worker_env=WORKER_ENV,
                                               working_dir=str(tmp_path), timeout=120)
    assert [len(s["losses"]) for s in stats] == [3, 3]
    assert [s["images"] for s in stats] == [12, 12]
    assert all(s["device"] == "cpu" and not any(s["launches"].values()) for s in stats)
    assert sorted(weights) == sorted(w0)
    assert not torch.equal(weights["stem_bn.running_mean"], w0["stem_bn.running_mean"])

    losses, single = resnet_train.train_in_process(args, 2, "cpu")
    np.testing.assert_allclose(np.mean([s["losses"] for s in stats], axis=0), losses,
                               rtol=1e-4)
    rel = _moved_rel(weights, single, w0)
    assert max(rel.values()) <= 1e-3, max(rel.items(), key=lambda kv: kv[1])

    # the same global batches through the JAX strategy: worker 0's beside worker 1's
    streams = [resnet_train.batches(args, i, 2, 10) for i in range(2)]
    batches = [(np.concatenate([p[0].permute(0, 2, 3, 1).numpy() for p in parts]),
                np.concatenate([p[1].numpy() for p in parts])) for parts in zip(*streams)]
    rel = _moved_rel(weights, _jax_sgd(params, batch_stats, batches), w0)
    assert max(rel.values()) <= 3e-3, max(rel.items(), key=lambda kv: kv[1])


def test_mnist_train_two_workers_through_cluster_train(tmp_path):
    images, labels = mnist_train.synthetic_mnist(1024, seed=0)
    rows = list(zip(images, labels))
    stats, weights = mnist_train.run_training(
        rows, seed=0, batch_size=32, num_workers=2, device="cpu", worker_env=WORKER_ENV,
        working_dir=str(tmp_path), timeout=120)
    assert [s["rows"] for s in stats] == [512, 512]        # every fed row consumed
    assert [len(s["losses"]) for s in stats] == [16, 16]
    assert all(s["shm_conns"] >= 1 for s in stats)          # the shm plane carried the feed
    assert all(not any(s["launches"].values()) for s in stats)
    losses = np.mean([s["losses"] for s in stats], axis=0)
    assert losses[-4:].mean() < 0.7 * losses[:4].mean(), losses

    # one process over the same global batches: worker 0's batch i beside worker 1's
    strategy = DataParallelStrategy("cpu")
    state = strategy.init_state(mnist_train.build_model({"seed": 0}), adam(1e-3))
    w0 = {k: v.clone() for k, v in state.module.state_dict().items()}
    step = strategy.build_train_step(mnist_train.weighted_loss)
    single = []
    for i in range(0, 512, 32):
        part = rows[i:i + 32] + rows[512 + i:512 + i + 32]
        batch = mnist_train.pad_batch((np.stack([r[0] for r in part]),
                                       np.stack([r[1] for r in part])), 64)
        state, metrics = step(state, strategy.shard_batch(batch))
        single.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, single, rtol=1e-5)
    rel = _moved_rel(weights, state.module.state_dict(), w0)
    assert max(rel.values()) <= 2e-3, max(rel.items(), key=lambda kv: kv[1])


def test_bench_counts_two_flops_a_multiply_add():
    """The bench's FLOP count reads every convolution's shape: a narrow
    net against the count by hand, and ResNet-50 at 224 px against its
    published 4.09 G multiply-adds an image."""
    model = pr.ResNet(stage_sizes=(1,), block=pr.BasicBlock, num_filters=4, num_classes=3,
                      dtype=torch.float32)
    # stem 7x7/2 on 16 px -> 8x8x4; max-pool -> 4x4; block: two 3x3 convs 4->4 at 4x4
    macs = 8 * 8 * 4 * 3 * 49 + 2 * (4 * 4 * 4 * 4 * 9) + 4 * 3
    assert bench_resnet.forward_flops_per_image(model, 16, "cpu") == 2 * macs
    r50 = pr.ResNet50(dtype=torch.float32)
    gmacs = bench_resnet.forward_flops_per_image(r50, 224, "cpu") / 2 / 1e9
    assert 4.08 < gmacs < 4.10, gmacs


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_resnet.bench()
