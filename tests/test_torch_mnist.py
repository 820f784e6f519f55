"""The port's MNIST CNN (``models/mnist.py``) and the SPARK-mode step of
``mnist_train.py`` against the JAX package on the CPU.

The reference is the flax ``MNISTNet`` run in float64 (``jax.enable_x64``)
on the same float32 weights and inputs; the port runs float32.  flax
flattens its NHWC feature map as ``(h, w, c)`` and the port its NCHW map
as ``(c, h, w)``: ``params_from_flax`` permutes the first Dense's rows,
and a carry-over without that permutation computes another function.

Tolerances: ``||port - ref|| / ||ref|| <= 1e-4`` for logits and gradients
(seen: <= 1e-6); for the update of two Adam steps of the strategy against
the JAX strategy with ``optax.adam(1e-3)`` and the example's padded,
weighted loss, 2e-3 of the update's norm (seen: 8e-5 to 9.4e-4).  Adam
divides each gradient by its own magnitude, so a gradient element near
``eps`` whose float32 value carries the rounding of larger terms moves by
a visible fraction of ``lr`` either way.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models.mnist import MNISTNet as JaxMNISTNet
from tensorflowonspark_tpu.parallel.strategy import \
    DataParallelStrategy as JaxDataParallelStrategy
from tensorflowonspark_tpu_torch import mnist_train
from tensorflowonspark_tpu_torch.models.mnist import DROPOUT, MNISTNet, params_from_flax
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, adam

TOL = 1e-4
ADAM_TOL = 2e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _setup(n=6, seed=0):
    images, labels = mnist_train.synthetic_mnist(n, seed)
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(JaxMNISTNet().init(
        jax.random.key(seed), images[..., None])["params"]))
    return images, labels, params


def test_mnist_matches_flax_with_the_flatten_permutation():
    images, labels, params = _setup()
    with jax.enable_x64(True):
        jm = JaxMNISTNet(dtype=jnp.float64)

        def loss(p):
            logits = jm.apply({"params": p}, jnp.asarray(images, jnp.float64))
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(_f64(params))
        want = np.asarray(want)
        want_grads = params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    model = MNISTNet()
    model.load_state_dict(params_from_flax(params))
    logits = model(torch.from_numpy(images))               # [B, 28, 28] input
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    assert _rel(logits.detach(), want) <= TOL
    for name, p in model.named_parameters():
        assert _rel(p.grad, want_grads[name]) <= TOL, name
    # [B, 1, 28, 28] is the same input
    assert _rel(model(torch.from_numpy(images[:, None])).detach(), want) <= TOL

    # without the row permutation the first Dense reads the wrong features
    naive = params_from_flax(params)
    naive["fc1.weight"] = torch.from_numpy(np.asarray(params["Dense_0"]["kernel"]).T.copy())
    model.load_state_dict(naive)
    assert _rel(model(torch.from_numpy(images)).detach(), want) > 0.01


def test_dropout_draws_from_the_generator():
    """``train=True`` drops 25% of the Dense-128 features with a mask from
    the ``torch.Generator`` it is given (the same generator state, the same
    mask) and scales the kept ones by 1 / 0.75; eval mode leaves them as
    they are, and training without a generator is refused."""
    F = torch.nn.functional
    images, _, params = _setup(n=64)
    model = MNISTNet()
    model.load_state_dict(params_from_flax(params))
    x = torch.from_numpy(images)
    with torch.no_grad():
        feats = x[:, None]
        for conv in (model.conv1, model.conv2):
            feats = F.max_pool2d(F.relu(conv(feats)), 2)
        h = F.relu(model.fc1(feats.flatten(1)))            # the Dense-128 features
        torch.testing.assert_close(model(x), model.fc2(h), atol=1e-5, rtol=1e-5)
        a, b, c = (model(x, train=True, rng=torch.Generator().manual_seed(s)) for s in (3, 3, 4))
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        assert not torch.equal(a, c)
        # a head that reads the first 10 features as they are
        model.fc2.weight.copy_(torch.eye(10, 128))
        model.fc2.bias.zero_()
        d = model(x, train=True, rng=torch.Generator().manual_seed(6))
    live = h[:, :10] > 0
    ratio = d[live] / h[:, :10][live]
    kept = (ratio - 1 / (1 - DROPOUT)).abs() < 1e-4
    assert torch.all(kept | (ratio == 0))
    assert int(live.sum()) > 200 and abs(1 - float(kept.float().mean()) - DROPOUT) < 0.08
    with pytest.raises(ValueError, match="rng"):
        model(x, train=True)


def test_adam_steps_match_the_jax_strategy():
    """Two steps of the port's strategy with ``parallel.adam(1e-3)``
    and ``weighted_loss`` on padded batches (``pad_batch``: 5 real rows and
    3 of weight 0) against the JAX strategy with ``optax.adam(1e-3)`` and
    the example's loss."""
    images, labels, params = _setup(n=10)
    batches = [mnist_train.pad_batch((images[i:i + 5], labels[i:i + 5]), 8) for i in (0, 5)]
    assert [float(b[2].sum()) for b in batches] == [5.0, 5.0]

    def jax_loss(p, batch):
        x, y, w = batch
        logits = JaxMNISTNet(dtype=jnp.float64).apply({"params": p}, x.transpose(0, 2, 3, 1))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    with jax.enable_x64(True):
        strategy = JaxDataParallelStrategy(devices=jax.devices()[:1])
        state = strategy.init_state(lambda: _f64(params), optax.adam(1e-3))
        step = strategy.build_train_step(jax_loss)
        for b in batches:
            state, _ = step(state, strategy.shard_batch(
                tuple(jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)
                      for a in b)))
        want = params_from_flax(jax.tree_util.tree_map(np.asarray, state.params))

    port = DataParallelStrategy("cpu")
    pstate = port.init_state(mnist_train.build_model({"state_dict": params_from_flax(params)}),
                             adam(1e-3))
    pstep = port.build_train_step(mnist_train.weighted_loss)
    for b in batches:
        pstate, _ = pstep(pstate, port.shard_batch(b))
    init = params_from_flax(params)
    for name, w in pstate.module.state_dict().items():
        assert _rel(w - init[name], want[name] - init[name]) <= ADAM_TOL, name
