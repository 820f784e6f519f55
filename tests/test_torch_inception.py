"""The port's Inception-v3 (``models/inception.py``) against the JAX
package's flax modules on the CPU.

The reference is the flax module in float64 (``jax.enable_x64``, as
``tests/test_torch_resnet.py`` runs flax) on the same float32 weights and
inputs.  The flax ``ConvBN`` fixes its BatchNorm at ``dtype=float32``, so
flax computes the batch statistics in float32 (``E[x^2] - E[x]^2``) and
rounds every normalised output to float32 whatever the input's dtype; for
the train-mode comparisons the test runs flax's two BatchNorm helpers
(``flax.linen.normalization._compute_stats`` and ``_normalize``) in float64
(``monkeypatch``; the package is not edited) and the port in float64
(``norm_dtype=float64``).  In train mode at 75 px and batch 2 the network
is chaotic at init: the port's own float32 run differs from its float64
run by 3% in the logits and up to 80% in a gradient, so only float64 on
both sides tells a port fault from rounding.  The flax side runs under
``jax.jit``: one compile of the whole network's forward and backward takes
~13 s on this CPU, where the same forward op by op took ~20 s and
``model.init`` op by op ~80 s, so the weights are drawn with numpy into the
shapes of ``jax.eval_shape(model.init)``: ``lecun_normal``-scale kernels,
BatchNorm scales from U(0.5, 1.5), biases and statistics random.

- 75 px (the smallest input), ``aux_logits=False``, train mode, dropout 0,
  float64: logits, the gradient of every parameter and the updated
  BatchNorm statistics, each within ``||port - ref|| / ||ref|| <= 1e-5``
  (seen: 4e-7 logits, 1.1e-7 the worst gradient); the 1x7 / 7x1 kernels
  carried with their spatial axes swapped must fall outside it;
- eval mode at 75 px (running statistics), the port in its own float32
  against flax as it is: logits within 1e-4;
- the aux head at 139 px in a train-mode forward, float64 as above: logits
  and aux logits within 1e-5; and ``aux_logits=True`` below ~139 px raises.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models.inception import InceptionV3 as FlaxInception
from tensorflowonspark_tpu_torch.models import inception as pi

TOL = 1e-5          # float64 on both sides
EVAL_TOL = 1e-4     # the port in float32
CLASSES = 7


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _draw(tree, rng, kind):
    """Numpy weights in the shapes of ``tree`` (a flax variables tree)."""
    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)   # bias, mean
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _weights(model, size, seed):
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0),
                                                "dropout": jax.random.key(1)}, x, train=True))
    rng = np.random.default_rng(seed)
    return (_draw(flax.core.meta.unbox(shapes["params"]), rng, "params"),
            _draw(shapes["batch_stats"], rng, "stats"))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _port(params, stats, size, aux=False, dtype=torch.float64):
    model = pi.InceptionV3(CLASSES, aux_logits=aux, dropout_rate=0.0, dtype=dtype,
                           norm_dtype=dtype, image_size=size)
    model.load_state_dict(pi.params_from_flax(params, stats))
    return model.to(dtype)


@pytest.fixture
def flax_batchnorm_f64(monkeypatch):
    """flax's BatchNorm statistics and normalised output in float64."""
    import flax.linen.normalization as fn

    stats, normalize = fn._compute_stats, fn._normalize
    monkeypatch.setattr(fn, "_compute_stats",
                        lambda x, axes, dtype=None, **kw: stats(x, axes, jnp.float64, **kw))
    monkeypatch.setattr(fn, "_normalize", lambda mdl, x, mean, var, red, feat, dtype, *rest:
                        normalize(mdl, x, mean, var, red, feat, jnp.float64, *rest))


def _batch_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running" in k}


def test_train_step_logits_gradients_and_batch_stats_against_flax(flax_batchnorm_f64):
    fmodel = FlaxInception(num_classes=CLASSES, dropout_rate=0.0, dtype=jnp.float64)
    params, stats = _weights(fmodel, 75, 0)
    rng = np.random.default_rng(1)
    x = rng.random((2, 75, 75, 3)).astype(np.float32)
    cot = rng.standard_normal((2, CLASSES)).astype(np.float32)

    with jax.enable_x64(True):
        def loss(p, s, x, cot):
            out, upd = fmodel.apply({"params": p, "batch_stats": s}, x, train=True,
                                    mutable=["batch_stats"])
            return (out * cot).sum(), (out, upd["batch_stats"])
        (_, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _f64(params), _f64(stats), jnp.asarray(x, jnp.float64), jnp.asarray(cot, jnp.float64))
    want_grads = pi.params_from_flax(jax.tree.map(np.asarray, grads),
                                     jax.tree.map(np.asarray, new_stats))
    want_stats = {k: v for k, v in want_grads.items() if "running" in k}

    def port_readings(model):
        out = model(_nchw(x).double(), train=True)
        (out * torch.from_numpy(cot).double()).sum().backward()
        errs = {n: _rel(p.grad.numpy(), want_grads[n]) for n, p in model.named_parameters()}
        errs.update({n: _rel(v, want_stats[n]) for n, v in _batch_stats(model).items()})
        return _rel(out.detach().numpy(), logits), errs

    logit_err, errs = port_readings(_port(params, stats, 75))
    assert logit_err <= TOL
    assert len(errs) == len(want_grads) and max(errs.values()) <= TOL, max(errs.items(),
                                                                           key=lambda e: e[1])
    # the 1x7 / 7x1 kernels carried with their spatial axes swapped
    faulty = _port(params, stats, 75)
    for mod in faulty.modules():
        if isinstance(mod, pi.Conv) and mod.weight.shape[2] != mod.weight.shape[3]:
            mod.weight = torch.nn.Parameter(mod.weight.detach().transpose(2, 3).contiguous())
    fault_err, fault_errs = port_readings(faulty)
    assert fault_err > 10 * TOL or max(fault_errs.values()) > 10 * TOL


def test_eval_logits_against_flax():
    fmodel = FlaxInception(num_classes=CLASSES, dropout_rate=0.2, dtype=jnp.float64)
    params, stats = _weights(fmodel, 75, 2)
    x = np.random.default_rng(3).random((2, 75, 75, 3)).astype(np.float32)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, s, x: fmodel.apply({"params": p, "batch_stats": s}, x))(
            _f64(params), _f64(stats), jnp.asarray(x, jnp.float64))
    model = _port(params, stats, 75, dtype=torch.float32).eval()
    assert _rel(model(_nchw(x)).detach().numpy(), want) <= EVAL_TOL


def test_aux_head_at_139px_against_flax(flax_batchnorm_f64):
    fmodel = FlaxInception(num_classes=CLASSES, aux_logits=True, dropout_rate=0.0,
                           dtype=jnp.float64)
    params, stats = _weights(fmodel, 139, 4)
    assert params["ConvBN_6"]["Conv_0"]["kernel"].shape[:2] == (1, 1)   # the whole 1x1 grid
    x = np.random.default_rng(5).random((2, 139, 139, 3)).astype(np.float32)
    with jax.enable_x64(True):
        logits, aux = jax.jit(lambda p, s, x: fmodel.apply(
            {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"])[0])(
            _f64(params), _f64(stats), jnp.asarray(x, jnp.float64))
    got, got_aux = _port(params, stats, 139, aux=True)(_nchw(x).double(), train=True)
    assert _rel(got.detach().numpy(), logits) <= TOL
    assert _rel(got_aux.detach().numpy(), aux) <= TOL
    assert pi.aux_grid(299) == 5 and pi.aux_grid(139) == 1
    with pytest.raises(ValueError, match="aux_logits=True needs"):
        pi.InceptionV3(CLASSES, aux_logits=True, image_size=75)
