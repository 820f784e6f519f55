"""The port's U-Net (``models/unet.py``) against the JAX package's flax
module on the CPU, at features (8, 16, 32), two classes.

The reference is flax in float64 (``jax.enable_x64``; its GroupNorm is
fixed at float32, as in the module) under ``jax.jit``, the port in its
float32, on the same weights (``params_from_flax``) and inputs.  Sizes:
16x16, even at every level, and 12x20, whose bottleneck grid is 3x5, so
the transposed convolutions take an odd grid (a kernel carried without
flax's flip, or with its axes swapped, is wrong at every size; the odd
grid checks the output placement).  Tolerance: ``||port - ref|| / ||ref||
<= 1e-4`` for the logits and each parameter's gradient (seen: <= 3e-6);
the transposed kernel carried without its flip must fall outside it.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models.unet import UNet as FlaxUNet
from tensorflowonspark_tpu_torch.models import unet as pu

TOL = 1e-4
FEATURES = (8, 16, 32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(params, flip=True):
    model = pu.UNet(2, FEATURES, dtype=torch.float32)
    sd = pu.params_from_flax(params, len(FEATURES))
    if not flip:                                   # the planted fault: no flip
        sd = {k: v.flip(2, 3).contiguous() if k.startswith("ups.") and k.endswith("weight")
              else v for k, v in sd.items()}
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)], ids=["even", "odd_grid"])
def test_logits_and_gradients_against_flax(hw):
    H, W = hw
    fmodel = FlaxUNet(num_classes=2, features=FEATURES, dtype=jnp.float64)
    rng = np.random.default_rng(H * W)
    x = rng.random((2, H, W, 3)).astype(np.float32)
    cot = rng.standard_normal((2, H, W, 2)).astype(np.float32)
    shapes = jax.eval_shape(lambda: fmodel.init(jax.random.key(0), x))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                         if path[-1].key == "kernel" else
                         rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "scale" else
                         0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        flax.core.meta.unbox(shapes))
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        logits = jax.jit(lambda p, x: fmodel.apply({"params": p}, x))(f64, jnp.asarray(
            x, jnp.float64))
        grads = jax.jit(jax.grad(lambda p, x, c: (fmodel.apply({"params": p}, x) * c).sum()))(
            f64, jnp.asarray(x, jnp.float64), jnp.asarray(cot, jnp.float64))
    want = pu.params_from_flax(jax.tree.map(np.asarray, grads), len(FEATURES))

    def readings(model):
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        (out * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
        errs = [_rel(p.grad.numpy(), want[n]) for n, p in model.named_parameters()]
        return _rel(out.detach().numpy().transpose(0, 2, 3, 1), logits), max(errs)

    logit_err, grad_err = readings(_port(params))
    assert logit_err <= TOL and grad_err <= TOL
    assert min(readings(_port(params, flip=False))) > 10 * TOL
    assert pu.UNet(2, FEATURES).ups[0].weight.shape == (32, 16, 2, 2)
