"""The port's ResNet (``models/resnet.py``) against the JAX package's flax
modules on the CPU: ``space_to_depth`` and the s2d stem kernel transform,
both blocks at stride 1 and 2 in train and eval mode, ResNets with the
conv7, s2d and CIFAR stems (logits, gradients against ``jax.grad``, and
the BatchNorm ``batch_stats`` after one train-mode call), the s2d stem
against conv7 inside the port, flax's asymmetric SAME padding, and one
SGD-momentum step of the strategy against the JAX strategy with
``optax.sgd``.

The reference is the flax module run in float64 (``jax.enable_x64``) on
the same float32 weights and inputs; the port runs float32.  flax's own
float32 gradients drift from its float64 ones by up to 5% on a 4-stage
bottleneck ResNet at 64 px (batch 4), where the port's float32 stays
within 4e-6 of them, so a float32 reference would hide port faults under
its own rounding.  Every BatchNorm scale is drawn from U(0.5, 1.5), so no
block's branch is silenced by flax's zero-initialised last scale.

Tolerances: float32, ``||port - ref|| / ||ref|| <= 1e-4`` for each of
logits (or block outputs), input and parameter gradients and updated
``batch_stats`` (seen: <= 4e-6); ``space_to_depth`` and the kernel
transform bit for bit.  bf16 convolutions (one case, both sides bf16 with
float32 BatchNorm): the port's distance from the float64 reference is at
most twice flax's bf16 distance, for the logits and for the median and
largest gradient errors (seen: 0.84x to 1.6x; at these widths bf16 costs
either side 30-40% of the gradients' norm, so a fixed bound would say
little).
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
from tensorflowonspark_tpu_torch.models import resnet as pr
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy, sgd

TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _live_scales(params, seed):
    """Every BatchNorm ``scale`` drawn from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "scale" else v)
                for k, v in d.items()}
    return walk(params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _init(module, x, seed=0):
    v = jax.jit(lambda k: module.init(k, x, train=True))(jax.random.key(seed))
    return _live_scales(_np(flax.core.meta.unbox(v["params"])), seed + 1), _np(v["batch_stats"])


def _flax64(module, params, batch_stats, x, train, cotangent=None, labels=None):
    """The flax module in float64: ``(out, grads wrt params, grad wrt x,
    updated batch_stats)``; the loss is softmax cross-entropy of ``labels``
    or ``sum(out * cotangent)``."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def loss(p, xx):
            if train:
                out, upd = module.apply({"params": p, "batch_stats": f64(batch_stats)}, xx,
                                        train=True, mutable=["batch_stats"])
                upd = upd["batch_stats"]
            else:
                out, upd = module.apply({"params": p, "batch_stats": f64(batch_stats)}, xx,
                                        train=False), {}
            val = (optax.softmax_cross_entropy_with_integer_labels(out, labels).mean()
                   if labels is not None else (out * f64(cotangent)).sum())
            return val, (out, upd)

        (_, (out, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(f64(params), f64(x))
        return (np.asarray(out), jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx),
                jax.tree_util.tree_map(np.asarray, upd))


def _assert_close(got: dict, want: dict, tol: float, what: str):
    errs = {k: _rel(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]:.3g} (tol {tol})"


# ----------------------------------------------------------- layout helpers

@pytest.mark.parametrize("block", [2, 4])
def test_space_to_depth_matches_flax_bit_for_bit(block):
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jr.space_to_depth(jnp.asarray(x), block))
    got = pr.space_to_depth(_nchw(x), block)
    np.testing.assert_array_equal(_nhwc(got), want)
    # a channels_last input stays channels_last, with the same values
    cl = pr.space_to_depth(_nchw(x).contiguous(memory_format=torch.channels_last), block)
    assert cl.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(cl), want)
    with pytest.raises(ValueError, match="divisible"):
        pr.space_to_depth(torch.zeros(1, 3, 5, 4), 2)


def test_conv7_stem_to_s2d_kernel_matches_flax_bit_for_bit():
    k7 = np.random.default_rng(1).standard_normal((7, 7, 3, 16)).astype(np.float32)
    want = np.asarray(jr.conv7_stem_to_s2d_kernel(jnp.asarray(k7)))    # HWIO [4, 4, 12, 16]
    got = pr.conv7_stem_to_s2d_kernel(torch.from_numpy(k7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


@pytest.mark.parametrize("size,kernel,stride,want", [
    (56, 3, 2, (0, 1)),      # the strided 3x3 of a block on an even input: not torch's (1, 1)
    (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (7, 1, 2, (0, 0)),
    (224, 7, 2, (2, 3)), (28, 4, 1, (1, 2))])
def test_same_padding_is_flaxs(size, kernel, stride, want):
    assert pr.same_padding(size, kernel, stride) == want
    # the output size XLA's SAME gives
    assert (size + sum(want) - kernel) // stride + 1 == -(-size // stride)


# ------------------------------------------------------------------ blocks

BLOCKS = [("BasicBlock", 1, 8), ("BasicBlock", 2, 8), ("Bottleneck", 1, 32),
          ("Bottleneck", 2, 16)]


def _block_case(name, stride, cin, train, dtype=torch.float32):
    filters = 8
    x = np.random.default_rng(2).standard_normal((4, 8, 8, cin)).astype(np.float32)
    jm = getattr(jr, name)(filters, strides=stride, dtype=jnp.float64, norm_dtype=jnp.float64)
    params, bs = _init(getattr(jr, name)(filters, strides=stride, dtype=jnp.float32), x)
    out_shape = jax.eval_shape(lambda: getattr(jr, name)(filters, strides=stride).apply(
        {"params": params, "batch_stats": bs}, x))
    g = np.random.default_rng(3).standard_normal(out_shape.shape).astype(np.float32)
    sd = pr.params_from_flax({f"{name}_0": params}, {f"{name}_0": bs})
    pb = getattr(pr, name)(cin, filters, stride, dtype=dtype)
    pb.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    return jm, params, bs, x, g, pb


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,stride,cin", BLOCKS, ids=[f"{b}-s{s}" for b, s, _ in BLOCKS])
def test_block_matches_flax(name, stride, cin, train):
    jm, params, bs, x, g, pb = _block_case(name, stride, cin, train)
    out, gp, gx, upd = _flax64(jm, params, bs, x, train, cotangent=g)
    xt = _nchw(x).requires_grad_()
    got = pb(xt, train=train)
    (got * _nchw(g)).sum().backward()
    assert (pb.proj is not None) == (stride != 1 or cin != jm.filters * pb.expansion)
    _assert_close({"out": _nhwc(got), "dx": _nhwc(xt.grad)}, {"out": out, "dx": gx}, TOL,
                  "block output")
    want = pr.params_from_flax({f"{name}_0": gp}, {f"{name}_0": upd or bs})
    grads = {f"blocks.0.{n}": p.grad for n, p in pb.named_parameters()}
    _assert_close(grads, {n: want[n] for n in grads}, TOL, "gradients")
    buffers = {f"blocks.0.{n}": b for n, b in pb.named_buffers()}
    _assert_close(buffers, {n: want[n] for n in buffers}, TOL,
                  "batch_stats" if train else "unchanged running stats")


def test_symmetric_strided_padding_departs_from_flax(monkeypatch):
    """PyTorch's ``padding=1`` on the strided 3x3 (instead of flax's SAME
    (0, 1)) gives another function: the block test above would fail."""
    jm, params, bs, x, g, pb = _block_case("Bottleneck", 2, 16, True)
    out, *_ = _flax64(jm, params, bs, x, True, cotangent=g)
    monkeypatch.setattr(pr, "same_padding", lambda size, k, s: ((k - 1) // 2, (k - 1) // 2))
    assert _rel(_nhwc(pb(_nchw(x), train=True)), out) > 100 * TOL


# ----------------------------------------------------------------- ResNets

STEMS = {
    "conv7": (dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10), 32),
    "s2d": (dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10, stem="s2d"), 32),
    "cifar": (dict(stage_sizes=(1, 1, 1, 1), num_filters=8), 32),
}


def _resnet_case(stem, seed=0, batch=4):
    kw, size = STEMS[stem]
    ctor = (jr.CifarResNet, pr.CifarResNet) if stem == "cifar" else (jr.ResNet50, pr.ResNet50)
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    params, bs = _init(ctor[0](**kw, dtype=jnp.float32), x, seed)
    num_classes = kw.get("num_classes", 10)
    y = rng.integers(0, num_classes, batch)
    return ctor, kw, params, bs, x, y


def _port_step(ctor, kw, params, bs, x, y, dtype=torch.float32):
    model = ctor[1](**kw, dtype=dtype)
    model.load_state_dict(pr.params_from_flax(params, bs))
    logits = model(_nchw(x), train=True)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    return (logits.detach().numpy(), {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()))


@pytest.mark.parametrize("stem", list(STEMS))
def test_resnet_matches_flax(stem):
    ctor, kw, params, bs, x, y = _resnet_case(stem)
    jm = ctor[0](**kw, dtype=jnp.float64, norm_dtype=jnp.float64)
    logits, gp, _, upd = _flax64(jm, params, bs, x, True, labels=y)
    got_logits, grads, buffers = _port_step(ctor, kw, params, bs, x, y)
    assert _rel(got_logits, logits) <= TOL
    want = pr.params_from_flax(gp, upd)
    _assert_close(grads, {n: want[n] for n in grads}, TOL, f"{stem} gradients")
    _assert_close(buffers, {n: want[n] for n in buffers}, TOL, f"{stem} batch_stats")
    # eval mode reads the running statistics
    model = ctor[1](**kw, dtype=torch.float32)
    model.load_state_dict(pr.params_from_flax(params, upd))
    want_eval, *_ = _flax64(jm, params, upd, x, False, labels=y)
    assert _rel(model(_nchw(x), train=False).detach().numpy(), want_eval) <= TOL


def test_resnet_bf16_is_as_close_to_float64_as_flax_bf16():
    """bf16 convolutions with float32 BatchNorm on both sides: the port's
    logits and gradients are no further from the float64 reference than
    flax's own bf16 run is, within a factor 2."""
    ctor, kw, params, bs, x, y = _resnet_case("conv7", seed=1)
    ref_logits, gp64, _, _ = _flax64(ctor[0](**kw, dtype=jnp.float64, norm_dtype=jnp.float64),
                                     params, bs, x, True, labels=y)
    ref = pr.params_from_flax(gp64, bs)
    jm = ctor[0](**kw, dtype=jnp.bfloat16)

    def loss(p):
        logits, _ = jm.apply({"params": p, "batch_stats": bs}, x, train=True,
                             mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, flax_logits), flax_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    flax_grads = pr.params_from_flax(_np(flax_grads), bs)
    logits, grads, _ = _port_step(ctor, kw, params, bs, x, y, dtype=torch.bfloat16)

    def errs(g):
        return sorted(_rel(g[n], ref[n]) for n in grads)

    port, flax_ = errs(grads), errs(flax_grads)
    assert _rel(logits, ref_logits) <= 2 * _rel(np.asarray(flax_logits), ref_logits)
    assert np.median(port) <= 2 * np.median(flax_), (np.median(port), np.median(flax_))
    assert port[-1] <= 2 * flax_[-1], (port[-1], flax_[-1])


def test_s2d_stem_equals_conv7_inside_the_port():
    """``stem="s2d"`` with :func:`conv7_stem_to_s2d_kernel` of the conv7
    kernel is the same network."""
    ctor, kw, params, bs, x, y = _resnet_case("conv7", seed=2)
    conv7 = pr.ResNet50(**kw, dtype=torch.float32)
    conv7.load_state_dict(pr.params_from_flax(params, bs))
    s2d = pr.ResNet50(**{**kw, "stem": "s2d"}, dtype=torch.float32)
    sd = pr.params_from_flax(params, bs)
    sd["stem.weight"] = pr.conv7_stem_to_s2d_kernel(sd["stem.weight"])
    s2d.load_state_dict(sd)
    a, b = conv7(_nchw(x), train=True), s2d(_nchw(x), train=True)
    assert _rel(b.detach(), a.detach()) <= 1e-5
    _assert_close(dict(s2d.named_buffers()), dict(conv7.named_buffers()), 1e-5, "buffers")
    with pytest.raises(ValueError, match="unknown stem"):
        pr.ResNet50(stem="s4d")


@pytest.mark.parametrize("scales", [None, (0.5, 1.5), (0.5, 1.5, 0.05, 0.15)],
                         ids=["flax-init", "all-live", "last-small"])
def test_init_params_scales_wake_every_branch(scales):
    """``init_params(scales=...)`` draws only the BatchNorm scales anew,
    from the ranges given (each block's last from the second range), and
    keeps every kernel.  At flax's init each block's zero last scale
    leaves the convolutions inside its branch with a gradient of 0 (a
    gate there cannot see them); with drawn scales every parameter has a
    gradient."""
    kw = STEMS["conv7"][0]
    model = pr.ResNet50(**kw, dtype=torch.float32)
    flax_init = pr.init_params(model, 3)
    sd = pr.init_params(model, 3, scales)
    bns = {n[:-len("running_mean")] for n in sd if n.endswith("running_mean")}
    last = {p for p in bns if p.endswith("bn3.")}
    assert last and all(torch.equal(sd[n], flax_init[n]) for n in sd
                        if not n.endswith(".weight") or n[:-len("weight")] not in bns)
    if scales is not None:
        for p in bns:
            lo, hi = scales[2:] if p in last and len(scales) == 4 else scales[:2]
            assert lo <= float(sd[p + "weight"].min()) <= float(sd[p + "weight"].max()) <= hi
    model.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 32, 32), np.float32))
    torch.nn.functional.cross_entropy(model(x, train=True), torch.tensor([1, 2])).backward()
    silent = {n for n, p in model.named_parameters() if float(p.grad.abs().max()) == 0}
    branch_convs = {n for n, _ in model.named_parameters()
                    if n.startswith("blocks.") and ".conv" in n}
    assert branch_convs
    assert (silent >= branch_convs) if scales is None else not silent, sorted(silent)[:4]


# --------------------------------------------------------------- strategy

def test_sgd_momentum_steps_match_the_jax_strategy():
    """Two steps of the port's strategy with ``sgd(0.1)`` against the JAX
    strategy with ``optax.sgd(0.1, momentum=0.9)`` and ``batch_stats`` in
    ``state.extras``: parameters and statistics (the second step applies
    the momentum)."""
    ctor, kw, params, bs, x, y = _resnet_case("cifar", seed=3)
    xs = [x, np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)]
    jm = ctor[0](**kw, dtype=jnp.float64, norm_dtype=jnp.float64)

    def jax_loss(p, batch, extras):
        logits, upd = jm.apply({"params": p, "batch_stats": extras["batch_stats"]},
                               batch[0], train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()
        return loss, {"extras": {"batch_stats": upd["batch_stats"]}}
    jax_loss.has_aux = True

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        strategy = JaxDataParallelStrategy(devices=jax.devices()[:1])
        state = strategy.init_state(lambda: f64(params), optax.sgd(0.1, momentum=0.9))
        state.extras["batch_stats"] = f64(bs)
        step = strategy.build_train_step(jax_loss)
        for xx in xs:
            state, _ = step(state, strategy.shard_batch((jnp.asarray(xx, jnp.float64),
                                                         jnp.asarray(y))))
        want = pr.params_from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                                   jax.tree_util.tree_map(np.asarray, state.extras["batch_stats"]))

    def loss_fn(model, batch):
        return torch.nn.functional.cross_entropy(model(batch[0], train=True), batch[1])

    port = DataParallelStrategy("cpu")
    model = ctor[1](**kw, dtype=torch.float32)
    model.load_state_dict(pr.params_from_flax(params, bs))
    pstate = port.init_state(model, sgd(0.1))
    pstep = port.build_train_step(loss_fn)
    for xx in xs:
        pstate, _ = pstep(pstate, port.shard_batch((_nchw(xx), y)))
    got = pstate.module.state_dict()
    init = pr.params_from_flax(params, bs)
    moved = {n: got[n] - init[n] for n in want}
    _assert_close(moved, {n: want[n] - init[n] for n in want}, TOL, "update")
    _assert_close(got, want, TOL, "parameters and batch_stats")
