"""The port's BERT sequence classifier, ``scan_layers`` carry-over and
``remat`` (``models/bert.py``) against the JAX package on the CPU.

A tiny float32 BERT (hidden 64, 2 layers, 4 heads, T 24, 3 classes), the
dense attention and the port's flash attention (its plain version on the
CPU), the flax side under ``jax.jit``:

- ``BertForSequenceClassification``: the logits, and the gradients of
  ``pooler`` and ``cls_head``, against flax's with the same weights
  (``params_from_flax``): ``||port - flax|| / ||flax|| <= 1e-5`` (seen: <=
  1e-6); the whole trunk's gradients too, but for the key biases, whose
  gradient is zero in theory (a softmax ignores a shift of every score),
  which stay under 1e-9;
- a flax model built with ``scan_layers=True`` (layers stacked on a leading
  axis) carried across gives that flax model's logits within 1e-5;
- ``remat=True`` with dropout 0.1: the port's loss and every gradient equal
  its own without remat from the same generator state, bit for bit apart
  from the recomputation's summation order (``atol`` 1e-6), and the
  generator ends in the same state; a remat whose recomputation draws
  fresh masks from the live generator (the planted fault) must not.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models.bert import BertConfig as JaxBertConfig
from tensorflowonspark_tpu.models.bert import \
    BertForSequenceClassification as JaxBertCls
from tensorflowonspark_tpu_torch.models import bert as pb
from tensorflowonspark_tpu_torch.ops import flash_attention as torch_flash

TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=32)
T, B, CLASSES, TOL = 24, 3, 3, 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] < np.array([T, 17, 9])[:, None]
    types = (np.arange(T)[None, :] >= 12).astype(np.int32).repeat(B, 0)
    return ids, mask, types


def _flax(**extra):
    cfg = JaxBertConfig(**TINY, dropout_rate=0.0, dtype=jnp.float32, **extra)
    model = JaxBertCls(cfg, num_classes=CLASSES)
    ids, mask, types = _inputs()
    params = jax.jit(lambda k: model.init(k, ids, mask, types))(jax.random.key(0))
    return model, jax.tree.map(np.asarray, flax.core.meta.unbox(params["params"]))


def _port(params, **extra):
    cfg = pb.BertConfig(**TINY, dropout_rate=0.0, dtype=torch.float32, **extra)
    model = pb.BertForSequenceClassification(cfg, CLASSES)
    model.load_state_dict(pb.params_from_flax(params))
    return model


def _torch_inputs(seed=0):
    ids, mask, types = _inputs(seed)
    return torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(types).long()


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_classifier_logits_and_head_gradients_against_flax(attention):
    fmodel, params = _flax()
    ids, mask, types = _inputs()
    cot = np.random.default_rng(1).standard_normal((B, CLASSES)).astype(np.float32)
    logits = jax.jit(lambda p: fmodel.apply({"params": p}, ids, mask, types))(params)
    grads = jax.jit(jax.grad(
        lambda p: (fmodel.apply({"params": p}, ids, mask, types) * cot).sum()))(params)
    want = pb.params_from_flax(jax.tree.map(np.asarray, grads))
    model = _port(params, attention_fn=torch_flash if attention == "flash" else None)
    out = model(*_torch_inputs())
    assert out.dtype == torch.float32 and out.shape == (B, CLASSES)
    assert _rel(out.detach().numpy(), logits) <= TOL
    (out * torch.from_numpy(cot)).sum().backward()
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):    # zero in theory: rounding on both sides
            assert np.abs(p.grad.numpy()).max() <= 1e-9
        elif name in want:
            assert _rel(p.grad.numpy(), want[name]) <= TOL, name
    assert {"pooler.weight", "pooler.bias", "cls_head.weight", "cls_head.bias"} <= set(want)


def test_scan_layers_params_carry_over():
    fmodel, params = _flax(scan_layers=True)
    assert "layers" in params["bert"] and "layer_0" not in params["bert"]
    assert params["bert"]["layers"]["attn"]["query"]["kernel"].shape[0] == TINY["num_layers"]
    ids, mask, types = _inputs(2)
    want = jax.jit(lambda p: fmodel.apply({"params": p}, ids, mask, types))(params)
    model = _port(params, scan_layers=True)
    assert _rel(model(*_torch_inputs(2)).detach().numpy(), want) <= TOL
    sd = pb.params_from_flax(params)
    assert sum(k.startswith("bert.layers.1.") for k in sd) == 16


def _naive_remat(block, x, train, rng, **kwargs):
    """Activation checkpointing on the live generator: the recomputation
    draws new dropout masks (the planted fault)."""
    return torch.utils.checkpoint.checkpoint(
        lambda t: block(t, train=train, rng=rng, **kwargs), x, use_reentrant=False)


@pytest.mark.parametrize("remat", ["private generator", "live generator (fault)"])
def test_remat_gradients_equal_no_remat_with_dropout(remat, monkeypatch):
    if remat != "private generator":
        monkeypatch.setattr(pb, "_remat", _naive_remat)
    cfg = dict(TINY, dropout_rate=0.1, dtype=torch.float32)
    sd = pb.init_params(pb.BertConfig(**cfg), 3, num_classes=CLASSES)

    def run(remat_on: bool):
        model = pb.BertForSequenceClassification(pb.BertConfig(**cfg, remat=remat_on), CLASSES)
        model.load_state_dict(sd)
        gen = torch.Generator().manual_seed(11)
        loss = model(*_torch_inputs(4), train=True, rng=gen).logsumexp(-1).mean()
        loss.backward()
        return (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()},
                gen.get_state())

    loss0, grads0, end0 = run(False)
    loss1, grads1, end1 = run(True)
    worst = max(float((grads1[n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for n, g in grads0.items() if g.abs().max() > 0)
    assert loss1 == loss0                               # the forward is the same ops
    if remat == "private generator":
        assert worst <= 1e-6
        assert torch.equal(end1, end0)
    else:
        assert worst > 1e-2
