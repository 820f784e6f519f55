"""The port's chunked LM-head cross-entropy (``ops/xent.py``) against the
JAX package's ``tied_softmax_xent``: per-token losses and the gradients of
their mean into the hidden states and the table, for an even and a ragged
last chunk and with ``ignore_index``; inputs drawn with numpy from a seed.

Tolerances: float32 ``rtol = atol = 2e-5`` (the same float32 products and
online logsumexp, summed in another order; the JAX package holds its own
version to the dense loss with these); bfloat16 inputs ``rtol = atol =
1e-3`` (both sides form bf16 x bf16 products accumulated in float32, and
round ``(p - onehot) * g`` to bf16 before the backward products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import tied_softmax_xent as jax_xent
from tensorflowonspark_tpu_torch.models import gpt as P
from tensorflowonspark_tpu_torch.ops import tied_softmax_xent

TOL = {"float32": 2e-5, "bfloat16": 1e-3}


def _inputs(V, H, lead=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, H)).astype(np.float32),
            rng.standard_normal((V, H)).astype(np.float32),
            rng.integers(0, V, lead).astype(np.int32))


def _jax(h, t, y, dtype, **kw):
    def loss(h, t):
        out = jax_xent(h, t, y, **kw)
        return out.mean(), out

    (_, out), (gh, gt) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h, dtype), jnp.asarray(t, dtype))
    return [np.asarray(a, np.float32) for a in (out, gh, gt)]


def _port(h, t, y, dtype, **kw):
    h = torch.tensor(h, dtype=dtype, requires_grad=True)
    t = torch.tensor(t, dtype=dtype, requires_grad=True)
    out = tied_softmax_xent(h, t, torch.from_numpy(y), **kw)
    assert out.dtype == torch.float32
    out.mean().backward()
    return [a.detach().float().numpy() for a in (out, h.grad, t.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,chunk", [(224, 32), (50, 16), (64, 4096)],
                         ids=["even", "ragged", "one_chunk"])
def test_losses_and_gradients_equal_jax(V, chunk, dtype):
    h, t, y = _inputs(V, 16)
    want = _jax(h, t, y, getattr(jnp, dtype), chunk_size=chunk)
    got = _port(h, t, y, getattr(torch, dtype), chunk_size=chunk)
    for g, w, what in zip(got, want, ("loss", "dh", "dtable")):
        np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype], err_msg=what)


def test_ignore_index_zero_loss_and_no_gradient_as_jax():
    h, t, y = _inputs(50, 8, lead=(4, 3), seed=1)
    y[0, :] = -100
    y[2, 1] = -100
    want = _jax(h, t, y, jnp.float32, chunk_size=16, ignore_index=-100)
    got = _port(h, t, y, torch.float32, chunk_size=16, ignore_index=-100)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    assert (got[0][y == -100] == 0).all() and (got[1][y == -100] == 0).all()


def test_matches_the_dense_logits_loss_of_gpt():
    """``GPT.hidden`` + the chunked loss against the logits + cross-entropy
    loss on the same weights: loss and every gradient."""
    cfg = P.GPTConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                      intermediate_size=64, max_position_embeddings=32, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (2, 16)))
    sd = P.init_params(cfg, 3)
    grads, losses = [], []
    for chunked in (False, True):
        model = P.GPT(cfg)
        model.load_state_dict(sd)
        if chunked:
            h = model.hidden(ids)
            loss = tied_softmax_xent(h[:, :-1], model.tok_emb.weight, ids[:, 1:],
                                     chunk_size=32).mean()
        else:
            loss = torch.nn.functional.cross_entropy(model(ids)[:, :-1].reshape(-1, 96),
                                                     ids[:, 1:].reshape(-1))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert abs(losses[0] - losses[1]) < 1e-5 * losses[0]
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=5e-4, atol=1e-5)


def test_nonpositive_chunk_raises():
    h, t, y = _inputs(8, 4)
    with pytest.raises(ValueError, match="chunk_size"):
        tied_softmax_xent(torch.from_numpy(h), torch.from_numpy(t), torch.from_numpy(y),
                          chunk_size=0)
