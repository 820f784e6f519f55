"""The port's Wide&Deep (``models/wide_deep.py``) and its optax-exact
optimizers (``parallel/strategy.py``) against the JAX package on the CPU.

- forward logits and the gradient of every parameter against flax
  ``WideDeep`` at vocabs (50, 30, 20) (``tests/test_models.py``'s model),
  the weights carried with ``params_from_flax``: ``||port - flax|| /
  ||flax|| <= 1e-5`` each (float32 both; seen: <= 3e-7);
- three steps of the port's ``adagrad`` against ``optax.adagrad`` on that
  model (accumulator from 0.1, eps 1e-7 inside the root): every loss and
  the final weights within 1e-5 (relative to each weight's change);
  ``torch.optim.Adagrad`` (accumulator from 0, eps outside) must not be;
- three steps of ``rmsprop(exponential_decay(...), decay=0.9, eps=1.0,
  momentum=0.9)`` against optax on a small parameter tree: the same bound,
  where ``torch.optim.RMSprop`` must miss it; the schedule's values.
"""

import flax
import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import WideDeep as FlaxWideDeep
from tensorflowonspark_tpu_torch.models import wide_deep as pw
from tensorflowonspark_tpu_torch.parallel import adagrad, exponential_decay, rmsprop

TOL = 1e-5
VOCABS, EMBED, MLP, NUM_DENSE, BATCH = (50, 30, 20), 4, (16, 8), 5, 6


def _rel(got, want, base=None) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = want if base is None else want - np.asarray(base, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(ref), 1e-30))


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(rng.random((BATCH, NUM_DENSE), np.float32),
             np.stack([rng.integers(0, v, BATCH) for v in VOCABS], 1),
             (rng.random(BATCH) > 0.5).astype(np.float32)) for _ in range(n)]


def _flax():
    model = FlaxWideDeep(vocab_sizes=VOCABS, embed_dim=EMBED, mlp_dims=MLP,
                         num_dense=NUM_DENSE)
    d, c, _ = _batches(1)[0]
    params = flax.core.meta.unbox(model.init(jax.random.key(0), d, c)["params"])
    return model, jax.tree.map(np.asarray, params)


def _port(params):
    model = pw.WideDeep(VOCABS, EMBED, MLP, NUM_DENSE)
    model.load_state_dict(pw.params_from_flax(params))
    return model


def _port_loss(model, batch):
    d, c, y = (torch.from_numpy(a) for a in batch)
    return pw.sigmoid_binary_cross_entropy(model(d, c), y).mean()


def _flax_loss(model):
    def loss(params, batch):
        d, c, y = batch
        return optax.sigmoid_binary_cross_entropy(model.apply({"params": params}, d, c),
                                                  y).mean()
    return loss


def test_forward_and_every_gradient_against_flax():
    fmodel, params = _flax()
    batch = _batches(1, seed=1)[0]
    loss, grads = jax.jit(jax.value_and_grad(_flax_loss(fmodel)))(params, batch)
    logits = fmodel.apply({"params": params}, *batch[:2])
    model = _port(params)
    got = model(*(torch.from_numpy(a) for a in batch[:2]))
    assert _rel(got.detach().numpy(), logits) <= TOL
    ploss = _port_loss(model, batch)
    ploss.backward()
    assert abs(ploss.item() - float(loss)) <= TOL * abs(float(loss))
    want = pw.params_from_flax(jax.tree.map(np.asarray, grads))
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        assert _rel(p.grad.numpy(), want[name]) <= TOL, name


def test_init_params_and_the_state_dict_round_trip():
    model = pw.WideDeep(VOCABS, EMBED, MLP, NUM_DENSE)
    sd = pw.init_params(model, 3)
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    assert 0.015 < float(sd["emb.0.weight"].std()) < 0.025
    assert not sd["bias"].any() and not sd["mlp.0.bias"].any()
    torch.testing.assert_close(pw.init_params(model, 3)["emb.2.weight"], sd["emb.2.weight"])
    assert pw.shard_state_dict(model, sd)["wide.1.weight"].shape == (30, 1)   # no group: whole
    assert pw.full_state_dict(model).keys() == sd.keys()


def _train_port(model, optimizer_fn, batches, loss_fn):
    opt = optimizer_fn(model.parameters())
    losses = []
    for b in batches:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, b)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses


def _train_optax(tx, params, batches, loss_fn):
    @jax.jit
    def step(params, state, b):
        loss, g = jax.value_and_grad(loss_fn)(params, b)
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state, loss

    state, losses = tx.init(params), []
    for b in batches:
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("optimizer", ["port adagrad", "torch.optim.Adagrad (fault)"])
def test_three_adagrad_steps_against_optax(optimizer):
    fmodel, params = _flax()
    batches = _batches(3, seed=2)
    want_losses, want = _train_optax(optax.adagrad(0.05), params, batches, _flax_loss(fmodel))
    model = _port(params)
    fn = adagrad(0.05) if optimizer == "port adagrad" else (
        lambda p: torch.optim.Adagrad(p, lr=0.05))
    losses = _train_port(model, fn, batches, _port_loss)
    before, want = pw.params_from_flax(params), pw.params_from_flax(want)
    worst = max(_rel(p.detach().numpy(), want[n], before[n])
                for n, p in model.named_parameters())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    if optimizer == "port adagrad":
        assert loss_err <= TOL and worst <= TOL
    else:
        assert worst > 100 * TOL


class _Tree(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(params["b"].copy()))


def _tree_loss(w, b, x):
    return ((x @ w + b) ** 2).mean() + (w ** 4).sum()


@pytest.mark.parametrize("optimizer", ["port rmsprop", "torch.optim.RMSprop (fault)"])
def test_three_rmsprop_steps_with_exponential_decay_against_optax(optimizer):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    xs = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(3)]
    sched = optax.exponential_decay(0.045, 3, 0.94)
    want_losses, want = _train_optax(
        optax.rmsprop(sched, decay=0.9, eps=1.0, momentum=0.9), params, xs,
        lambda p, x: _tree_loss(p["w"], p["b"], x))
    model = _Tree(params)
    fn = (rmsprop(exponential_decay(0.045, 3, 0.94), decay=0.9, eps=1.0, momentum=0.9)
          if optimizer == "port rmsprop" else
          lambda p: torch.optim.RMSprop(p, lr=0.045, alpha=0.9, eps=1.0, momentum=0.9))
    losses = _train_port(model, fn, [torch.from_numpy(x) for x in xs],
                         lambda m, x: _tree_loss(m.w, m.b, x))
    worst = max(_rel(getattr(model, k).detach().numpy(), want[k], params[k]) for k in params)
    if optimizer == "port rmsprop":
        assert max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)) <= TOL
        assert worst <= TOL
    else:
        assert worst > 100 * TOL


def test_exponential_decay_is_optax_s():
    sched, want = exponential_decay(0.1, 4, 0.5), optax.exponential_decay(0.1, 4, 0.5)
    for count in (0, 1, 3, 4, 9):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-6)
    with pytest.raises(ValueError, match="transition_steps"):
        exponential_decay(0.1, 0, 0.5)
