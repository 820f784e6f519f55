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
  where ``torch.optim.RMSprop`` must miss it; the schedule's values;
- the example's ``--num_ps 2`` over 4 ranks (a gloo group of CPU
  processes, ``tests/torch_model_parallel_worker.py`` suite ``wide_deep``):
  the ``{ep: 2, dp: 2}`` mesh, each rank's rows, and one adagrad step's
  loss and weights against the JAX example's step on its
  ``mesh_from_num_ps(2)`` mesh of 4 CPU devices, from flax's init: the
  same bound.  The JAX side is built as the JAX example builds it: one
  batch of ``--batch_size`` rows from ``default_rng(17)`` put on
  ``P(("dp", "fsdp"))``, so a step trains on ``--batch_size`` rows; each
  port rank must hold its ``dp`` block of that batch.
"""

import flax
import jax
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models import WideDeep as FlaxWideDeep
from tensorflowonspark_tpu_torch.examples.wide_deep import wide_deep_criteo as wdc
from tensorflowonspark_tpu_torch.models import wide_deep as pw
from tensorflowonspark_tpu_torch.parallel import adagrad, exponential_decay, rmsprop
from tests.torch_world import run_world

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


#: the example's flags for the ``ep`` x ``dp`` case: 4 ranks, ``--num_ps 2``
EP_DP_ARGS = {"num_ps": 2, "vocab_size": 24, "embed_dim": 4, "batch_size": 8, "steps": 1,
              "lr": 0.05, "seed": 0}


def _ep_dp_cases():
    """flax's init of the JAX example's model (key 0, on its init batch),
    carried over as the whole model's state dict."""
    import argparse

    args = argparse.Namespace(**EP_DP_ARGS)
    model = FlaxWideDeep(vocab_sizes=[args.vocab_size] * wdc.NUM_CATEGORICAL,
                         embed_dim=args.embed_dim)
    d, c, _ = wdc._batch(np.random.default_rng(17), [args.vocab_size] * wdc.NUM_CATEGORICAL,
                         args.batch_size)
    boxed = model.init(jax.random.key(0), d, c)["params"]
    init = {k: v.numpy() for k, v in pw.params_from_flax(jax.tree.map(
        np.asarray, flax.core.meta.unbox(boxed))).items()}
    return {"wide_deep": {"args": EP_DP_ARGS, "init": init}}, model, boxed


def _jax_example_step(model, boxed):
    """The JAX example's step on ``mesh_from_num_ps(2)`` over 4 devices,
    from flax's init ``boxed`` (with its partitioning): tables over ep, one
    batch of ``--batch_size`` rows from ``default_rng(17)`` (the JAX
    example's executor 0, after its init batch) over dp."""
    import argparse

    from jax.sharding import NamedSharding, PartitionSpec as JP

    from tensorflowonspark_tpu.parallel.mesh import mesh_from_num_ps
    from tensorflowonspark_tpu.parallel.sharding import flax_shardings

    args = argparse.Namespace(**EP_DP_ARGS)
    mesh = mesh_from_num_ps(args.num_ps, devices=jax.devices()[:4])
    dense, cat, label = next(wdc.batches(args, 17))
    dp = mesh.shape["dp"]
    shards = [tuple(np.split(a, dp)[d] for a in (dense, cat, label)) for d in range(dp)]
    tx = optax.adagrad(args.lr)
    with mesh:
        placed = jax.device_put(flax.core.meta.unbox(boxed),
                                flax.core.meta.unbox(flax_shardings(mesh, boxed)))
        tables = sum(1 for leaf in jax.tree.leaves(placed) if "ep" in str(leaf.sharding.spec))
        rows = NamedSharding(mesh, JP(("dp", "fsdp")))

        @jax.jit
        def step(params, state, d, c, y):
            def loss_fn(p):
                return optax.sigmoid_binary_cross_entropy(
                    model.apply({"params": p}, d, c), y).mean()
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, state = tx.update(grads, state, params)
            return optax.apply_updates(params, updates), loss
        new, loss = step(placed, tx.init(placed), *(jax.device_put(a, rows)
                                                     for a in (dense, cat, label)))
    return {"loss": float(loss), "tables_on_ep": tables, "shards": shards,
            "params": pw.params_from_flax(jax.tree.map(np.asarray, jax.device_get(new)))}


@pytest.fixture(scope="module")
def ep_dp_runs(tmp_path_factory):
    cases, model, boxed = _ep_dp_cases()
    return run_world("wide_deep", cases, lambda: _jax_example_step(model, boxed),
                     tmp_path_factory.mktemp("torch_wide_deep_ep_dp")), cases


def test_num_ps_2_of_4_ranks_matches_the_jax_example_mesh(ep_dp_runs):
    """``--num_ps 2`` over 4 ranks: the mesh is ``{ep: 2, dp: 2}``; rank r
    (dp index r // 2) trains on its dp block of the one ``--batch_size``
    batch from ``default_rng(17)`` and holds half of every table's rows;
    the mean of the dp blocks' losses (the global batch's mean) and every
    weight after one step (tables all-gathered over ep) match the JAX
    example's step over that batch."""
    (want, got), cases = ep_dp_runs
    assert want["tables_on_ep"] == 2 * wdc.NUM_CATEGORICAL
    for r, rank in enumerate(got):
        assert len(rank["rows"][0]) == EP_DP_ARGS["batch_size"] // 2
        assert rank["deep_rows"] == EP_DP_ARGS["vocab_size"] // 2
        for a, b in zip(rank["rows"], want["shards"][r // 2]):
            np.testing.assert_array_equal(a, b)
    loss = np.mean([got[0]["losses"][0], got[2]["losses"][0]])
    assert abs(loss - want["loss"]) <= TOL * abs(want["loss"])
    init = cases["wide_deep"]["init"]
    for rank in got:
        worst = max(_rel(rank["params"][n], want["params"][n], init[n]) for n in init)
        assert worst <= TOL
    assert got[0]["params"]["emb.3.weight"].shape == (EP_DP_ARGS["vocab_size"],
                                                       EP_DP_ARGS["embed_dim"])


def test_local_batches_cut_the_global_batch_and_refuse_an_uneven_dp():
    """Each rank's block is its dp slice of the global ``default_rng(17)``
    batch (a rank with no mesh trains on the whole batch); a ``dp`` that
    does not divide ``--batch_size`` raises."""
    import argparse

    args = argparse.Namespace(**EP_DP_ARGS)
    whole = next(wdc.batches(args))
    assert all(np.array_equal(a, b) for a, b in zip(next(wdc.local_batches(args, None)), whole))

    class Mesh:                                  # 4 ranks, dp 2: this rank's dp index 1
        mesh_dim_names = ("pp", "dp", "fsdp", "ep", "sp", "tp")

        def size(self, dim=None):
            return {1: 2, 3: 2}.get(dim, 1)

        def get_local_rank(self, axis):
            return {"dp": 1}.get(axis, 0)

    block = next(wdc.local_batches(args, Mesh()))
    for a, b in zip(block, whole):
        np.testing.assert_array_equal(a, b[4:])
    with pytest.raises(ValueError, match="does not split over dp=2"):
        next(wdc.local_batches(argparse.Namespace(**{**EP_DP_ARGS, "batch_size": 7}), Mesh()))
