"""The port's data-parallel strategy (``parallel/strategy.py``).

The JAX strategy's contract, held on the CPU: gradient accumulation equals
one step on the whole batch; ``has_aux`` and the three-argument
``loss_fn`` with ``extras`` write-back; per-step generators seeded from
``(seed, step, rank)``; and a two-process gloo DDP step whose gradients
equal one process's gradients on the concatenated batch, and whose two
replicas draw different dropout masks.

Tolerances (float32): ``atol=1e-6`` on parameters and gradients of
magnitude ~1 — the same products summed in another order (microbatch
means averaged, or DDP's all-reduced average of two local means).
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.models.bert import (BertConfig, build_qa_model,
                                                     init_params)
from tensorflowonspark_tpu_torch.parallel import (DataParallelStrategy,
                                                  MultiWorkerMirroredStrategy,
                                                  TrainState, all_gather_batch,
                                                  cross_replica_mean, step_generator)

WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _model(seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))


def _batch(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 6), dtype=np.float32),
            rng.integers(0, 3, n).astype(np.int64))


def _ce_loss(model, batch):
    x, y = batch
    return nn.functional.cross_entropy(model(x), y)


def test_accumulation_equals_one_step_on_the_whole_batch():
    strategy = DataParallelStrategy("cpu")
    sgd = lambda p: torch.optim.SGD(p, lr=0.5)  # noqa: E731
    whole = strategy.init_state(_model(), sgd)
    accum = strategy.init_state(_model(), sgd)
    batch = strategy.shard_batch(_batch())
    _, m1 = strategy.build_train_step(_ce_loss)(whole, batch)
    _, m4 = strategy.build_train_step(_ce_loss, accum_steps=4)(accum, batch)
    assert whole.step == accum.step == 1
    torch.testing.assert_close(m4["loss"], m1["loss"], atol=1e-6, rtol=0)
    for a, b in zip(whole.model.parameters(), accum.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        strategy.build_train_step(_ce_loss, accum_steps=3)(accum, batch)
    assert MultiWorkerMirroredStrategy is DataParallelStrategy
    assert strategy.num_replicas_in_sync == 1


def test_aux_and_extras_are_written_back():
    def loss_fn(model, batch, extras):
        loss = _ce_loss(model, batch)
        return loss, {"acc": torch.tensor(0.5), "extras": {"calls": extras["calls"] + 1}}
    loss_fn.has_aux = True

    strategy = DataParallelStrategy("cpu")
    state = strategy.init_state(_model(), lambda p: torch.optim.SGD(p, lr=0.1))
    state.extras = {"calls": 0}
    batch = strategy.shard_batch(_batch())
    state, metrics = strategy.build_train_step(loss_fn)(state, batch)
    assert sorted(metrics) == ["acc", "loss"] and metrics["acc"] == 0.5
    assert state.extras == {"calls": 1}
    state, _ = strategy.build_train_step(loss_fn, accum_steps=2)(state, batch)
    assert state.extras == {"calls": 3}                  # threaded through both microbatches
    assert isinstance(state, TrainState) and state.step == 2


def test_per_step_generators_give_reproducible_dropout():
    """The ``rng`` a ``loss_fn`` receives depends on ``(seed, step, rank)``
    only: the same tuple draws the same BERT dropout masks, another step
    (or seed, rank or microbatch) different ones."""
    cfg = BertConfig(vocab_size=50, hidden_size=64, num_layers=1, num_heads=4,
                     intermediate_size=128, max_position_embeddings=16,
                     dropout_rate=0.3, dtype=torch.float32)
    model = build_qa_model(cfg, init_params(cfg, 0), "cpu")
    ids = torch.arange(32).reshape(2, 16) % 50

    def logits(seed, step, **fold):
        return model(ids, train=True, rng=step_generator(seed, step, "cpu", **fold))[0]

    torch.testing.assert_close(logits(7, 3), logits(7, 3), atol=0, rtol=0)
    for seed, step, fold in [(7, 4, {}), (8, 3, {}), (7, 3, {"rank": 1}),
                             (7, 3, {"micro": 1}), (7, 3, {"rank": 1, "micro": 1})]:
        assert not torch.equal(logits(7, 3), logits(seed, step, **fold)), (seed, step, fold)

    seen = []

    def loss_fn(model, batch, rng=None):
        seen.append(torch.rand(4, generator=rng))
        return _ce_loss(model, batch)

    strategy = DataParallelStrategy("cpu", seed=7)
    step = strategy.build_train_step(loss_fn)
    for _ in range(2):
        state = strategy.init_state(_model(), lambda p: torch.optim.SGD(p, lr=0.1))
        for _ in range(2):
            state, _ = step(state, strategy.shard_batch(_batch()))
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    assert not torch.equal(seen[0], seen[1])
    torch.testing.assert_close(seen[0], torch.rand(4, generator=step_generator(7, 0, "cpu")))


DROPOUT_CFG = dict(vocab_size=50, hidden_size=32, num_layers=1, num_heads=2,
                   intermediate_size=64, max_position_embeddings=16,
                   dropout_rate=0.1, dtype=torch.float32)
DROPOUT_IDS = np.arange(32).reshape(2, 16) % 50


def _dropout_logits(model, ids, rng):
    ids = torch.as_tensor(ids)
    return model(ids, None, ids % 2, train=True, rng=rng)[0]


def _ddp_fun(args, ctx):
    """One DDP step on this process's half of the batch; save the
    all-reduced gradients and the collective helpers' results.  Then one
    DDP step of a tiny BERT at dropout 0.1 on the same ids in both
    processes; save the logits its ``rng`` gave."""
    import torch.distributed as dist

    ctx.initialize_distributed(device="cpu")
    strategy = DataParallelStrategy("cpu")
    state = strategy.init_state(_model(seed=ctx.executor_id),  # DDP broadcasts rank 0's
                                lambda p: torch.optim.SGD(p, lr=0.0))
    x, y = _batch()
    half = slice(4 * ctx.executor_id, 4 * ctx.executor_id + 4)
    strategy.build_train_step(_ce_loss)(state, strategy.shard_batch((x[half], y[half])))
    out = {f"grad{i}": p.grad.numpy() for i, p in enumerate(state.module.parameters())}

    seen = []

    def dropout_loss(model, ids, rng):
        seen.append(_dropout_logits(model, ids, rng))
        return seen[-1].sum()

    cfg = BertConfig(**DROPOUT_CFG)
    strategy = DataParallelStrategy("cpu", seed=7)
    state = strategy.init_state(build_qa_model(cfg, init_params(cfg, 0), "cpu"),
                                lambda p: torch.optim.SGD(p, lr=0.0))
    strategy.build_train_step(dropout_loss)(state, strategy.shard_batch(DROPOUT_IDS))
    out["dropout_logits"] = seen[0].detach().numpy()
    out["mean"] = cross_replica_mean(torch.tensor([float(ctx.executor_id)])).numpy()
    out["gathered"] = all_gather_batch(torch.tensor([[ctx.executor_id] * 2])).numpy()
    out["replicas"] = np.array(strategy.num_replicas_in_sync)
    dist.destroy_process_group()
    np.savez(os.path.join(ctx.working_dir, f"ddp.{ctx.executor_id}.npz"), **out)


@pytest.mark.integration
def test_two_process_ddp_step_equals_one_process_on_the_whole_batch(tmp_path):
    cluster = TPUCluster.run(_ddp_fun, {}, 2, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=60, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path))
    cluster.shutdown(timeout=60)
    got = [dict(np.load(tmp_path / f"ddp.{i}.npz")) for i in range(2)]

    strategy = DataParallelStrategy("cpu")
    state = strategy.init_state(_model(seed=0), lambda p: torch.optim.SGD(p, lr=0.0))
    strategy.build_train_step(_ce_loss)(state, strategy.shard_batch(_batch()))
    for i, p in enumerate(state.model.parameters()):
        for rank in range(2):
            np.testing.assert_allclose(got[rank][f"grad{i}"], p.grad.numpy(), atol=1e-6)
    for rank in range(2):
        np.testing.assert_allclose(got[rank]["mean"], [0.5])
        np.testing.assert_array_equal(got[rank]["gathered"], [[0, 0], [1, 1]])
        assert int(got[rank]["replicas"]) == 2
    # dropout: each replica's masks are its own, and reproducible from
    # (seed, step, rank) alone
    cfg = BertConfig(**DROPOUT_CFG)
    model = build_qa_model(cfg, init_params(cfg, 0), "cpu")
    assert not np.array_equal(got[0]["dropout_logits"], got[1]["dropout_logits"])
    for rank in range(2):
        want = _dropout_logits(model, DROPOUT_IDS, step_generator(7, 0, "cpu", rank=rank))
        np.testing.assert_allclose(got[rank]["dropout_logits"], want.detach().numpy(),
                                   atol=1e-6, rtol=0)
    assert cross_replica_mean(torch.ones(2)).tolist() == [1.0, 1.0]    # no group: identity
    assert all_gather_batch(torch.ones(2, 1)).shape == (2, 1)
