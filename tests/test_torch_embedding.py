"""The port's vocab-sharded embedding (``parallel/embedding.py``) against
the JAX package's on the CPU.

- ``_sparse_rows_update`` for ``sgd`` and ``adagrad`` on ids with heavy
  duplicates (one id over the whole batch; a few ids repeated; ids past the
  shard, which must be masked) against the JAX function on the same table,
  slot and gradients: ``||port - jax|| / ||jax - before|| <= 1e-5`` on the
  table and the slot (float32 sums of up to 64 duplicates in another order,
  and ``-lr * sum(g) / d`` where JAX sums ``-lr * g / d``; seen: 3.6e-6),
  and every row no id touched equal bit for bit;
- ``build_sparse_embedding_train_step`` at one shard (no group) against
  the JAX step on a one-device ``ep`` mesh, three steps: losses within
  1e-6 relative, tables and slots within 1e-5 as above;
- ``ShardedEmbedding`` without a group against flax's ``ShardedEmbedding``
  (the same table): the gather bit for bit;
- two gloo processes (one embedding group of two): the sharded lookup
  equals the single table's rows bit for bit; each shard's table gradient
  equals the single table's gradient over its rows (1e-7), not twice it
  (the all-reduce's backward is the identity); and two sparse adagrad steps
  on the shards equal the single-table step's rows (1e-5);
- ``bench_embedding`` at a tiny size on the CPU (its keys; no device
  number is read here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.parallel import embedding as je
from tensorflowonspark_tpu.parallel import make_mesh
from tensorflowonspark_tpu.parallel.mesh import MeshSpec
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.parallel import embedding as pe

TOL = 1e-5
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
V, F = 40, 8


def _rel(got, want, before) -> float:
    got, want, before = (np.asarray(a, np.float64) for a in (got, want, before))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want - before), 1e-30))


def _ids(kind: str, rng, n: int = 64) -> np.ndarray:
    if kind == "one_id":                           # one id over the whole batch
        return np.full(n, 7, np.int64)
    if kind == "few_ids":                          # heavy duplicates
        return rng.choice([0, 3, 3, 3, 11, V - 1], size=n).astype(np.int64)
    ids = rng.integers(-5, V + 5, size=n)          # some past the shard: masked
    return ids.astype(np.int64)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("kind", ["one_id", "few_ids", "out_of_shard"])
def test_sparse_rows_update_against_jax(optimizer, kind):
    rng = np.random.default_rng(["sgd", "adagrad"].index(optimizer) * 10 + len(kind))
    table = rng.standard_normal((V, F)).astype(np.float32)
    acc = rng.random((V, F)).astype(np.float32)
    local = _ids(kind, rng)
    g = rng.standard_normal((len(local), F)).astype(np.float32)
    want_t, want_a = je._sparse_rows_update(jnp.asarray(table), jnp.asarray(acc),
                                            jnp.asarray(local), jnp.asarray(g), 0.05, 1e-8,
                                            optimizer)
    got_t, got_a = pe._sparse_rows_update(torch.from_numpy(table.copy()),
                                          torch.from_numpy(acc.copy()), torch.from_numpy(local),
                                          torch.from_numpy(g), 0.05, 1e-8, optimizer)
    assert _rel(got_t, want_t, table) <= TOL
    assert _rel(got_a, want_a, acc) <= TOL if optimizer == "adagrad" else np.array_equal(
        got_a.numpy(), acc)
    untouched = np.setdiff1d(np.arange(V), local)
    np.testing.assert_array_equal(got_t.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], acc[untouched])


def test_sparse_rows_update_rejects_an_unknown_optimizer():
    t = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        pe._sparse_rows_update(t, t, torch.tensor([0]), torch.zeros(1, 2), 0.1, 1e-8, "adam")
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        pe.build_sparse_embedding_train_step(None, lambda e, t: e.sum(), optimizer="adam")


def _mse(e, t):
    return ((e - t) ** 2).mean()


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_sparse_train_step_one_shard_against_jax(optimizer):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((V, F)).astype(np.float32) * 0.02
    ids = [rng.integers(0, V, size=(16, 3)).astype(np.int64) for _ in range(3)]
    tgts = [rng.standard_normal((16, 3, F)).astype(np.float32) for _ in range(3)]
    mesh = make_mesh(MeshSpec(ep=1, dp=1), devices=jax.devices()[:1])
    jstep = je.build_sparse_embedding_train_step(mesh, lambda e, t: jnp.mean((e - t) ** 2),
                                                 lr=0.05, optimizer=optimizer)
    jt, ja = jnp.asarray(table), jnp.zeros_like(jnp.asarray(table))
    pstep = pe.build_sparse_embedding_train_step(None, _mse, lr=0.05, optimizer=optimizer)
    pt, pa = torch.from_numpy(table.copy()), torch.zeros(V, F)
    for i, t in zip(ids, tgts):
        jt, ja, jl = jstep(jt, ja, jnp.asarray(i), jnp.asarray(t))
        pt, pa, pl = pstep(pt, pa, torch.from_numpy(i), torch.from_numpy(t))
        assert abs(float(pl) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(pt, jt, table) <= TOL
    if optimizer == "adagrad":
        assert _rel(pa, ja, np.zeros_like(table)) <= TOL
    else:
        assert not pa.any()                        # sgd leaves the slot alone


def test_sgd_step_takes_the_table_as_its_slot():
    table = torch.randn(V, F)
    step = pe.build_sparse_embedding_train_step(None, _mse, lr=0.1, optimizer="sgd")
    want, _, _ = step(table.clone(), torch.zeros(V, F), torch.tensor([1, 1, 2]),
                      torch.zeros(3, F))
    t = table.clone()
    got, slot, _ = step(t, t, torch.tensor([1, 1, 2]), torch.zeros(3, F))
    assert slot is got
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sharded_embedding_without_a_group_is_flax_gather(monkeypatch):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((V, F)).astype(np.float32)
    ids = rng.integers(0, V, size=(4, 6))
    want = je.ShardedEmbedding(V, F).apply({"params": {"embedding": jnp.asarray(table)}},
                                           jnp.asarray(ids))
    mod = pe.ShardedEmbedding(V, F, generator=torch.Generator().manual_seed(0))
    assert 0.015 < float(mod.weight.detach().std()) < 0.025          # normal(0.02)
    mod.load_state_dict({"weight": torch.from_numpy(table)})
    np.testing.assert_array_equal(mod(torch.from_numpy(ids)).detach().numpy(), np.asarray(want))
    monkeypatch.setattr(pe, "group_rank_size", lambda group: (0, group))
    with pytest.raises(ValueError, match="does not divide"):
        pe.ShardedEmbedding(V, F, group=3)


# ------------------------------------------------------------- two ranks

TABLE_SEED, STEPS = 11, 2


def _two_rank_data():
    rng = np.random.default_rng(TABLE_SEED)
    table = rng.standard_normal((V, F)).astype(np.float32)
    ids = rng.integers(0, V, size=(3, 12, 5)).astype(np.int64)
    ids[:, :, 0] = 2                              # a duplicate in every row
    tgts = rng.standard_normal((3, 12, 5, F)).astype(np.float32)
    return table, ids, tgts


def _loss(emb, tgt):
    return (emb * tgt).sum() + (emb ** 2).sum()


def _two_rank_fun(args, ctx):
    import torch.distributed as dist

    ctx.initialize_distributed(device="cpu")
    group = dist.group.WORLD
    table, ids, tgts = _two_rank_data()
    mod = pe.ShardedEmbedding(V, F, group=group)
    rows = slice(mod.row_offset, mod.row_offset + mod.weight.shape[0])
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(table[rows]))
    emb = mod(torch.from_numpy(ids[0]))
    _loss(emb, torch.from_numpy(tgts[0])).backward()
    out = {"emb": emb.detach().numpy(), "grad": mod.weight.grad.numpy(),
           "lookup": pe.apply_sharded_lookup(group, mod.weight.detach(),
                                             torch.from_numpy(ids[1])).numpy()}
    step = pe.build_sparse_embedding_train_step(group, _loss, lr=0.05, optimizer="adagrad")
    t, a = mod.weight.detach().clone(), torch.zeros_like(mod.weight)
    for i in range(STEPS):
        t, a, loss = step(t, a, torch.from_numpy(ids[i]), torch.from_numpy(tgts[i]))
    out.update(table=t.numpy(), slot=a.numpy(), loss=loss.numpy(), start=np.array(rows.start))
    dist.destroy_process_group()
    np.savez(os.path.join(ctx.working_dir, f"emb.{ctx.executor_id}.npz"), **out)


@pytest.mark.integration
def test_two_rank_embedding_group_equals_one_table(tmp_path):
    cluster = TPUCluster.run(_two_rank_fun, {}, 2, input_mode=InputMode.TENSORFLOW,
                             reservation_timeout=60, worker_env=WORKER_ENV,
                             working_dir=str(tmp_path))
    cluster.shutdown(timeout=60)
    got = [dict(np.load(tmp_path / f"emb.{i}.npz")) for i in range(2)]

    table, ids, tgts = _two_rank_data()
    whole = torch.from_numpy(table.copy()).requires_grad_()
    emb = torch.nn.functional.embedding(torch.from_numpy(ids[0]), whole)
    _loss(emb, torch.from_numpy(tgts[0])).backward()
    step = pe.build_sparse_embedding_train_step(None, _loss, lr=0.05, optimizer="adagrad")
    t, a = torch.from_numpy(table.copy()), torch.zeros(V, F)
    for i in range(STEPS):
        t, a, loss = step(t, a, torch.from_numpy(ids[i]), torch.from_numpy(tgts[i]))
    shard = V // 2
    for rank, g in enumerate(got):
        rows = slice(int(g["start"]), int(g["start"]) + shard)
        assert rows.start == rank * shard
        np.testing.assert_array_equal(g["emb"], emb.detach().numpy())
        np.testing.assert_array_equal(g["lookup"], table[ids[1]])
        np.testing.assert_allclose(g["grad"], whole.grad.numpy()[rows], rtol=0, atol=1e-7)
        assert np.abs(whole.grad.numpy()[rows]).max() > 0       # the rank's rows were touched
        assert _rel(g["table"], t.numpy()[rows], table[rows]) <= TOL
        assert _rel(g["slot"], a.numpy()[rows], np.zeros((shard, F))) <= TOL
        assert abs(float(g["loss"]) - float(loss)) <= 1e-6 * abs(float(loss))


def test_bench_embedding_runs_at_a_tiny_size_on_the_cpu():
    from tensorflowonspark_tpu_torch import bench_embedding

    out = bench_embedding.bench(vocab=500, features=8, batch=64, steps=2, device="cpu",
                                criteo=False)
    assert out["device"] == "cpu" and out["card"] is None and len(out["rows"]) == 1
    row = out["rows"][0]
    assert row["table_MB"] == row["sparse_state_MB"] == 500 * 8 * 4 / 1e6
    for kind in ("dense", "sparse"):
        assert row[kind]["step_ms"] > 0 and row[kind]["peak_MB"] is None
        assert row[kind]["lookups_per_s"] == pytest.approx(64 / row[kind]["step_ms"] * 1e3)
        assert "step_ms_batch_8" in row[kind]
    assert bench_embedding.CRITEO_LARGEST == (10_131_227, 16)
