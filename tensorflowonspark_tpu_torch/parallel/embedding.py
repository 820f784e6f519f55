"""Vocab-sharded embedding tables: the parameter-server replacement.

Port of ``tensorflowonspark_tpu/parallel/embedding.py``.  The reference's
parameter-server mode exists to hold large sparse embedding tables across
``num_ps`` nodes (the Wide&Deep/Criteo config, ``BASELINE.json``
configs[4]).  The JAX package shards such a table over the ``ep`` mesh axis;
here the table is sharded by vocab rows over a ``torch.distributed``
process group, the embedding group, whose size is the ``num_ps`` of the
examples:

- :class:`ShardedEmbedding` — an ``nn.Module`` holding this rank's rows
  ``[num_embeddings / n, features]``; with no group, or a group of one, it
  holds the whole table (the single-card case);
- :func:`sharded_embedding_lookup` — each rank gathers the rows in its
  range (zeros elsewhere) and a sum all-reduce assembles the embeddings,
  one all-reduce of activations instead of a gather of the table;
- :func:`build_sparse_embedding_train_step` — the reference's PS-mode
  sparse optimizer semantics: only the rows a batch touches are read or
  written.

Layout: along the embedding group every rank holds the same batch and the
same loss, as the JAX mesh replicates the data over ``ep``.  So each
rank's gradient of the looked-up rows is already the whole ``dL/demb``,
and the all-reduce's backward is the identity (:class:`_SumOverGroup`):
an all-reduce of the gradient would scale every table gradient by the
group's size.  Mixing a data-parallel axis with the embedding group waits
for the port's ``DeviceMesh`` (ROADMAP A6).

Every gather and scatter here is plain PyTorch: the JAX package lowers them
through XLA, not Pallas.  Updates with duplicate ids are deterministic on
the card: the ids are sorted (stable) and their gradients segment-summed
before a scatter with unique indices, never an atomic ``index_add_`` over
duplicates.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def group_rank_size(group) -> tuple[int, int]:
    """``(rank, size)`` in ``group``; ``(0, 1)`` for ``None`` (no sharding)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class _SumOverGroup(torch.autograd.Function):
    """Sum over the embedding group whose backward is the identity: every
    rank holds the same loss, so the gradient reaching each rank is already
    the whole ``dL/demb`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, group=None):
    """The rows of ``ids`` from a vocab-sharded table.

    ``table`` is this rank's slice ``[vocab / n, features]`` (rank ``r``
    holds global rows ``[r * vocab / n, (r + 1) * vocab / n)``); ``ids`` are
    *global* ids, the same on every rank of ``group``.  Each rank gathers
    the rows it owns (zeros elsewhere) and a sum all-reduce assembles the
    full embeddings.  With ``group=None``, or a group of one, it is a plain
    gather."""
    rank, n = group_rank_size(group)
    if n == 1:
        return F.embedding(ids, table)
    shard = table.shape[0]
    local = ids - rank * shard
    in_range = (local >= 0) & (local < shard)
    rows = F.embedding(local.clamp(0, shard - 1), table)
    rows = torch.where(in_range[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))
    return _SumOverGroup.apply(rows, group)


def apply_sharded_lookup(group, table: torch.Tensor, ids: torch.Tensor):
    """:func:`sharded_embedding_lookup` of this rank's shard, as the JAX
    package's wrapper runs it under ``shard_map`` over ``mesh``.  Here each
    process already holds its shard, so ``group`` stands where the mesh
    stood."""
    return sharded_embedding_lookup(table, ids, group)


class ShardedEmbedding(nn.Module):
    """Embedding whose ``[num_embeddings, features]`` table is vocab-sharded
    over ``group``: ``weight`` holds this rank's ``num_embeddings / n`` rows
    (all of them with no group or a group of one), initialised
    ``normal(0.02)`` from ``generator`` as the JAX module initialises it.
    ``forward(ids)`` returns the rows in ``dtype`` (the JAX module casts the
    table to ``dtype`` before the gather; gathering first gives the same
    values)."""

    def __init__(self, num_embeddings: int, features: int, group=None,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        rank, n = group_rank_size(group)
        if num_embeddings % n:
            raise ValueError(f"num_embeddings={num_embeddings} does not divide over an "
                             f"embedding group of {n}")
        self.num_embeddings, self.features = num_embeddings, features
        self.group, self.dtype, self.rank, self.shards = group, dtype, rank, n
        self.weight = nn.Parameter(torch.empty(num_embeddings // n, features, device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)

    @property
    def row_offset(self) -> int:
        """The global id of this rank's first row."""
        return self.rank * self.weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return sharded_embedding_lookup(self.weight, ids, self.group).to(self.dtype)


def _segment_sums(local: torch.Tensor, *values: torch.Tensor):
    """``(unique ids, per-id sums of each of values)``: the ids sorted
    stably, each value's rows summed over every occurrence of an id in
    batch order.  Deterministic on the card (no atomics)."""
    ids, order = torch.sort(local, stable=True)
    uniq, counts = torch.unique_consecutive(ids, return_counts=True)
    return uniq, [torch.segment_reduce(v[order], "sum", lengths=counts, axis=0)
                  for v in values]


def _sparse_rows_update(table, acc, local, g, lr, eps, optimizer):
    """Per-shard sparse update: touch ONLY the batch's rows, in place.

    ``local`` are this shard's row indices (global id minus the shard's
    first row; values outside ``[0, shard_vocab)`` belong to other shards
    and are masked).  ``g`` are the loss gradients of the LOOKED-UP rows
    ``[B, F]``, not a ``[V, F]`` table gradient.  Duplicate ids are summed
    before the accumulator is read back, so adagrad sees ``acc += sum(g_i^2)``
    and the row update is ``-lr * sum(g_i) / sqrt(acc_new + eps)``, as the
    JAX package's one fused scatter-add gives.  ``sgd`` never reads or
    writes ``acc`` (the table itself may be passed as the slot).  Returns
    ``(table, acc)``."""
    shard = table.shape[0]
    local = local.reshape(-1)
    g = g.reshape(local.shape[0], -1)
    in_range = (local >= 0) & (local < shard)
    g = torch.where(in_range[:, None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    g = g.to(table.dtype)
    safe = local.clamp(0, shard - 1)
    if optimizer == "sgd":
        rows, (gsum,) = _segment_sums(safe, g)
        table.index_add_(0, rows, gsum, alpha=-lr)
        return table, acc
    if optimizer == "adagrad":
        rows, (gsum, g2sum) = _segment_sums(safe, g, g * g)
        acc.index_add_(0, rows, g2sum)
        denom = torch.sqrt(acc[rows] + eps)
        table.index_add_(0, rows, -lr * gsum / denom)
        return table, acc
    raise ValueError(f"unknown sparse optimizer {optimizer!r}")


def build_sparse_embedding_train_step(group, loss_fn, lr: float = 0.05,
                                      optimizer: str = "adagrad", eps: float = 1e-8):
    """A train step with the reference's PS-mode SPARSE optimizer semantics:
    only the rows a batch touches are read or written.

    The reference's parameter-server mode trains Criteo-class tables with
    ``IndexedSlices`` gradients (``SparseApply*`` kernels on the gathered
    rows).  The dense path (``ShardedEmbedding`` and a dense optimizer)
    materialises a ``[V, F]`` gradient and rewrites the whole table and
    optimizer state every step, O(vocab) memory traffic; this step's cost
    scales with the batch.

    ``loss_fn(emb, tgt) -> scalar`` defines the objective on the looked-up
    embeddings ``[B, F]``.  Returns ``step(table, slot, ids, tgt) -> (table,
    slot, loss)``: ``table`` is this rank's shard of a table vocab-sharded
    over ``group`` (``None``: the whole table), ``slot`` the adagrad
    accumulator (``zeros_like(table)``, as the JAX step takes it), both
    updated in place.  For ``optimizer="sgd"`` the slot is unused and
    returned as it is, so passing the table itself as the slot is safe."""
    if optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"unknown sparse optimizer {optimizer!r}")
    rank, _ = group_rank_size(group)

    def step(table, slot, ids, tgt):
        with torch.no_grad():
            emb = sharded_embedding_lookup(table, ids, group)
        emb.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(emb, tgt)
            (g,) = torch.autograd.grad(loss, emb)
        with torch.no_grad():
            table, slot = _sparse_rows_update(table, slot, ids - rank * table.shape[0], g,
                                              lr, eps, optimizer)
        return table, slot, loss.detach()

    return step
