"""Wide&Deep for Criteo-style CTR data with vocab-sharded embeddings.

Port of ``tensorflowonspark_tpu/models/wide_deep.py``.  Reference workload:
``examples/wide_deep`` trained in gRPC parameter-server mode, whose PS nodes
hold the big sparse embedding tables (``BASELINE.json`` configs[4]).  Here
the tables are :class:`~tensorflowonspark_tpu_torch.parallel.embedding.ShardedEmbedding`
over an embedding process group of ``num_ps`` ranks (``group``; ``None``
holds every table whole, the single-card case).

Inputs: ``dense`` ``[batch, num_dense]`` float features and ``categorical``
``[batch, num_categorical]`` integer ids (pre-hashed into each feature's
vocab).  Numerics follow the flax module: a wide ``[vocab, 1]`` float32
table and a deep ``[vocab, embed_dim]`` table a feature; the concatenation
is the dense features first, then the embeddings in feature order; the MLP
(``Dense`` + ReLU in ``dtype``) ends in a float32 ``Dense(1)`` and a scalar
``bias``; the result is the pre-sigmoid CTR logit.

:func:`params_from_flax` carries the flax module's ``params`` across;
:func:`init_params` draws the flax initialisers from a seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.resnet import _lecun_normal
from tensorflowonspark_tpu_torch.parallel.embedding import ShardedEmbedding


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class WideDeep(nn.Module):
    def __init__(self, vocab_sizes: Sequence[int], embed_dim: int = 16,
                 mlp_dims: Sequence[int] = (256, 128, 64), num_dense: int = 13,
                 dtype: torch.dtype = torch.float32, group=None):
        super().__init__()
        self.vocab_sizes, self.embed_dim = tuple(vocab_sizes), embed_dim
        self.mlp_dims, self.num_dense, self.dtype = tuple(mlp_dims), num_dense, dtype
        # float32 wide tables, as flax's ShardedEmbedding(dtype=float32)
        self.wide = nn.ModuleList(ShardedEmbedding(v, 1, group, torch.float32)
                                  for v in self.vocab_sizes)
        self.emb = nn.ModuleList(ShardedEmbedding(v, embed_dim, group, dtype)
                                 for v in self.vocab_sizes)
        dims = [num_dense + embed_dim * len(self.vocab_sizes), *self.mlp_dims]
        self.mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.head = nn.Linear(dims[-1], 1)
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, dense: torch.Tensor, categorical: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        wide_logit = torch.zeros(dense.shape[0], dtype=torch.float32, device=dense.device)
        parts = [dense.to(dt)]
        for i, (wide, emb) in enumerate(zip(self.wide, self.emb)):
            ids = categorical[:, i]
            wide_logit = wide_logit + wide(ids)[:, 0]
            parts.append(emb(ids))
        x = torch.cat(parts, dim=-1)
        for layer in self.mlp:
            x = F.relu(_dense(layer, x, dt))
        deep_logit = _dense(self.head, x, torch.float32)[:, 0]
        return wide_logit + deep_logit + self.bias[0]


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element-wise: ``-y log
    sigmoid(x) - (1 - y) log sigmoid(-x)``."""
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))


def _table_keys(model: WideDeep):
    return [f"{kind}.{i}.weight" for kind in ("wide", "emb") for i in range(len(model.vocab_sizes))]


def init_params(model: WideDeep, seed: int) -> dict:
    """The whole model's state dict (every table whole, whatever the
    model's group) drawn from ``seed`` with flax's initialisers: tables
    ``normal(0.02)``, Dense kernels ``lecun_normal``, biases and ``bias``
    0.  The tables are drawn with a CPU ``torch.Generator`` (tens of
    millions of rows, too slow through numpy), the MLP with numpy;
    :func:`shard_state_dict` cuts this rank's rows out of it."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for kind, width in (("wide", 1), ("emb", model.embed_dim)):
        for i, v in enumerate(model.vocab_sizes):
            sd[f"{kind}.{i}.weight"] = torch.empty(v, width).normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(seed)
    for name, layer in [(f"mlp.{k}", m) for k, m in enumerate(model.mlp)] + [("head", model.head)]:
        out_f, in_f = layer.weight.shape
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(_lecun_normal(rng, (in_f, out_f), in_f).T))
        sd[f"{name}.bias"] = torch.zeros(out_f)
    sd["bias"] = torch.zeros(1)
    return sd


def shard_state_dict(model: WideDeep, full: dict) -> dict:
    """This rank's part of a whole-model state dict (:func:`init_params`,
    :func:`params_from_flax`): each table's rows ``[offset, offset +
    shard)``, everything else as it is."""
    sd = dict(full)
    for key in _table_keys(model):
        kind, i, _ = key.split(".")
        mod = getattr(model, kind)[int(i)]
        rows = mod.weight.shape[0]
        sd[key] = full[key][mod.row_offset:mod.row_offset + rows]
    return sd


def full_state_dict(model: WideDeep) -> dict:
    """The whole model's state dict from a sharded model: each table's
    shards all-gathered over the model's group in rank order (every rank
    of the group must call this); the model's own state dict without a
    group."""
    import torch.distributed as dist

    sd = {k: v.detach() for k, v in model.state_dict().items()}
    first = model.wide[0] if len(model.wide) else None
    if first is None or first.shards == 1:
        return sd
    for key in _table_keys(model):
        shard = sd[key].contiguous()
        parts = [torch.empty_like(shard) for _ in range(first.shards)]
        dist.all_gather(parts, shard, group=first.group)
        sd[key] = torch.cat(parts)
    return sd


def params_from_flax(params: dict) -> dict:
    """A flax ``WideDeep``'s ``params`` (unboxed, numpy) as the whole
    model's state dict: ``wide_i``/``emb_i`` ``embedding`` become
    ``wide.i.weight``/``emb.i.weight``; ``Dense_k`` kernels ``(in, out)``
    become ``mlp.k.weight`` ``(out, in)``, the last one ``head``; ``bias``
    carries over."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    sd = {}
    for k, v in params.items():
        if k.startswith(("wide_", "emb_")):
            kind, i = k.split("_")
            sd[f"{kind}.{i}.weight"] = t(v["embedding"])
    for j, k in enumerate(dense):
        name = "head" if j == len(dense) - 1 else f"mlp.{j}"
        sd[f"{name}.weight"] = t(params[k]["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = t(params[k]["bias"])
    sd["bias"] = t(params["bias"])
    return sd
