"""Sharding helpers: batch specs, parameter partition rules, placement.

Port of ``tensorflowonspark_tpu/parallel/sharding.py``.  A spec is the
JAX package's ``PartitionSpec`` shape, kept here as :class:`P`: one entry
a tensor dim, each ``None`` (replicated), an axis name, or a tuple of axis
names (the dim split over several mesh axes, major first).
:func:`named_sharding` turns a spec into DTensor placements over a
:class:`~torch.distributed.device_mesh.DeviceMesh` (one placement a mesh
axis: ``Shard(dim)`` where the spec names the axis, else
``Replicate()``), and :func:`shard_params` places tensors as DTensors.

Eager PyTorch runs each rank on its own block, so the batch helpers hand
back this rank's block as a plain tensor (:func:`shard_batch`,
:func:`local_block`) where the JAX package hands back a global array
laid out over the mesh.
"""

from __future__ import annotations

import re

import numpy as np

DATA_AXES = ("dp", "fsdp")  # batch dimension shards over both


class P(tuple):
    """A partition spec: ``P(None, "tp")``, ``P(("dp", "fsdp"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def batch_pspec(extra_leading: int = 0) -> P:
    """Spec for a batch: leading dim over (dp, fsdp)."""
    return P(*([None] * extra_leading), DATA_AXES)


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def named_sharding(mesh, *spec) -> list:
    """DTensor placements for ``spec`` over ``mesh``: ``Shard(d)`` on the
    mesh axes that tensor dim ``d`` names, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for axis in _axes_of(entry):
            if axis not in mesh.mesh_dim_names:
                raise ValueError(f"spec {P(*spec)!r} names {axis!r}, not an axis of "
                                 f"the mesh {mesh.mesh_dim_names}")
            dim_of[axis] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    """Placements of a tensor held whole by every rank."""
    return named_sharding(mesh)


def local_block(x, mesh, spec):
    """This rank's block of ``x`` (the whole tensor, the same on every
    rank) under ``spec``: each dim cut over the axes it names, major axis
    first, as the JAX package lays a ``NamedSharding`` out."""
    for d, entry in enumerate(spec):
        for axis in _axes_of(entry):
            n = mesh.size(mesh.mesh_dim_names.index(axis))
            if n == 1:
                continue
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not split over "
                                 f"{axis}={n}")
            x = x.chunk(n, dim=d)[mesh.get_local_rank(axis)]
    return x


def _to_tensor(x):
    import torch

    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def shard_batch(mesh, batch, device=None):
    """This rank's block of a host batch (numpy arrays or tensors, nested
    in dicts, lists or tuples): dim 0 cut over dp×fsdp, on ``device``.

    Every rank passes the same global batch.  This is the port's device
    boundary for ``InputMode.SPARK`` data."""
    def one(x):
        t = local_block(_to_tensor(x), mesh, batch_pspec())
        return t if device is None else t.to(device, non_blocking=True)
    return _tree_map(one, batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class PartitionRules:
    """Ordered (regex, spec) rules mapping parameter names to specs.

    Names are ``state_dict`` names with ``/`` for ``.`` (the JAX package's
    path strings: ``layers/0/attn/query/weight``).  Example::

        rules = PartitionRules([
            (r".*emb.*", P("tp", None)),
            (r".*attn/(query|key|value)/weight", P("tp", "fsdp")),
            (r".*", P()),                      # default: replicate
        ])
        specs = rules.tree_specs(model.state_dict())
    """

    def __init__(self, rules: list[tuple[str, tuple]]):
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> P:
        for pat, spec in self.rules:
            if pat.fullmatch(path):
                return spec
        return P()

    def tree_specs(self, params: dict) -> dict:
        """``{name: spec}`` for a state dict (or any ``name -> tensor``
        dict, nested dicts joined by ``/``), each spec trimmed to its
        tensor's rank."""
        return {name: _clip_spec(self.spec_for(path), getattr(leaf, "ndim", 0))
                for name, path, leaf in _named_leaves(params)}

    def tree_shardings(self, mesh, params: dict) -> dict:
        """``{name: placements}`` over ``mesh``."""
        return {name: named_sharding(mesh, *spec)
                for name, spec in self.tree_specs(params).items()}


def gpt_partition_rules() -> PartitionRules:
    """Megatron tensor parallelism for the port's ``models.gpt.GPT``, the
    counterpart of the JAX ``GPT``'s partitioning annotations under
    ``flax_shardings``, written in ``nn.Linear``'s ``[out, in]`` layout:
    the tied table's vocab rows over ``tp``; ``query``, ``key``,
    ``value``, ``mlp_up`` and ``mlp_gate`` column-parallel (output units,
    dim 0); ``out`` and ``mlp_down`` row-parallel (input units, dim 1); the
    biases, norms and the position table replicated."""
    return PartitionRules([
        (r"tok_emb/weight", P("tp", None)),
        (r"layers/\d+/attn/(query|key|value)/weight", P("tp", None)),
        (r"layers/\d+/(mlp_up|mlp_gate)/weight", P("tp", None)),
        (r"layers/\d+/(attn/out|mlp_down)/weight", P(None, "tp")),
        (r".*", P()),
    ])


def _named_leaves(params: dict, prefix: str = ""):
    for k, v in params.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _named_leaves(v, name)
        else:
            yield name, name.replace(".", "/"), v


def _clip_spec(spec: P, ndim: int) -> P:
    """Trim a spec to a leaf's rank (scalars/1-D biases get fewer axes)."""
    return P(*tuple(spec)[:ndim])


def shard_params(mesh, params: dict, rules: PartitionRules | None = None) -> dict:
    """Place a ``name -> tensor`` dict on the mesh as DTensors according
    to ``rules`` (default: fully replicated — the MultiWorkerMirrored
    behavior).  Every rank passes the same tensors."""
    from torch.distributed.tensor import distribute_tensor

    rules = rules or PartitionRules([(r".*", P())])
    placements = rules.tree_shardings(mesh, params)
    return {name: distribute_tensor(_to_tensor(leaf), mesh, placements[name])
            for name, _, leaf in _named_leaves(params)}


def constrain(x, mesh, *spec):
    """``lax.with_sharding_constraint``: a DTensor is redistributed to
    ``spec``; a plain tensor, already one rank's block in eager PyTorch,
    is returned as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, named_sharding(mesh, *spec))
    return x
