"""Device meshes with the framework's canonical named axes.

Port of ``tensorflowonspark_tpu/parallel/mesh.py``.  The JAX package
builds a ``jax.sharding.Mesh`` over devices; the port builds a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group (one process a card), with the same six axes in the same
order, ``AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")``, outermost to
innermost: consecutive ranks differ first in ``tp``, then ``sp``, as
neighbouring devices do in the JAX mesh.  Every axis exists, size 1 when
unused, so ``mesh["sp"]`` and ``mesh.get_group("tp")`` always work.

:class:`MeshSpec` and its :meth:`~MeshSpec.resolve` are the JAX
package's, errors included.  Every rank of the group must build the same
mesh at the same point: building one creates its axes' process groups,
a collective over the whole group.
"""

from __future__ import annotations

import dataclasses
import math
import socket

import numpy as np

# Canonical axis order, outermost → innermost.
AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass
class MeshSpec:
    """Sizes for each named axis; ``-1`` on one axis means "infer from the
    device count" (like a reshape free dimension)."""

    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = list(self.sizes())
        for ax, s in zip(AXES, sizes):
            # catch bad sizes HERE, by name: a 0 would otherwise surface
            # as an opaque modulo-by-zero / reshape error downstream
            if s != -1 and (not isinstance(s, int) or s < 1):
                raise ValueError(
                    f"mesh axis '{ax}' has invalid size {s!r} "
                    f"(want a positive int, or -1 to infer it from the "
                    f"device count)")
        free = [i for i, s in enumerate(sizes) if s == -1]
        if len(free) > 1:
            raise ValueError(
                f"at most one mesh axis may be -1 (inferred); got "
                f"{', '.join(repr(AXES[i]) for i in free)}")
        named = {ax: s for ax, s in zip(AXES, sizes) if s not in (1, -1)}
        fixed = math.prod(s for s in sizes if s != -1)
        if free:
            if n_devices % fixed:
                raise ValueError(
                    f"cannot infer mesh axis '{AXES[free[0]]}': fixed axes "
                    f"{named or '{}'} (product {fixed}) do not divide "
                    f"{n_devices} devices")
            sizes[free[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {named or dict(zip(AXES, sizes))} require "
                f"{fixed} devices, have {n_devices}")
        return MeshSpec(**dict(zip(AXES, sizes)))


def _ranks(devices) -> np.ndarray:
    """The ranks a mesh spans: ``devices`` (global ranks) or the whole
    default group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a torch.distributed process group: call "
            "ctx.initialize_distributed() (or init_process_group) first")
    if devices is None:
        devices = range(dist.get_world_size())
    return np.asarray(list(devices), dtype=np.int64)


def _device_mesh(device_type: str, grid: np.ndarray):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and torch.cuda.is_available():
        # several ranks may share one card (a gloo group on one H100): keep
        # the device the caller set rather than DeviceMesh's rank % count
        torch.cuda.set_device(torch.cuda.current_device())
    return DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=AXES)


def make_mesh(spec: MeshSpec | None = None, devices=None, device_type: str = "cuda",
              **axis_sizes):
    """Build a :class:`~torch.distributed.device_mesh.DeviceMesh` over
    ``devices`` (global ranks; default: every rank of the default group).

    Either pass a :class:`MeshSpec` or axis sizes as kwargs::

        mesh = make_mesh(dp=2, tp=4)           # 8 ranks
        mesh = make_mesh(dp=-1, sp=2)          # dp inferred

    All six canonical axes always exist (size 1 when unused).
    ``device_type`` is where the ranks' tensors live (``"cpu"`` for a gloo
    group on the CPU).
    """
    if spec is None:
        unknown = set(axis_sizes) - set(AXES)
        if unknown:
            raise ValueError(
                f"unknown mesh axes {sorted(unknown)}; valid axes: {AXES}")
        spec = MeshSpec(**{**{"dp": -1}, **axis_sizes})
    ranks = _ranks(devices)
    spec = spec.resolve(ranks.size)
    return _device_mesh(device_type, ranks.reshape(spec.sizes()))


def mesh_from_num_ps(num_ps: int, devices=None, device_type: str = "cuda", **axis_sizes):
    """Reference-parity helper: interpret ``TFCluster.run(num_ps=N)`` as an
    ``ep`` axis of size N (sharded embedding tables replace parameter
    servers)."""
    return make_mesh(ep=max(1, num_ps), devices=devices, device_type=device_type,
                     **axis_sizes)


def _host_of_every_rank(ranks: np.ndarray) -> dict[int, str]:
    """Each rank's host name, gathered from every rank of the default group."""
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return {int(r): names[int(r)] for r in ranks}


def make_hybrid_mesh(ici: MeshSpec | dict | None = None, dcn: dict | None = None,
                     devices=None, slice_key=None, device_type: str = "cuda"):
    """Build a mesh over several hosts: ``ici`` axes inside each host (the
    card-to-card links of one machine), ``dcn`` axes across hosts.

    Each canonical axis gets size ``dcn_k * ici_k``, laid out DCN-major:
    moving one step along the axis stays inside a host until the host's
    extent is exhausted, then crosses hosts.  Keep high-traffic axes
    (``tp``/``sp``/``fsdp``) inside a host and put only the low-traffic
    axes (``dp``, ``pp``) in ``dcn``.

        # 2 hosts x 8 cards: dp across hosts, fsdp*tp inside each
        mesh = make_hybrid_mesh(ici=dict(fsdp=4, tp=2), dcn=dict(dp=2))

    A slice is a host here (the JAX package groups by ``slice_index`` or
    ``process_index``): ranks group by host name, gathered from every rank
    (a collective).  ``slice_key`` (``rank -> group id``) overrides, for
    tests on one host.  Every slice must hold the same number of ranks;
    the ``dcn`` axis product must equal the slice count.
    """
    ranks = _ranks(devices)
    if slice_key is None:
        hosts = _host_of_every_rank(ranks)

        def slice_key(r):  # noqa: ANN001
            return hosts[int(r)]
    groups: dict = {}
    for r in ranks:
        groups.setdefault(slice_key(int(r)), []).append(int(r))
    per_slice = [sorted(groups[s]) for s in sorted(groups)]
    sizes = {len(g) for g in per_slice}
    if len(sizes) != 1:
        raise ValueError(
            f"uneven slices: {dict((s, len(g)) for s, g in groups.items())}")
    n_slices, n_per = len(per_slice), sizes.pop()

    dcn = dict(dcn or {})
    unknown = set(dcn) - set(AXES)
    if unknown:
        raise ValueError(f"unknown dcn axes {sorted(unknown)}; valid: {AXES}")
    try:
        dcn_spec = MeshSpec(**{**{"dp": 1}, **dcn}).resolve(n_slices)
    except ValueError as e:
        raise ValueError(
            f"dcn axis product must equal the slice count ({n_slices} "
            f"slices of {n_per} devices): {e}") from None
    if isinstance(ici, dict):
        ici = MeshSpec(**{**{"dp": -1}, **ici})
    ici_spec = (ici or MeshSpec()).resolve(n_per)

    # [n_slices, n_per] -> dcn sizes + ici sizes -> interleave (dcn_k, ici_k)
    # per canonical axis -> merge each pair into one axis of dcn_k * ici_k
    arr = np.asarray(per_slice, dtype=np.int64)
    arr = arr.reshape(dcn_spec.sizes() + ici_spec.sizes())
    order = [ax for k in range(len(AXES)) for ax in (k, len(AXES) + k)]
    arr = arr.transpose(order).reshape(
        tuple(d * i for d, i in zip(dcn_spec.sizes(), ici_spec.sizes())))
    return _device_mesh(device_type, arr)


def local_mesh_devices(mesh) -> list[int]:
    """This process's ranks within the mesh: one process drives one card,
    so this is ``[rank]`` for a member and ``[]`` otherwise."""
    import torch.distributed as dist

    rank = dist.get_rank()
    return [rank] if rank in mesh.mesh.flatten().tolist() else []


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis`` that holds this rank.

    Raises ``NameError`` naming the axis when the mesh has no such axis
    (the JAX package's unbound-axis error inside ``shard_map``)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise NameError(f"unbound axis name: {axis!r} is not an axis of the mesh {names}")
    return mesh.get_group(axis)


#: :func:`group_over`'s groups: the default group they were made in, and
#: this rank's group keyed by the partition of the ranks into groups
_GROUPS: dict = {"world": None, "by_blocks": {}}


def group_over(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that differ from this rank only in
    ``axes`` (the flattened sub-mesh over them).  Every rank of the mesh
    must call this with the same ``axes``: each such group is created on
    every rank, as ``torch.distributed.new_group`` requires, once for the
    life of the default group (a second call over the same ranks returns
    the same group)."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    grid = mesh.mesh.numpy() if hasattr(mesh.mesh, "numpy") else np.asarray(mesh.mesh)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(grid.ndim) if i not in keep]
    blocks = tuple(tuple(sorted(int(r) for r in block)) for block in
                   grid.transpose(rest + keep).reshape(-1, math.prod(grid.shape[i] for i in keep)))
    if _GROUPS["world"] is not dist.group.WORLD:     # a new default group
        _GROUPS.update(world=dist.group.WORLD, by_blocks={})
    if blocks not in _GROUPS["by_blocks"]:
        me, mine = dist.get_rank(), None
        for ranks in blocks:
            group = dist.new_group(list(ranks))
            if me in ranks:
                mine = group
        _GROUPS["by_blocks"][blocks] = mine
    return _GROUPS["by_blocks"][blocks]
