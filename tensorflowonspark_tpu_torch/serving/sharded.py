"""Mesh-sharded serving replicas: gang-scheduled tensor-parallel model instances.

Port of ``tensorflowonspark_tpu/serving/sharded.py``.  A routable replica
is a **gang**: ``gang_size`` worker processes that boot, serve, fail and
retire as one schedulable unit, one endpoint to the router.

The JAX package's leader owns every device of the gang and GSPMD puts the
collectives into its compiled batcher; its members only answer a liveness
barrier.  A PyTorch process drives one device and eager PyTorch inserts no
collectives, so here every rank of the gang runs its own
``ContinuousBatcher`` over its Megatron shards of the model
(``models.gpt.TensorParallel``), in lockstep with the others: the JAX
package's multi-host posture, where "the barrier carries the step
descriptor they execute", on every host.

Gang anatomy (:func:`serve_sharded_replica`, the map_fun every gang process
runs; rank = ``executor_id % gang_size`` picks the role):

- **the gang's world.**  Each gang forms one ``torch.distributed`` world of
  its own (:func:`build_gang_mesh`): the rendezvous is the leader's
  ``host:coordinator_port`` from ``cluster_info``, ``world_size`` the gang
  size, ``rank`` the executor id less the leader's.  It is the gang's only
  transport and its timeout, ``serve_gang_step_timeout``, its only
  deadline.  One gang's death never touches another gang's store or group,
  and a healed gang forms a fresh world.  The ranks of a gang share their
  card over gloo; NCCL across cards waits for a host with two or more.
- **rank 0, the leader.**  Runs intake, continuous batching and
  ``on_token`` streaming exactly as ``serve_replica`` does (the loop is
  shared: :func:`~tensorflowonspark_tpu_torch.serving.replica.
  run_serve_loop`).  Before each step it broadcasts the step descriptor —
  every intake item it applied to its batcher since the last step, a
  ``gen`` request or an adopted session — over the world
  (:class:`GangBarrier`); after the step one all-gather brings every
  rank's token digest, and a digest that differs from the leader's raises
  :class:`GangShardLost` naming the rank.  An idle leader broadcasts an
  ``idle`` descriptor well inside the timeout.
- **ranks 1..gang_size-1, the members.**  Block in the broadcast, apply
  each descriptor in order (a step's items to their own batcher, the step
  — whose model calls meet the leader's in the collectives — and the
  digest gather; a ``clone``'s weight gather; a ``promote``'s shard load),
  and report the leader's step count through ``ctx.report_step(phase=
  "serving")``, so the driver's hang watchdog covers every shard and
  chaos plans get their deterministic ``at_step`` trigger on any shard.
  Between descriptors a member takes ``EndOfFeed`` and its own preemption
  from its queue without blocking on it.

The gang tiers compose as the JAX package's do:

- **disaggregated pools** (``serving/disagg.py``): a prefill gang's ranks
  export each session in lockstep and the leader gathers the members' K/V
  over the world (:func:`gather_sessions`), so the session it hands off is
  the unsharded session a single-process prefill replica exports; a decode
  gang's leader mirrors each ``adopt`` into the descriptor, and every rank
  verifies the whole session and seats its own heads on the same step;
- **warm standbys** (``serving/standby.py``): every rank of a standby gang
  builds, warms up in lockstep and unloads its shards; the promotion rides
  a ``promote`` descriptor and every rank loads its shard
  (``standby.promote_batcher``) — of the whole tree the leader cloned from a
  peer gang (which gathers its shards over its own world,
  :func:`gather_params`) or of its own build.

A hot swap (``model``) or a prefix donation (``prefix``) reaching a gang
leader raises, as the JAX package's tier refuses both: it is never applied
on the leader alone.  Gangs over ``pp`` or ``ep`` are refused
(:func:`check_servable`, ROADMAP A6 part 2, item 8c).

Failure semantics (the point of the gang):

- a member lost mid-service surfaces twice, independently: the driver's
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` classifies
  the process exit and the serving tier resolves any shard's death to the
  whole gang (``ReplicaScheduler`` keeps a member→leader map), marking the
  gang dead once and requeueing its in-flight requests to the survivors
  with the skip-dedup replay; meanwhile the leader's next broadcast,
  collective or gather fails and it raises :class:`GangShardLost`, a loud
  crash, never a half-width gang;
- a leader lost the same way fails its members' next broadcast (at once
  when its process is gone, else within the timeout): they exit non-zero,
  and the tier, resolving every shard to the gang, still counts it dead
  once;
- preemption (SIGTERM / chaos ``replace``) of any shard drains the gang
  leader under its grace window and the tier replaces the full gang.

``args`` contract adds to ``serve_replica``'s: ``serve_mesh`` (axis-name →
size dict; the port's gangs shard GPT over ``tp``), ``serve_gang_size``
(processes per gang: the mesh's device count, one process a device),
optional ``serve_shard_params`` (picklable ``(cfg, params, mesh) ->
params``, this rank's shards; a gang cut so is not cloned, its standbys
build), ``serve_gang_boot_timeout`` / ``serve_gang_step_timeout`` (the
world's rendezvous / every collective of the world, the step's included).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import queue as _queue
import time as _time
import zlib

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch.marker import EndOfFeed, Marker
from tensorflowonspark_tpu_torch.preemption import PreemptionGuard
from tensorflowonspark_tpu_torch.serving.replica import (arm_draft, on_device, run_serve_loop,
                                                         serving_batcher_kwargs,
                                                         serving_device)
from tensorflowonspark_tpu_torch.serving.scheduler import REQUEST_QUEUE

logger = logging.getLogger(__name__)


class GangShardLost(RuntimeError):
    """A gang member stopped answering the step barrier: the sharded
    replica can no longer run its mesh program at full width, so the
    leader crashes loudly and the driver fails the WHOLE gang over."""


@dataclasses.dataclass(frozen=True)
class GangSpec:
    """Shape of one sharded replica: the device-mesh axes its model
    shards over and the number of worker processes in its gang.

    ``axes`` uses the canonical mesh axis names (``parallel.mesh.AXES``)
    — e.g. ``{"tp": 2}`` for a 2-way tensor-parallel dense replica,
    ``{"pp": 2, "tp": 2}`` for a 4-device pipeline x tensor gang,
    ``{"ep": 4}`` for ep-routed MoE.  ``gang_size`` defaults to the mesh
    device count (one process per device slot); a multi-chip host can
    run fewer processes than devices (e.g. one 4-chip leader process and
    no members: ``gang_size=1``).
    """

    axes: dict
    gang_size: int | None = None

    def __post_init__(self):
        from tensorflowonspark_tpu_torch.parallel.mesh import AXES

        axes = dict(self.axes)
        unknown = set(axes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)} in gang "
                             f"spec; valid axes: {AXES}")
        for ax, s in axes.items():
            if not isinstance(s, int) or s < 1:
                raise ValueError(f"gang mesh axis '{ax}' has invalid size "
                                 f"{s!r} (want a positive int)")
        object.__setattr__(self, "axes", axes)
        size = self.gang_size if self.gang_size is not None else self.devices
        if int(size) < 1:
            raise ValueError(f"gang_size must be >= 1, got {size}")
        object.__setattr__(self, "gang_size", int(size))

    @property
    def devices(self) -> int:
        """Devices in one gang's mesh — the replica's capacity weight."""
        return math.prod(self.axes.values()) if self.axes else 1

    def describe(self) -> str:
        axes = ",".join(f"{a}={s}" for a, s in self.axes.items()
                        if s != 1) or "1 device"
        return f"mesh[{axes}] x {self.gang_size} proc(s)"

    @classmethod
    def from_args(cls, args) -> "GangSpec":
        return cls(axes=dict(args.get("serve_mesh") or {}),
                   gang_size=args.get("serve_gang_size"))


def gang_of(executor_id: int, gang_size: int) -> tuple[int, int]:
    """``(leader_eid, rank)`` for a worker in an aligned gang block —
    gangs are contiguous, gang_size-aligned executor-id ranges, computed
    identically by the driver's scheduler and every worker."""
    rank = int(executor_id) % int(gang_size)
    return int(executor_id) - rank, rank


def check_servable(spec: GangSpec) -> None:
    """Raise unless the port can serve ``spec``: GPT over ``tp`` with one
    process a device (the JAX package's leader may own several)."""
    other = {a: n for a, n in spec.axes.items() if a != "tp" and n > 1}
    if other:
        raise NotImplementedError(
            f"a sharded replica over mesh axes {other}: the port's gangs run GPT over "
            "tp only (ROADMAP A6 part 2, item 8c)")
    if spec.gang_size != spec.devices:
        raise ValueError(
            f"gang_size={spec.gang_size} for a mesh of {spec.devices} device(s): a port "
            "process drives one device, so a gang has one process a device")


def build_gang_mesh(spec: GangSpec, ctx, *, device_type: str = "cuda",
                    boot_timeout: float = 120.0, step_timeout: float = 30.0):
    """Join this worker to its gang's own ``torch.distributed`` world (gloo,
    rendezvous at the leader's ``host:coordinator_port``, the rendezvous
    bounded by ``boot_timeout``) and build the gang's
    :class:`~torch.distributed.device_mesh.DeviceMesh` over it.  Every
    collective of the world and of the mesh's ``tp`` group then times out
    after ``step_timeout``."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel.mesh import MeshSpec, axis_group, make_mesh

    check_servable(spec)
    leader_eid, rank = gang_of(ctx.executor_id, spec.gang_size)
    leader = next((n for n in ctx.cluster_info if int(n["executor_id"]) == leader_eid), None)
    if leader is None:
        raise RuntimeError(f"gang {leader_eid}: no reservation of its leader in cluster_info")
    dist.init_process_group("gloo", init_method=f"tcp://{leader['host']}:"
                                                f"{leader['coordinator_port']}",
                            world_size=spec.gang_size, rank=rank,
                            timeout=datetime.timedelta(seconds=boot_timeout))
    mesh = make_mesh(MeshSpec(**{"dp": 1, **spec.axes}), device_type=device_type)
    step = datetime.timedelta(seconds=step_timeout)
    for group in {dist.group.WORLD, axis_group(mesh, "tp")}:
        dist.distributed_c10d._set_pg_timeout(step, group)
    return mesh


def default_shard_params(cfg, params, mesh):
    """The dense-GPT parameter layout: this rank's Megatron shards over
    ``tp`` (``parallel.sharding.gpt_partition_rules``: attention heads,
    FFN units and vocab rows; the rest replicated), quantized leaves
    through ``ops.shard_quantized``.  Fails loudly when the mesh has a >1
    model axis but NOTHING ended up cut — a silently replicated "sharded"
    replica would burn ``devices x`` memory and serve tp=1 numbers."""
    from torch.distributed.tensor import Shard

    from tensorflowonspark_tpu_torch.ops.quant import shard_quantized
    from tensorflowonspark_tpu_torch.parallel.sharding import gpt_partition_rules

    shardings = gpt_partition_rules().tree_shardings(mesh, params)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    model_axes = {a: n for a, n in sizes.items() if n > 1 and a not in ("dp", "fsdp")}
    n_sharded = sum(any(isinstance(p, Shard) and mesh.size(m) > 1 for m, p in enumerate(pl))
                    for pl in shardings.values())
    if model_axes and n_sharded == 0:
        raise RuntimeError(
            f"sharded replica mesh has model axes {model_axes} but no "
            "parameter was sharded — this model carries no partitioning "
            "rules for them; pass serve_shard_params= with the "
            "model's own layout")
    logger.info("sharded replica params: %d/%d leaves sharded over %s",
                n_sharded, len(shardings), sizes)
    return shard_quantized(params, shardings, mesh)


def token_digest(deltas: dict) -> int:
    """A digest of one step's emitted tokens, in emission order (each
    request's list apart): equal batchers emit equal digests."""
    return zlib.crc32(repr([list(map(int, t)) for t in deltas.values()]).encode())


def _root(group) -> int:
    """The global rank of ``group``'s rank 0 (the gang's leader)."""
    import torch.distributed as dist

    return 0 if group is None else dist.get_global_rank(group, 0)


def broadcast_descriptor(desc, group=None):
    """The leader's step descriptor, sent from the group's rank 0 (``desc``
    on the leader, ignored elsewhere) and returned on every rank; a lost
    peer or a leader silent past the group's timeout raises."""
    import torch.distributed as dist

    obj = [desc]
    dist.broadcast_object_list(obj, src=_root(group), group=group)
    return obj[0]


def gather_digests(seq: int, digest: int, group=None) -> list[tuple[int, int]]:
    """Every rank's ``(step, token digest)``, in rank order: one all-gather
    of an int64 pair."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor([int(seq), int(digest)], dtype=torch.int64)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return [(int(a), int(b)) for a, b in (p.tolist() for p in parts)]


def gather_sessions(pairs: list, group=None) -> list | None:
    """A prefill gang's exported sessions, unsharded: every rank passes its
    batcher's ``take_sessions()`` (the same requests in the same order on
    every rank, each holding this rank's heads); the leader gathers the
    members' K/V and returns ``(request id, whole session)`` pairs — the
    wire format, struct and page hashes of a single-process prefill's
    session (``models.serving.merge_session_shards``) — and the members
    None.  No collective when the step exported nothing."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.models.serving import merge_session_shards

    if not pairs:
        return [] if dist.get_rank(group) == 0 else None
    mine = [s["kv"] for _, s in pairs]
    leader = dist.get_rank(group) == 0
    parts = [None] * dist.get_world_size(group) if leader else None
    dist.gather_object(mine, parts, dst=_root(group), group=group)
    if not leader:
        return None
    return [(rid, merge_session_shards(s, [p[j] for p in parts]))
            for j, (rid, s) in enumerate(pairs)]


def gather_params(params: dict, group=None) -> dict | None:
    """The whole state dict of a gang cut by :func:`default_shard_params`,
    as host arrays on the leader (None on the members): each rank's
    Megatron-cut leaves gathered to rank 0 in one collective and joined on
    their cut axis, the replicated leaves taken from the leader.  Plain
    leaves only (:meth:`GangBarrier.serve_clone` gathers no quantized
    tree)."""
    import numpy as np
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.models.serving import host_params
    from tensorflowonspark_tpu_torch.parallel.sharding import gpt_partition_rules

    cut = {}
    for name, spec in gpt_partition_rules().tree_specs(params).items():
        for dim, entry in enumerate(spec):
            if "tp" in (entry if isinstance(entry, tuple) else (entry,)):
                cut[name] = dim
    local = host_params(params)
    leader = dist.get_rank(group) == 0
    parts = [None] * dist.get_world_size(group) if leader else None
    dist.gather_object({n: local[n] for n in cut}, parts, dst=_root(group), group=group)
    if not leader:
        return None
    return {n: np.concatenate([p[n] for p in parts], axis=cut[n]) if n in cut else a
            for n, a in local.items()}


class GangBarrier:
    """Leader-side step protocol over the gang's own gloo world (the world
    :func:`build_gang_mesh` forms; ``group`` None) — its only transport
    and its only deadline (``step_timeout``, the world's collective
    timeout).

    Constructing it broadcasts the first descriptor (the boot handshake).
    :meth:`step` broadcasts the step descriptor — every intake item the
    leader applied since the last step (:meth:`mirror`: ``gen`` requests
    and adopted sessions) and the step's number — then runs the leader's
    batcher step, whose collectives meet the members'; :meth:`collect`
    all-gathers each rank's ``(step, token digest)`` and raises
    :class:`GangShardLost` naming the first rank that differs.
    :meth:`tick` broadcasts an ``idle`` descriptor when none went out for
    a quarter of the timeout, so an idle gang's members, blocked in the broadcast, never time out.  A
    failed broadcast, step or gather is a lost shard, and the world is
    then left as it is.  ``gatherable`` False: the gang's shards were cut
    by a caller's ``serve_shard_params``, whose layout :func:`gather_params`
    does not know, so a clone request gets no tree."""

    def __init__(self, group=None, *, step_timeout: float = 30.0,
                 gatherable: bool = True):
        self.group = group
        self.gatherable = gatherable
        self.step_timeout = float(step_timeout)
        self.idle_every = self.step_timeout / 4
        self._items: list[dict] = []
        self._broken = False
        reg = _metrics.get_registry()
        self._m_barriers = reg.counter(
            "tfos_gang_barriers_total",
            "Step barriers completed by this gang leader.")
        self._h_barrier = reg.histogram(
            "tfos_gang_barrier_seconds",
            "Descriptor-broadcast-to-digest-gather latency of one gang step.")
        self._h_clone = reg.histogram(
            "tfos_gang_clone_seconds",
            "Descriptor and weight gather of a clone this gang leader served, its steps\n"
            "waiting (the send runs beside them).")
        self._posted = self._sent = 0.0
        self._send({"event": "idle"})

    def _send(self, desc: dict) -> None:
        try:
            broadcast_descriptor(desc, self.group)
        except Exception as e:
            self._broken = True
            raise GangShardLost(f"gang descriptor {desc['event']!r} lost (a member gone, or "
                                f"none within the group's timeout): {e!r}") from e
        self._sent = _time.monotonic()

    def mirror(self, item: dict) -> None:
        """Queue an intake item the leader applied to its batcher (a ``gen``
        request, or an ``adopt`` whose whole session every rank verifies
        and cuts) for the next step descriptor."""
        if item.get("op") == "adopt":
            self._items.append({"op": "adopt", "session": item["session"]})
            return
        self._items.append({"op": "gen", **{k: item[k] for k in (
            "prompt", "max_new_tokens", "temperature", "top_p", "seed") if k in item}})

    def refuse(self, op: str) -> None:
        """An intake op the members cannot mirror: raise rather than apply
        it on the leader alone."""
        raise GangShardLost(
            f"intake op {op!r} reached a gang leader: a gang neither hot-swaps nor trades "
            "prefix pages (the JAX package's tier refuses both)")

    def tick(self) -> None:
        """Keep an idle gang's members inside their timeout."""
        if _time.monotonic() - self._sent >= self.idle_every:
            self._send({"event": "idle"})

    def step(self, batcher, steps: int) -> list:
        """Broadcast step ``steps``'s descriptor, then run the leader's
        batcher step (whose collectives meet the members')."""
        self._posted = _time.monotonic()
        desc = {"event": "step", "seq": steps, "items": self._items}
        self._items = []
        self._send(desc)
        try:
            return batcher.step()
        except Exception as e:
            self._broken = True
            raise GangShardLost(f"gang step {steps} failed on the leader (a peer lost, or "
                                f"no peer within the group's timeout): {e!r}") from e

    def sessions(self, pairs: list) -> list:
        """The step's exported sessions, unsharded (:func:`gather_sessions`)."""
        try:
            return gather_sessions(pairs, self.group)
        except Exception as e:
            self._broken = True
            raise GangShardLost(f"gang session gather failed: {e!r}") from e

    def collect(self, steps: int, load: int, deltas: dict) -> None:
        """Every rank's step number and token digest, held to the leader's
        own tokens of the step (``deltas``)."""
        want = token_digest(deltas)
        try:
            got = gather_digests(steps, want, self.group)
        except Exception as e:
            self._broken = True
            raise GangShardLost(f"gang digest gather of step {steps} failed: {e!r}") from e
        for rank, (seq, digest) in enumerate(got[1:], 1):
            if (seq, digest) != (steps, want):
                raise GangShardLost(
                    f"gang rank {rank} ended step {seq} with digest {digest}, the leader's "
                    f"step {steps} emitted {want}: the shards' batchers diverged")
        self._m_barriers.inc()
        self._h_barrier.record(_time.monotonic() - self._posted)

    def serve_clone(self, batcher, item: dict, ctx) -> None:
        """A promoted standby asks this gang for its weights: every rank
        joins :func:`gather_params` (a ``clone`` descriptor first), and the
        leader ships the whole tree to the requester as a single replica
        would (``replica.serve_clone_request``); ``params`` None when the
        gang's tree cannot be gathered, and the standby builds instead."""
        from tensorflowonspark_tpu_torch.ops.quant import _QuantArray
        from tensorflowonspark_tpu_torch.serving.replica import serve_clone_request

        t0 = _time.monotonic()
        gather = self.gatherable and not any(isinstance(v, _QuantArray)
                                        for v in batcher.params.values())
        self._send({"event": "clone", "gather": gather})
        whole = None
        if gather:
            try:
                whole = gather_params(batcher.params, self.group)
            except Exception as e:
                self._broken = True
                raise GangShardLost(f"gang weight gather failed: {e!r}") from e
        serve_clone_request(batcher, item, ctx, params=whole, prefix=False)
        self._h_clone.record(_time.monotonic() - t0)

    def promote(self, desc: dict) -> None:
        """Broadcast a standby gang's promotion: every rank loads its shard
        of ``desc["params"]`` (a cloned whole tree) or builds its own
        (``standby.promote_batcher``)."""
        self._send({"event": "promote", **desc})

    def stop(self) -> None:
        """Broadcast ``stop`` on a clean exit (the members leave their
        loop); after a lost shard the world is left as it is, and the
        members' next collective fails instead."""
        if not self._broken:
            with contextlib.suppress(Exception):
                broadcast_descriptor({"event": "stop"}, self.group)


def _gang_batcher(args, ctx, spec: GangSpec):
    """This rank's world, mesh, shards and batcher (every rank builds the
    same, so the boots meet in the same collectives): ``(batcher,
    shard)``, ``shard(cfg, params)`` cutting a whole state dict into this
    rank's shards on its device."""
    from tensorflowonspark_tpu_torch.models.gpt import TensorParallel
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.parallel.mesh import axis_group

    device = serving_device(args)
    mesh = build_gang_mesh(spec, ctx, device_type=device.type,
                           boot_timeout=float(args.get("serve_gang_boot_timeout", 120.0)),
                           step_timeout=float(args.get("serve_gang_step_timeout", 30.0)))
    shard_fn = args.get("serve_shard_params") or default_shard_params

    def shard(cfg, params):
        return on_device(shard_fn(cfg, params, mesh), device)

    cfg, params = args["serve_model_builder"](args)
    batcher = ContinuousBatcher(
        cfg, shard(cfg, params),
        max_batch=int(args.get("serve_max_batch", 4)),
        eos_id=args.get("serve_eos_id"),
        tp=TensorParallel(axis_group(mesh, "tp")),
        **serving_batcher_kwargs(args))
    del params
    # the draft proposes over its own tp shards in the same group
    arm_draft(batcher, args, shard=lambda c, p: shard_fn(c, p, mesh))
    return batcher, shard


def gang_barrier(args) -> GangBarrier:
    """The leader's step protocol over its gang's world, from ``args``."""
    return GangBarrier(step_timeout=float(args.get("serve_gang_step_timeout", 30.0)),
                       gatherable=args.get("serve_shard_params") is None)


def serve_sharded_replica(args, ctx) -> None:
    """The gang map_fun: rank 0 leads (intake, the serve loop, the step
    descriptors), the other ranks step their own shard in lockstep (module
    docstring)."""
    import torch.distributed as dist

    spec = GangSpec.from_args(args)
    leader_eid, rank = gang_of(ctx.executor_id, spec.gang_size)
    if ctx.mgr is None:
        raise RuntimeError("the serving loop needs the node queue server "
                           "(InputMode.SPARK)")
    if args.get("serve_aot_cache"):
        raise ValueError("a sharded replica runs eagerly: its gloo collectives cannot be "
                         "captured in a CUDA graph (drop aot_cache)")
    try:
        batcher, shard = _gang_batcher(args, ctx, spec)
        if rank != 0:
            _member_loop(args, ctx, leader_eid, rank, batcher, shard=shard)
            return
        reg = _metrics.get_registry()
        reg.gauge("tfos_gang_shards_count",
                  "Processes in this sharded replica's gang.").set(spec.gang_size)
        reg.gauge("tfos_gang_devices_count",
                  "Devices in this sharded replica's mesh.").set(spec.devices)
        logger.info("gang %d leader (%s): serving over tp %d", leader_eid,
                    spec.describe(), batcher.tp.size)
        barrier = gang_barrier(args)
        try:
            run_serve_loop(args, ctx, batcher, gang=barrier,
                           label=f"gang-{leader_eid} leader", role=args.get("serve_role"))
        finally:
            # clean exit: the members leave their loop; a lost shard
            # leaves the world broken, and their next collective fails
            barrier.stop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _drain_control(mgr, ctx, guard, state: dict) -> None:
    """A member between descriptors: take ``EndOfFeed`` (the tier stopping
    or reaping the gang) and its own preemption without blocking on its
    queue; the member still follows the leader until ``stop``."""
    while True:
        try:
            item = mgr.queue_get(REQUEST_QUEUE, timeout=0)
        except (_queue.Empty, TimeoutError):
            break
        if isinstance(item, EndOfFeed):
            state["stopping"] = True
        elif not isinstance(item, Marker):
            logger.warning("gang member %d: ignoring unexpected item %r",
                           ctx.executor_id, type(item))
    if guard.preempted and not state["announced"]:
        # an idle member's reclaim still has to reach the driver: flip
        # the phase so the tier drains and replaces the gang (steps stay
        # at the leader's)
        state["announced"] = True
        ctx.report_step(max(1, _last_step(ctx)), phase="preempted")


def _member_loop(args, ctx, leader_eid: int, rank: int, batcher, *, group=None,
                 shard=None) -> None:
    """Shard member: take each descriptor the leader broadcasts — a step's
    items applied to this rank's batcher in order, the step, its session
    and digest gathers; a clone's weight gather; a promotion's shard load
    (``shard``: ``(cfg, params) -> this rank's shards``) — and mirror the
    leader's step count into this process's heartbeat, until the leader's
    ``stop``.  A broadcast or collective that fails (the leader lost, or
    silent past the group's timeout) raises :class:`GangShardLost`, unless
    the tier already sent this member ``EndOfFeed``."""
    from tensorflowonspark_tpu_torch.serving import standby as _standby

    mgr = ctx.mgr
    reg = _metrics.get_registry()
    m_acks = reg.counter("tfos_gang_member_acks_total",
                         "Step barriers acked by this gang member.")
    deltas: dict[int, list[int]] = {}

    def on_token(brid: int, tok: int) -> None:
        deltas.setdefault(brid, []).append(int(tok))

    logger.info("gang %d member rank %d (executor %d) up", leader_eid,
                rank, ctx.executor_id)
    guard = PreemptionGuard()
    state = {"stopping": False, "announced": False}
    where = f"gang {leader_eid} member rank {rank}"
    with guard:
        while True:
            try:
                desc = broadcast_descriptor(None, group)
            except Exception as e:
                if state["stopping"]:
                    break
                raise GangShardLost(f"{where}: no descriptor (the leader lost, or silent "
                                    f"past the group's timeout): {e!r}") from e
            event = desc["event"]
            if event == "stop":
                break
            if event == "step":
                steps = int(desc["seq"])
                for it in desc["items"]:
                    if it["op"] == "adopt":
                        batcher.adopt_session(it["session"], on_token=on_token)
                        continue
                    batcher.submit(it["prompt"], int(it["max_new_tokens"]),
                                   temperature=float(it.get("temperature", 0.0)),
                                   top_p=float(it.get("top_p", 1.0)),
                                   seed=int(it.get("seed", 0)), on_token=on_token)
                try:
                    done = batcher.step()
                    for brid in done:
                        batcher.result(brid, pop=True)
                    if batcher.prefill_only:
                        gather_sessions(batcher.take_sessions(), group)
                    gather_digests(steps, token_digest(deltas), group)
                except Exception as e:
                    raise GangShardLost(
                        f"{where}: step {steps} failed (the leader lost, or no peer within "
                        f"the group's timeout): {e!r}") from e
                deltas.clear()
                m_acks.inc()
                _set_last_step(ctx, steps)
                if guard.preempted:
                    state["announced"] = True
                # after the gathers: a chaos kill inside report_step lands
                # between steps, not while the leader waits
                ctx.report_step(steps, phase="preempted" if guard.preempted else "serving")
            elif event == "clone":
                if desc["gather"]:
                    gather_params(batcher.params, group)
            elif event == "promote":
                _standby.promote_batcher(batcher, args, desc, desc.get("params"), shard=shard,
                                         who=where)
                logger.info("%s promoted (%s)", where,
                            "cloned" if desc.get("params") is not None else "built")
            _drain_control(mgr, ctx, guard, state)
    logger.info("gang %d member rank %d stopped%s", leader_eid, rank,
                " (preempted)" if guard.preempted else "")


def _set_last_step(ctx, steps: int) -> None:
    ctx._gang_last_step = int(steps)


def _last_step(ctx) -> int:
    return int(getattr(ctx, "_gang_last_step", 0))
