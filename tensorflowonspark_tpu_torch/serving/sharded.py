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
  size, ``rank`` the executor id less the leader's.  One gang's death never
  touches another gang's store or group, and a healed gang forms a fresh
  world.  The ranks of a gang share their card over gloo; NCCL across
  cards waits for a host with two or more of them.
- **rank 0, the leader.**  Runs intake, continuous batching and
  ``on_token`` streaming exactly as ``serve_replica`` does (the loop is
  shared: :func:`~tensorflowonspark_tpu_torch.serving.replica.
  run_serve_loop`).  Before each step it posts the step descriptor — every
  intake item it applied to its batcher since the last step — to each
  member (:class:`GangBarrier`); after the step it collects each member's
  ack, which carries a digest of the tokens the member emitted.  A digest
  that differs from the leader's raises :class:`GangShardLost`.
- **ranks 1..gang_size-1, the members.**  Apply the descriptor's items to
  their own batcher in the same order, step (the model calls meet the
  leader's in the collectives), ack with the digest, and report the
  leader's step count through ``ctx.report_step(phase="serving")``, so the
  driver's hang watchdog covers every shard and chaos plans get their
  deterministic ``at_step`` trigger on any shard.

Only ``gen`` requests are mirrored.  The JAX package's tier refuses a hot
swap and a prefix donation to a gang, and a gang here runs with neither
warm standbys nor disaggregated pools (``ServingCluster.run`` refuses
both, ROADMAP A6 part 2, item 8), so a ``clone``, ``model``, ``prefix``
or ``adopt`` item reaching a gang leader raises: it is never applied on
the leader alone.

Failure semantics (the point of the gang):

- a member lost mid-service surfaces twice, independently: the driver's
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` classifies
  the process exit and the serving tier resolves any shard's death to the
  whole gang (``ReplicaScheduler`` keeps a member→leader map), marking the
  gang dead once and requeueing its in-flight requests to the survivors
  with the skip-dedup replay; meanwhile the leader's next descriptor post,
  collective or ack fails and it raises :class:`GangShardLost`, a loud
  crash, never a half-width gang.  A collective that fails because a peer
  died, or that a peer never joins, raises within the group's timeout,
  ``serve_gang_step_timeout``;
- a leader lost the same way leaves members idling on their queue (or
  failing their next collective); the tier reaps them with a per-member
  ``EndOfFeed``;
- preemption (SIGTERM / chaos ``replace``) of any shard drains the gang
  leader under its grace window and the tier replaces the full gang.

``args`` contract adds to ``serve_replica``'s: ``serve_mesh`` (axis-name →
size dict; the port's gangs shard GPT over ``tp``), ``serve_gang_size``
(processes per gang: the mesh's device count, one process a device),
optional ``serve_shard_params`` (picklable ``(cfg, params, mesh) ->
params``, this rank's shards), ``serve_gang_boot_timeout`` /
``serve_gang_step_timeout`` (member hello and world rendezvous / per-step
deadline, the gang's collectives included).
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
from tensorflowonspark_tpu_torch.queues import QueueClient
from tensorflowonspark_tpu_torch.serving.replica import (arm_draft, on_device, run_serve_loop,
                                                         serving_batcher_kwargs,
                                                         serving_device)
from tensorflowonspark_tpu_torch.serving.scheduler import (REQUEST_QUEUE,
                                                           RESPONSE_QUEUE)

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
            "tp only (ROADMAP A6 part 2, item 8)")
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


class GangBarrier:
    """Leader-side step protocol over the members' node queue plane.

    One short-timeout :class:`QueueClient` per member (``shm=False`` —
    control messages must not consume zero-copy ring slots).  ``hello``
    collects each member's boot ``ready`` ack; :meth:`step` posts the step
    descriptor (the intake items :meth:`mirror` queued) to every member and
    runs the leader's own batcher step; :meth:`collect` gathers the acks
    and holds each member's token digest to the leader's, raising
    :class:`GangShardLost` naming the first shard that failed or differed.
    """

    def __init__(self, member_infos: list[dict], *,
                 boot_timeout: float = 120.0, step_timeout: float = 30.0):
        self._members = list(member_infos)
        self._clients: dict[int, QueueClient] = {}
        self._items: list[dict] = []
        self.boot_timeout = float(boot_timeout)
        self.step_timeout = float(step_timeout)
        reg = _metrics.get_registry()
        self._m_barriers = reg.counter(
            "tfos_gang_barriers_total",
            "Step barriers completed by this gang leader.")
        self._h_barrier = reg.histogram(
            "tfos_gang_barrier_seconds",
            "Post-to-last-ack latency of one gang step barrier.")
        self._posted = 0.0

    def _client(self, info: dict) -> QueueClient:
        eid = int(info["executor_id"])
        if eid not in self._clients:
            self._clients[eid] = QueueClient(info["addr"], info["authkey"],
                                             timeout=30.0, shm=False)
        return self._clients[eid]

    def _ack(self, info: dict, event: str, timeout: float) -> dict:
        eid = int(info["executor_id"])
        deadline = _time.monotonic() + timeout
        booting = event == "ready"
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise GangShardLost(
                    f"gang shard {eid} did not ack '{event}' within "
                    f"{timeout:.0f}s")
            try:
                msg = self._client(info).get(RESPONSE_QUEUE,
                                             timeout=min(remaining, 5.0))
            except TimeoutError:
                continue
            except ConnectionRefusedError as e:
                # the boot hello may race a member whose queue server is
                # still binding; a refused connect mid-SERVICE is a dead
                # shard
                if not booting:
                    raise GangShardLost(
                        f"gang shard {eid} lost ({event}): {e!r}") from e
                with contextlib.suppress(Exception):
                    self._clients.pop(eid).close()
                _time.sleep(0.2)
                continue
            except Exception as e:
                raise GangShardLost(
                    f"gang shard {eid} lost ({event}): {e!r}") from e
            if isinstance(msg, dict) and msg.get("op") == "gang" \
                    and msg.get("event") == event:
                return msg

    def hello(self) -> None:
        """Collect every member's boot ack — fail fast on a sick gang
        before the leader advertises itself as routable."""
        for info in self._members:
            self._ack(info, "ready", self.boot_timeout)
        logger.info("gang barrier up: %d member(s) ready",
                    len(self._members))

    def mirror(self, item: dict) -> None:
        """Queue an intake item the leader applied to its batcher (a
        ``gen`` request) for the next step descriptor."""
        self._items.append({k: item[k] for k in ("prompt", "max_new_tokens", "temperature",
                                                 "top_p", "seed") if k in item})

    def refuse(self, op: str) -> None:
        """An intake op the members cannot mirror: raise rather than apply
        it on the leader alone."""
        raise GangShardLost(
            f"intake op {op!r} reached a gang leader: a gang mirrors only gen requests "
            "onto its members (ROADMAP A6 part 2, item 8)")

    def step(self, batcher, steps: int) -> list:
        """Post step ``steps``'s descriptor to every member, then run the
        leader's batcher step (whose collectives meet the members'); a
        failed post or step is a lost shard."""
        self._posted = _time.monotonic()
        desc = {"op": "gang", "event": "step", "seq": steps, "items": self._items}
        self._items = []
        for info in self._members:
            eid = int(info["executor_id"])
            try:
                self._client(info).put(REQUEST_QUEUE, desc, timeout=10)
            except Exception as e:
                raise GangShardLost(
                    f"gang shard {eid} lost (descriptor post at step "
                    f"{steps}): {e!r}") from e
        try:
            return batcher.step()
        except Exception as e:
            raise GangShardLost(f"gang step {steps} failed on the leader (a peer lost, or "
                                f"no peer within the group's timeout): {e!r}") from e

    def collect(self, steps: int, load: int, deltas: dict) -> None:
        """Every member's ack of step ``steps``, each digest held to the
        leader's own tokens of the step (``deltas``)."""
        want = token_digest(deltas)
        for info in self._members:
            msg = self._ack(info, "ack", self.step_timeout)
            if msg.get("seq") != steps or msg.get("digest") != want:
                raise GangShardLost(
                    f"gang shard {info['executor_id']} acked step {msg.get('seq')} with "
                    f"digest {msg.get('digest')}, the leader's step {steps} emitted "
                    f"{want}: the shards' batchers diverged")
        self._m_barriers.inc()
        self._h_barrier.record(_time.monotonic() - self._posted)

    def stop(self) -> None:
        """Best-effort gang stop + client close (leader exit, clean or
        crashing): surviving members stop idling on their queue without
        waiting for the driver's reap."""
        for info in self._members:
            with contextlib.suppress(Exception):
                self._client(info).put(
                    REQUEST_QUEUE, {"op": "gang", "event": "stop"},
                    timeout=2)
        for cli in self._clients.values():
            with contextlib.suppress(Exception):
                cli.close()
        self._clients.clear()


def _gang_batcher(args, ctx, spec: GangSpec):
    """This rank's world, mesh, shards and batcher (every rank builds the
    same, so the boots meet in the same collectives)."""
    from tensorflowonspark_tpu_torch.models.gpt import TensorParallel
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.parallel.mesh import axis_group

    device = serving_device(args)
    mesh = build_gang_mesh(spec, ctx, device_type=device.type,
                           boot_timeout=float(args.get("serve_gang_boot_timeout", 120.0)),
                           step_timeout=float(args.get("serve_gang_step_timeout", 30.0)))
    shard_fn = args.get("serve_shard_params") or default_shard_params
    cfg, params = args["serve_model_builder"](args)
    batcher = ContinuousBatcher(
        cfg, on_device(shard_fn(cfg, params, mesh), device),
        max_batch=int(args.get("serve_max_batch", 4)),
        eos_id=args.get("serve_eos_id"),
        tp=TensorParallel(axis_group(mesh, "tp")),
        **serving_batcher_kwargs(args))
    del params
    # the draft proposes over its own tp shards in the same group
    arm_draft(batcher, args, shard=lambda c, p: shard_fn(c, p, mesh))
    return batcher


def serve_sharded_replica(args, ctx) -> None:
    """The gang map_fun: rank 0 leads (intake + serve loop + descriptor
    posts), the other ranks step their own shard in lockstep (module
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
        batcher = _gang_batcher(args, ctx, spec)
        if rank != 0:
            _member_loop(args, ctx, leader_eid, rank, batcher)
            return
        members = sorted(
            (n for n in ctx.cluster_info
             if leader_eid < n["executor_id"] < leader_eid + spec.gang_size),
            key=lambda n: n["executor_id"])
        if len(members) != spec.gang_size - 1:
            raise RuntimeError(
                f"gang {leader_eid} expected {spec.gang_size - 1} member "
                f"reservation(s), found {len(members)} — cluster size must be "
                f"a multiple of gang_size={spec.gang_size}")
        reg = _metrics.get_registry()
        reg.gauge("tfos_gang_shards_count",
                  "Processes in this sharded replica's gang.").set(spec.gang_size)
        reg.gauge("tfos_gang_devices_count",
                  "Devices in this sharded replica's mesh.").set(spec.devices)
        logger.info("gang %d leader (%s): serving over tp %d", leader_eid,
                    spec.describe(), batcher.tp.size)
        barrier = GangBarrier(
            members,
            boot_timeout=float(args.get("serve_gang_boot_timeout", 120.0)),
            step_timeout=float(args.get("serve_gang_step_timeout", 30.0)))
        try:
            barrier.hello()
            run_serve_loop(args, ctx, batcher, gang=barrier,
                           label=f"gang-{leader_eid} leader",
                           role=args.get("serve_role"))
        finally:
            # clean exit or GangShardLost alike: tell surviving members
            # to stop idling on their queue
            barrier.stop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _member_loop(args, ctx, leader_eid: int, rank: int, batcher) -> None:
    """Shard member: apply each step descriptor's items to this rank's
    batcher, step it, ack with the digest of its tokens, mirror the
    leader's step count into this process's heartbeat, exit on gang stop /
    ``EndOfFeed``."""
    mgr = ctx.mgr
    reg = _metrics.get_registry()
    m_acks = reg.counter("tfos_gang_member_acks_total",
                         "Step barriers acked by this gang member.")
    deltas: dict[int, list[int]] = {}

    def on_token(brid: int, tok: int) -> None:
        deltas.setdefault(brid, []).append(int(tok))

    logger.info("gang %d member rank %d (executor %d) up", leader_eid,
                rank, ctx.executor_id)
    mgr.queue_put(RESPONSE_QUEUE,
                  {"op": "gang", "event": "ready", "rank": rank,
                   "eid": ctx.executor_id})
    guard = PreemptionGuard()
    announced = False
    with guard:
        while True:
            try:
                item = mgr.queue_get(REQUEST_QUEUE, timeout=0.5)
            except (_queue.Empty, TimeoutError):
                if guard.preempted and not announced:
                    # an idle member's reclaim still has to reach the
                    # driver: flip the phase so the tier drains and
                    # replaces the gang (steps stay at the leader's)
                    announced = True
                    ctx.report_step(max(1, _last_step(ctx)),
                                    phase="preempted")
                continue
            if isinstance(item, EndOfFeed):
                break
            if isinstance(item, dict) and item.get("op") == "gang":
                event = item.get("event")
                if event == "stop":
                    break
                if event == "step":
                    steps = int(item["seq"])
                    for it in item["items"]:
                        batcher.submit(it["prompt"], int(it["max_new_tokens"]),
                                       temperature=float(it.get("temperature", 0.0)),
                                       top_p=float(it.get("top_p", 1.0)),
                                       seed=int(it.get("seed", 0)), on_token=on_token)
                    try:
                        done = batcher.step()
                    except Exception as e:
                        raise GangShardLost(
                            f"gang {leader_eid} member rank {rank}: step {steps} failed (the "
                            f"leader lost, or no peer within the group's timeout): "
                            f"{e!r}") from e
                    for brid in done:
                        batcher.result(brid, pop=True)
                    digest = token_digest(deltas)
                    deltas.clear()
                    # ack FIRST: a chaos kill inside report_step must
                    # land between steps, not while the leader waits
                    mgr.queue_put(RESPONSE_QUEUE,
                                  {"op": "gang", "event": "ack", "seq": steps,
                                   "rank": rank, "digest": digest})
                    m_acks.inc()
                    _set_last_step(ctx, steps)
                    if guard.preempted:
                        announced = True
                    ctx.report_step(
                        steps,
                        phase="preempted" if guard.preempted else "serving")
                continue
            if isinstance(item, Marker):
                continue
            logger.warning("gang member %d: ignoring unexpected item %r",
                           ctx.executor_id, type(item))
    logger.info("gang %d member rank %d stopped%s", leader_eid, rank,
                " (preempted)" if guard.preempted else "")


def _set_last_step(ctx, steps: int) -> None:
    ctx._gang_last_step = int(steps)


def _last_step(ctx) -> int:
    return int(getattr(ctx, "_gang_last_step", 0))
