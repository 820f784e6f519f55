"""Warm standbys: pre-warmed spare replicas that close the heal window.

Port of ``tensorflowonspark_tpu/serving/standby.py``.  What a standby
pre-pays here is the card's start, the weights' first load and, with the
tier's capture cache armed (``aot_cache``), the CUDA-graph capture of
every serve-step site the warm-up sweep reaches; a promotion then copies
the cloned weights INTO the storage those graphs were captured over
(``ContinuousBatcher.load_params``).  A promotion may carry a pool role
(a disaggregated tier's standbys are built role-less and specialize on
arrival) or a model version (one spare pool backs every hosted model).
A mesh-sharded tier's standbys are GANGS (``ServingCluster.run(mesh=...,
warm_standbys=...)``): every rank builds its shards, warms up in lockstep
(the warm-up steps run the tp collectives) and unloads; the leader waits
for the promotion while its members wait in the gang's step protocol
(``serving/sharded.py``), and the promotion rides a descriptor, on which
every rank loads its own shard.

Every heal path the tier had before this module was COLD: a dead,
preempted, or scale-up replica paid full process boot + first calls +
(checkpoint) restore before taking a request — exactly the window that
melts under a traffic spike or a correlated preemption.  This module
keeps ``warm_standbys=N`` spare replicas fully initialized but
unregistered, so a heal becomes *promote + load weights* instead of
*spawn + first calls (captures) + restore*.

Worker side (:func:`serve_standby`, the standby map_fun):

- boots like a serving replica — process up, card started, model
  constructed, and the serve-step sites run (captured, with the tier's
  capture cache) via a throwaway warm-up sweep — then **unloads the
  parameters** (:meth:`~tensorflowonspark_tpu_torch.models.serving.
  ContinuousBatcher.unload_params`) and idles in heartbeat phase
  ``standby``, never registered with the scheduler (a gang's leader
  broadcasts an ``idle`` descriptor well inside the gang's timeout
  meanwhile);
- on a driver ``{"op": "standby", "event": "promote"}`` control message
  it re-arms: **peer weight cloning** first — it asks the live peer
  replica named in the message for its params over the existing
  queue/shm data plane (leader-to-leader bulk transfer, one message,
  zero-copy on a shared host) — falling back to rebuilding through the
  tier's ``model_builder`` (the checkpoint-restore path) when no healthy
  peer exists or the clone times out; then acks ``standby_ready`` on its
  response queue and enters the ordinary serve loop.  Promotion cost is
  transfer + load, not restore-from-store.  A gang clones from a peer gang,
  whose ranks gather their shards to its leader; the standby gang's
  leader broadcasts the whole tree (or, failing the clone, nothing: then
  every rank builds) and each rank cuts and loads its own shard;
- ``EndOfFeed`` (tier shutdown) exits the wait loop cleanly; a SIGTERM/
  SIGKILL simply kills the process — the driver's monitor classifies it
  and the pool backfills (a standby carries no in-flight work to drain).

Driver side (:class:`StandbyPool`):

- :meth:`fill` boots the pool through the cluster's live-membership path
  (``cluster.add_workers`` with the standby map_fun — gang-sized,
  gang_size-aligned blocks — watched by the monitor, invisible to the
  scheduler);
- :meth:`acquire` pops one standby ATOMICALLY — the dedup that makes a
  concurrent replica failure + autoscaler scale-up promote two
  *different* standbys (or one promotion + one cold spawn), never the
  same standby twice;
- :meth:`handle_failure` reaps a dead standby gang (EndOfFeed its
  survivors, retire from cluster + monitor) and backfills in the
  background — the pool self-heals under churn;
- :meth:`backfill_async` restores the pool after every promotion.

``docs/robustness.md`` has the lifecycle diagram and the heal-time
model; ``docs/serving.md`` the knob table.
"""

from __future__ import annotations

import contextlib
import logging
import queue as _queue
import threading
import time

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch.marker import EndOfFeed, Marker
from tensorflowonspark_tpu_torch.serving.scheduler import (REQUEST_QUEUE,
                                                     RESPONSE_QUEUE)

logger = logging.getLogger(__name__)

#: heartbeat phases a standby worker publishes: warming (building +
#: compiling) → ``standby`` (ready to promote) — the driver's
#: ``wait_standbys`` polls for the latter
STANDBY_WARMUP_PHASE = "standby_warmup"
STANDBY_PHASE = "standby"

#: sentinel: an EndOfFeed interrupted the promotion — exit, don't serve
_STOP = object()


# --------------------------------------------------------- worker side

def serve_standby(args, ctx) -> None:
    """The warm-standby map_fun: fully initialize, unload params, idle in
    phase ``standby`` until promoted or shut down (module docstring).

    Takes the same ``args`` contract as :func:`~tensorflowonspark_tpu_torch.
    serving.replica.serve_replica` / :func:`~tensorflowonspark_tpu_torch.
    serving.sharded.serve_sharded_replica` plus ``serve_clone_timeout``
    (secs to wait for a peer weight clone before falling back to the model
    builder; default 60)."""
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
    from tensorflowonspark_tpu_torch.serving.replica import (
        arm_draft, on_device, run_serve_loop, serving_aot_cache, serving_batcher_kwargs,
        serving_device)

    mgr = ctx.mgr
    if mgr is None:
        raise RuntimeError("the standby loop needs the node queue server "
                           "(InputMode.SPARK)")
    ctx.report_step(0, phase=STANDBY_WARMUP_PHASE)
    if args.get("serve_mesh"):
        _standby_gang(args, ctx)
        return
    device = serving_device(args)
    cfg, params = args["serve_model_builder"](args)
    batcher = ContinuousBatcher(
        cfg, on_device(params, device),
        max_batch=int(args.get("serve_max_batch", 4)),
        eos_id=args.get("serve_eos_id"),
        aot_cache=serving_aot_cache(args),
        **serving_batcher_kwargs(args))
    del params
    # arm the tier's draft BEFORE the warm-up sweep, so the draft's
    # propose and the verify sites are part of what the standby pre-pays
    # (and captures)
    arm_draft(batcher, args)
    if _stopped_before_warmup(mgr):
        # the tier shut down while this standby was booting (a backfill
        # racing the teardown): nothing to warm for
        logger.info("standby %d retired before its warm-up", ctx.executor_id)
        return
    _warm_batcher(batcher)
    batcher.unload_params()     # warm posture: captured, weightless
    ctx.report_step(0, phase=STANDBY_PHASE)
    logger.info("standby %d warm (serve steps %s, params unloaded)", ctx.executor_id,
                "captured" if batcher.aot_stats() else "run once")
    promote = _standby_wait(mgr)
    if promote is None:         # EndOfFeed: tier shutdown
        logger.info("standby %d retired unpromoted", ctx.executor_id)
        return
    got = _acquire_params(args, ctx, mgr, promote)
    if got is _STOP:
        # EndOfFeed landed mid-promotion (tier shutdown, or a retire
        # before the clone finished): exit cleanly instead of serving
        # unregistered forever
        logger.info("standby %d stopped during promotion", ctx.executor_id)
        return
    params, prefix_pages = got
    # a peer clone arrives as HOST arrays: with captured sites, copied
    # once into the storage the graphs read
    loop_args = promote_batcher(batcher, args, promote, params,
                                who=f"standby {ctx.executor_id}")
    if prefix_pages is not None:
        # the peer's prefix-cache pages rode the clone (KV computed under
        # the very weights just loaded): import them so post-heal
        # same-system-prompt TTFT keeps its hits.  Best-effort: a failed
        # import costs TTFT, never the promotion.
        try:
            n = batcher.import_prefix_cache(prefix_pages)
            logger.info("standby %d imported %d cloned prefix-cache page(s)",
                        ctx.executor_id, n)
        # tfos: ignore[broad-except] — the heal must complete even when
        # the page clone is unusable (hash mismatch, geometry drift); the
        # warm pool exists for capacity
        except Exception:
            logger.exception("standby %d: cloned prefix-cache import failed; "
                             "serving cold-cache", ctx.executor_id)
    _announce_ready(mgr, promote)
    logger.info("standby %d promoted (source=%s%s): serving",
                ctx.executor_id, promote.get("source"),
                "" if promote.get("model") is None
                else f", model={promote['model']}@{promote.get('version')}")
    run_serve_loop(loop_args, ctx, batcher, label="promoted-standby",
                   role=promote.get("role"), base_args=args)


def _standby_gang(args, ctx) -> None:
    """A standby gang's rank: build the gang's world and this rank's shards
    and batcher, run the warm-up sweep in lockstep, unload; the leader then
    waits for the promotion (ticking the gang's protocol) and broadcasts it
    — with the whole tree a peer gang cloned to it, or none, and then every
    rank builds — and serves; the members follow the leader's descriptors
    (``sharded._member_loop``)."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.serving.replica import run_serve_loop
    from tensorflowonspark_tpu_torch.serving.sharded import (GangSpec, _gang_batcher,
                                                             _member_loop, gang_barrier,
                                                             gang_of)

    mgr = ctx.mgr
    spec = GangSpec.from_args(args)
    leader_eid, rank = gang_of(ctx.executor_id, spec.gang_size)
    try:
        batcher, shard = _gang_batcher(args, ctx, spec)
        # the warm-up steps are collectives: every rank warms or none does
        stopped = torch.tensor([int(_stopped_before_warmup(mgr))])
        dist.all_reduce(stopped, op=dist.ReduceOp.MAX)
        if stopped.item():
            logger.info("standby gang %d rank %d retired before its warm-up", leader_eid, rank)
            return
        _warm_batcher(batcher)
        batcher.unload_params()
        ctx.report_step(0, phase=STANDBY_PHASE)
        if rank != 0:
            _member_loop(args, ctx, leader_eid, rank, batcher, shard=shard)
            return
        logger.info("standby gang %d warm (%s, params unloaded)", leader_eid, spec.describe())
        barrier = gang_barrier(args)
        try:
            promote = _standby_wait(mgr, tick=barrier.tick)
            if promote is None:
                logger.info("standby gang %d retired unpromoted", leader_eid)
                return
            params, peer = None, promote.get("peer")
            if peer is not None:
                got = _clone_from_peer(ctx, mgr, peer, tick=barrier.tick,
                                       timeout=float(args.get("serve_clone_timeout", 60.0)))
                if got is _STOP:
                    logger.info("standby gang %d stopped during promotion", leader_eid)
                    return
                if got is not None:
                    params = got["params"]
                else:
                    logger.warning("standby gang %d: peer clone from %s failed; every rank "
                                   "builds", leader_eid, peer.get("executor_id"))
            desc = {k: v for k, v in promote.items() if k not in ("op", "event", "peer")}
            desc["params"] = params
            barrier.promote(desc)
            loop_args = promote_batcher(batcher, args, desc, params, shard=shard,
                                        who=f"standby gang {leader_eid} rank 0")
            _announce_ready(mgr, promote)
            logger.info("standby gang %d promoted (source=%s, %s): serving", leader_eid,
                        promote.get("source"), "cloned" if params is not None else "built")
            run_serve_loop(loop_args, ctx, batcher, gang=barrier,
                           label=f"promoted standby gang-{leader_eid} leader",
                           role=promote.get("role"), base_args=args)
        finally:
            barrier.stop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def promote_batcher(batcher, args, promote: dict, params=None, *, shard=None,
                    who: str = "standby") -> dict:
    """One promotion, the same for a single standby and on every rank of a
    standby gang: take the promoted pool's role, load the weights —
    ``params``, the tree a peer cloned (host arrays), else built here from
    the promoted version's payload or the tier's builder — and re-arm the
    draft when the promoted version's ``serve_args`` overlay changes it.
    A gang rank passes ``shard`` (``(cfg, params) -> this rank's
    shards``), which cuts the whole tree (and the draft) to its own heads.
    Returns the serve loop's args: the boot args under that overlay.

    The draft re-arm is best-effort everywhere: a promoted replica must
    serve, so a bad overlay draft costs speculation, never the heal.  A
    gang whose ranks disagree on it (one rank's build failing alone) fails
    its next step's collectives or digests, and the tier replaces it."""
    from tensorflowonspark_tpu_torch.serving.replica import arm_draft

    if params is None:
        params = _built_params(args, promote)
    role = promote.get("role")
    if role is not None:
        # promote-with-role (disaggregated tier): specialize the
        # pre-warmed engine for the pool it joins.  The standby was built
        # from the tier's BASE batcher kwargs — per-role overlays (e.g.
        # prefill_chunk) need a batcher rebuild, which would re-pay the
        # warm-up the pool exists to hoist, so the promoted replica serves
        # with the base engine and a notice is logged.
        overlay = (args.get("serve_disagg") or {}).get(f"{role}_kwargs")
        if overlay:
            logger.warning(
                "%s promoted into the %s pool: the tier's %s_kwargs overlay %r does "
                "not apply to a pre-warmed engine (serving with base batcher config)",
                who, role, role, overlay)
        batcher.set_role(role)
        logger.info("%s specialized for the %s pool", who, role)
    if shard is not None:
        import torch

        from tensorflowonspark_tpu_torch.ops.quant import _QuantArray

        params = shard(batcher.cfg, {n: v if isinstance(v, _QuantArray) else torch.as_tensor(v)
                                     for n, v in params.items()})
    batcher.load_params(params)
    # the promoted model's serve_args overlay (e.g. a seed, a bench's step
    # delay) applies to the serve LOOP; the pristine boot args stay the
    # base for later hot swaps, so a rollback away from this version fully
    # sheds its knobs
    loop_args = dict(args, **promote["serve_args"]) if promote.get("serve_args") else args
    if any(loop_args.get(k) != args.get(k)
           for k in ("serve_draft_builder", "serve_draft_base_builder",
                     "serve_draft_adapter", "serve_draft_window",
                     "serve_draft_k", "seed")):
        try:
            # re-arm from the promoted version's arg view (swap or clear);
            # an unchanged overlay keeps the boot draft and its warmed sites
            arm_draft(batcher, loop_args, shard=shard)
        # tfos: ignore[broad-except] — see above; the target params are
        # already live and correct without any draft
        except Exception:
            logger.exception("%s: draft re-arm on promotion failed; serving without "
                             "speculation draft", who)
            batcher.set_draft(None)
    return loop_args


def _built_params(args, promote: dict):
    """A promotion's weights from its builder: the promoted version's
    payload (``model``/``builder``/``base_builder``), else the tier's
    ``model_builder`` (the checkpoint-restore path)."""
    if promote.get("model") is not None or promote.get("builder") \
            or promote.get("base_builder"):
        from tensorflowonspark_tpu_torch.serving.replica import resolve_version_params

        return resolve_version_params(args, promote)[0]
    return args["serve_model_builder"](args)[1]


def _announce_ready(mgr, promote: dict) -> None:
    """Ack the promotion to the driver (a gang's leader alone): the
    replica, in its pool's role, is about to enter the serve loop."""
    role = promote.get("role")
    mgr.queue_put(RESPONSE_QUEUE,
                  {"rid": None, "event": "standby_ready", "load": 0,
                   "source": promote.get("source"),
                   **({} if role is None else {"role": role})})


def _warm_batcher(batcher) -> None:
    """Pay the serve steps' first calls with throwaway decodes.

    Not just one: the prefill registry is keyed on (prompt bucket,
    admission-group rows), and a promoted standby's first real traffic
    arrives as GROUPS — a single solo warm-up would leave the batched
    prefill/scatter sites to capture inside the heal window (exactly the
    cold cost the pool exists to hoist).  So sweep the small bucket x
    group grid the serve path actually uses; the greedy decode step
    captures once on the first wave.  Further shapes capture on demand.

    With the capture cache armed every site the sweep reaches is captured
    here; without it the sweep pays the card's first calls (cuBLAS
    handles, the allocator's pools).  A speculating batcher sweeps with
    budget 4, not 2 — the spec step only engages with >1 token remaining
    (budget 2 commits its whole budget at admission + first verify-less
    step), so a 2-token sweep would leave the draft-propose and verify
    sites to capture inside the heal window."""
    import numpy as np

    budget = 2 if getattr(batcher, "spec_k", None) is None else 4
    group_sizes = sorted({1, min(2, batcher.max_batch), batcher.max_batch})
    for plen in (3, 6, 9):            # pow2 prompt buckets 4 / 8 / 16
        if plen + budget > batcher.cfg.max_position_embeddings:
            continue
        for rows in group_sizes:
            rids = [batcher.submit(np.ones(plen, np.int32), budget)
                    for _ in range(rows)]
            pending = set(rids)
            for _ in range(256):
                pending -= set(batcher.step())
                if not pending:
                    break
            for rid in rids:
                batcher.result(rid, pop=True)


def _stopped_before_warmup(mgr) -> bool:
    """True when an ``EndOfFeed`` is already queued; anything else queued
    is put back, in order."""
    stash, stopped = [], False
    try:
        while True:
            try:
                item = mgr.queue_get(REQUEST_QUEUE, timeout=0.01)
            except (_queue.Empty, TimeoutError):
                return stopped
            if isinstance(item, EndOfFeed):
                stopped = True
            elif not isinstance(item, Marker):
                stash.append(item)
    finally:
        for item in stash:
            with contextlib.suppress(Exception):
                mgr.queue_put(REQUEST_QUEUE, item)


def _standby_wait(mgr, tick=None) -> dict | None:
    """Idle on the request queue until the promote control message (or
    ``EndOfFeed`` → None), calling ``tick()`` (a gang leader's idle
    descriptor) between polls.  Anything else queued this early is
    re-injected for the serve loop (dispatch can race the promote ack)."""
    stash = []
    try:
        while True:
            if tick is not None:
                tick()
            try:
                item = mgr.queue_get(REQUEST_QUEUE, timeout=0.5)
            except (_queue.Empty, TimeoutError):
                continue
            if isinstance(item, EndOfFeed):
                return None
            if isinstance(item, dict) and item.get("op") == "standby" \
                    and item.get("event") == "promote":
                return item
            if isinstance(item, Marker):
                continue
            stash.append(item)
    finally:
        for item in stash:
            with contextlib.suppress(Exception):
                mgr.queue_put(REQUEST_QUEUE, item)


def _acquire_params(args, ctx, mgr, promote: dict):
    """The promoted standby's weights: peer clone first, model-builder
    (checkpoint restore) fallback.  Returns ``(params, prefix_pages)``
    — ``prefix_pages`` is the peer's cloned prefix-cache export, and
    ONLY rides the clone path: builder-restored weights may differ from
    any peer's, and prefix K/V computed under other weights would
    silently decode wrong tokens.  ``_STOP`` when an ``EndOfFeed``
    interrupted the clone wait (tier shutdown / concurrent retire).

    A promote message carrying a MODEL-VERSION payload (``model``/
    ``builder``/``base_builder``/``adapter``/``serve_args`` — the shared
    spare pool re-armed per model, docs/serving.md) builds through THAT
    payload on the fallback path; the driver already restricted ``peer``
    to replicas serving the same version, so the clone path is
    version-correct by construction."""
    peer = promote.get("peer")
    if peer is not None:
        got = _clone_from_peer(
            ctx, mgr, peer,
            timeout=float(args.get("serve_clone_timeout", 60.0)))
        if got is _STOP:
            return _STOP
        if got is not None:
            return got["params"], got.get("prefix_pages")
        logger.warning("standby %d: peer clone from %s failed/timed out; "
                       "falling back to the model builder",
                       ctx.executor_id, peer.get("executor_id"))
    return _built_params(args, promote), None


def _clone_from_peer(ctx, mgr, peer: dict, timeout: float, tick=None):
    """Pull params from a live peer replica over the queue/shm plane:
    post a ``clone`` request carrying OUR reply address onto the peer's
    request queue, then wait for the params message on our own (calling
    ``tick()`` between polls).  Returns the whole params message
    (host-numpy ``"params"`` tree plus the peer's optional
    ``"prefix_pages"`` export), or None on any failure — a peer gang that
    could not gather its tree sends ``params`` None."""
    from tensorflowonspark_tpu_torch.queues import QueueClient

    me = next(n for n in ctx.cluster_info
              if n["executor_id"] == ctx.executor_id)
    try:
        cli = QueueClient(tuple(peer["addr"]), peer["authkey"], timeout=30.0)
        try:
            cli.put(REQUEST_QUEUE,
                    {"op": "clone", "reply_addr": tuple(me["addr"]),
                     "reply_authkey": me["authkey"]}, timeout=10)
        finally:
            cli.close()
    # tfos: ignore[broad-except] — an unreachable peer (it may have just
    # died, which is why we are being promoted) must degrade to the
    # restore fallback, not crash the promotion
    except Exception:
        logger.exception("standby %d: clone request to peer %s failed",
                         ctx.executor_id, peer.get("executor_id"))
        return None
    stash = []
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            if tick is not None:
                tick()
            try:
                item = mgr.queue_get(REQUEST_QUEUE, timeout=0.5)
            except (_queue.Empty, TimeoutError):
                continue
            if isinstance(item, dict) and item.get("op") == "standby" \
                    and item.get("event") == "params":
                return item if item.get("params") is not None else None
            if isinstance(item, EndOfFeed):
                return _STOP        # shutdown/retire raced the promotion
            if isinstance(item, Marker):
                continue
            stash.append(item)      # early-dispatched gen requests
        return None
    finally:
        for item in stash:
            with contextlib.suppress(Exception):
                mgr.queue_put(REQUEST_QUEUE, item)


# --------------------------------------------------------- driver side

class StandbyPool:
    """Driver-side inventory of warm standby gangs (module docstring).

    All mutation happens under one lock; :meth:`acquire` POPS, so two
    concurrent heal decisions can never promote the same standby.  The
    pool emits its lifecycle (``standby_booted`` / ``standby_dead`` /
    ``standby_backfill_failed``) into the tier's ``serving_events.jsonl``
    and mirrors its size into ``tfos_serving_standby_count``.
    """

    def __init__(self, serving, size: int):
        if int(size) < 1:
            raise ValueError(f"StandbyPool needs size >= 1, got {size}")
        self.serving = serving
        self.size = int(size)
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}   # leader eid -> {info, members}
        self._gang: dict[int, int] = {}       # every standby eid -> leader
        #: every standby worker eid lost to failure while UNPROMOTED —
        #: the tier's shutdown tolerates these corpses like failed-over
        #: replicas (they were handled: the pool backfilled)
        self.dead: set[int] = set()
        self._stopped = False
        #: serializes fill/backfill: two concurrent promotions each
        #: trigger a backfill, and unserialized check-then-boot loops
        #: would overshoot the pool size
        self._fill_lock = threading.Lock()
        self._g_count = _metrics.get_registry().gauge(
            "tfos_serving_standby_count",
            "Warm standby replicas ready to promote.")
        self._g_count.set(0)

    # -- lifecycle ---------------------------------------------------------
    def fill(self, timeout: float | None = None) -> None:
        """Boot standbys until the pool holds ``size`` (blocking on each
        one's reservation; the model build and warm-up continue in the
        worker after this returns — gate on :meth:`wait_warm`).
        Serialized: concurrent backfills top the pool up exactly once."""
        with self._fill_lock:
            while not self._stopped and len(self._entries) < self.size:
                self._boot_one(timeout=timeout)

    def stop(self) -> None:
        """No further backfills; the cluster's shutdown EndOfFeed retires
        the unpromoted standbys themselves."""
        self._stopped = True
        self._g_count.remove()

    # -- inventory ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"standbys": len(self._entries),
                    "ready": sorted(self._entries)}

    def holds(self, eid: int) -> bool:
        """Whether ``eid`` is a worker of an unpromoted standby gang of
        this pool."""
        return self.leader_of(eid) is not None

    def leader_of(self, eid: int) -> int | None:
        """The standby gang leader owning ``eid`` (None when ``eid`` is
        not an unpromoted standby worker)."""
        with self._lock:
            return self._gang.get(int(eid))

    def acquire(self) -> tuple[int, dict] | None:
        """Pop the oldest (warmest) standby gang atomically: ``(leader
        eid, {"info": its reservation, "members": member eids})``, or None
        when empty.  From here on the gang is the caller's (scheduler
        registration, failure domain)."""
        with self._lock:
            if not self._entries:
                return None
            eid = min(self._entries)
            entry = self._entries.pop(eid)
            for e in (eid, *entry["members"]):
                self._gang.pop(e, None)
            self._g_count.set(len(self._entries))
        return eid, entry

    def wait_warm(self, timeout: float = 120.0) -> bool:
        """Block until every pooled standby heartbeats phase ``standby``
        (serve steps run, params unloaded).  False on timeout or when
        the tier runs without a monitor."""
        monitor = self.serving.monitor
        if monitor is None:
            return False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pooled = list(self._entries)
            if pooled:
                nodes = monitor.node_metrics()
                if all(nodes.get(e, {}).get("phase") == STANDBY_PHASE
                       for e in pooled):
                    return True
            time.sleep(0.2)
        return False

    # -- churn -------------------------------------------------------------
    def handle_failure(self, failed_eids) -> set[int]:
        """Absorb worker deaths that hit UNPROMOTED standbys: remove the
        gang from the pool, reap its surviving processes, backfill in the
        background.  Returns every executor id of an affected standby gang
        (the caller excludes them from replica failover)."""
        leaders = {self.leader_of(int(e)) for e in failed_eids}
        leaders.discard(None)
        handled: set[int] = set()
        for leader in sorted(leaders):
            with self._lock:
                entry = self._entries.pop(leader, None)
                if entry is None:
                    continue
                gang = (leader, *entry["members"])
                for e in gang:
                    self._gang.pop(e, None)
                self._g_count.set(len(self._entries))
            handled.update(gang)
            self.dead.update(gang)
            logger.warning("warm standby %d died; pool backfills", leader)
            self.serving.scheduler.emit_event("standby_dead", replica=leader,
                                              members=list(gang[1:]))
            # off the caller's thread: handle_failure runs inside the
            # monitor's poll (holding its _poll_lock — ignore_workers
            # would self-deadlock) and the reap does queue I/O
            threading.Thread(target=self._reap_and_backfill, args=(gang,),
                             name=f"standby-reap-{leader}",
                             daemon=True).start()
        return handled

    def backfill_async(self) -> None:
        """Restore the pool toward ``size`` on a background thread (the
        promotion/heal path must not block on a fresh standby's boot)."""
        if self._stopped:
            return
        threading.Thread(target=self._backfill,
                         name="standby-backfill", daemon=True).start()

    # -- internals ---------------------------------------------------------
    def _boot_one(self, timeout: float | None = None) -> int:
        serving = self.serving
        gsz = 1 if serving.gang_spec is None else serving.gang_spec.gang_size
        added = serving.cluster.add_workers(
            gsz, map_fun=serve_standby, tf_args=serving._serve_args,
            timeout=timeout)
        eid = int(added[0]["executor_id"])
        members = tuple(int(b["executor_id"]) for b in added[1:])
        with self._lock:
            self._entries[eid] = {"info": added[0], "members": members}
            for e in (eid, *members):
                self._gang[e] = eid
            self._g_count.set(len(self._entries))
        serving.scheduler.emit_event("standby_booted", replica=eid,
                                     members=list(members),
                                     pool=len(self._entries))
        logger.info("warm standby %d booted (pool %d/%d)", eid,
                    len(self._entries), self.size)
        return eid

    def _backfill(self) -> None:
        try:
            self.fill()
        # tfos: ignore[broad-except] — a failed backfill (cluster
        # shutting down, spawn refused) degrades the pool, it must not
        # kill the thread group or the heal that triggered it
        except Exception:
            if not self._stopped:
                logger.exception("warm-standby backfill failed")
                with contextlib.suppress(Exception):
                    self.serving.scheduler.emit_event(
                        "standby_backfill_failed",
                        pool=len(self._entries))

    def _reap_and_backfill(self, gang) -> None:
        self._reap(gang)
        self._backfill()

    def _reap(self, gang) -> None:
        """Stop a dead standby gang's survivors: EndOfFeed each shard
        (best-effort), retire from the monitor and the cluster so late
        exits are never classified and shutdown skips the slots."""
        serving = self.serving
        if serving.monitor is not None:
            serving.monitor.ignore_workers(gang)
        for e in gang:
            with contextlib.suppress(Exception):
                serving.cluster._client_for(e).put(REQUEST_QUEUE, EndOfFeed(), timeout=5)
            with contextlib.suppress(Exception):
                serving.cluster.retire_worker(e)
