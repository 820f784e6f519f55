"""Worker-side serving replica: ContinuousBatcher behind the node queues.

Port of ``tensorflowonspark_tpu/serving/replica.py``.  Only the lines that
moved parameters with JAX changed: a builder's state dict is moved onto
the replica's card (``serve_device``: None means the card, and a worker
without one raises; ``"cpu"`` runs the engine on the CPU), a weight clone
leaves as host arrays (:func:`~tensorflowonspark_tpu_torch.models.serving.
host_params`: bf16 as int16 bits) and is copied back into the batcher's
storage by ``load_params``.  Eager PyTorch compiles nothing, so the JAX
package's fleet-wide compile cache has no counterpart; the batcher's
compile-site cache is the CUDA-graph capture of ``serving/aot.py``
(``serve_aot_cache``).  A model hot swap (``op: "model"``) copies the
new version's weights into that storage through ``load_params``, so every
captured site serves them; a disaggregated decode replica writes an
adopted session's pages into its KV pool in place.  A mesh-sharded gang's
leader runs this loop with a ``gang`` (``serving/sharded.py``): the step
descriptor is broadcast over the gang's gloo world before each step, the
members' token digests are gathered over it after the step.

``serve_replica`` is a ``map_fun`` launched through the ordinary cluster
runtime (``TPUCluster.run`` / ``node.run``), so a serving replica gets the
whole worker substrate for free: the node's
:class:`~tensorflowonspark_tpu_torch.queues.QueueServer` (with per-connection
shm negotiation) as its request/response plane, crash files + the
``error`` queue for failure propagation, and the
:class:`~tensorflowonspark_tpu_torch.health.HeartbeatReporter` the driver's
:class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor` watches.

The loop interleaves request intake with decode — the same shape as
``examples/gpt/cluster_serving.py``'s worker, upgraded for the online
tier:

- intake is near-non-blocking while any slot is decoding (a blocking
  wait would stall every in-flight request) and blocks briefly when idle;
  with every slot busy it still sweeps the queue per step so CONTROL
  messages (a standby's weight-clone request, ``EndOfFeed``) never
  starve behind a full decode convoy — a gen request read during the
  sweep is carried to the next free slot;
- every committed token streams back immediately through the batcher's
  ``on_token`` hook, flushed as one ``{"event": "tok"}`` delta message
  per request per step (so a K-token block/speculative commit costs one
  message, not K);
- each decode step reports ``ctx.report_step(steps, phase="serving")`` —
  the driver's hang watchdog therefore covers the decode loop itself
  (a wedged device dispatch stops the step counter and trips
  ``step_timeout``/staleness exactly like a wedged training step), and
  chaos plans get their deterministic ``at_step`` trigger;
- response messages piggyback the batcher's
  :meth:`~tensorflowonspark_tpu_torch.models.serving.ContinuousBatcher.load`
  total, giving the scheduler real queue depth for routing;
- an :class:`~tensorflowonspark_tpu_torch.marker.EndOfFeed` marker (sent by
  ``cluster.shutdown`` — or per-replica by ``ServingCluster.
  retire_replica`` — exactly as for a training feed) stops intake; the
  loop drains its in-flight requests and exits cleanly;
- the loop runs under a :class:`~tensorflowonspark_tpu_torch.preemption.
  PreemptionGuard`: a SIGTERM (spot/preemptible reclaim, or the chaos
  ``replace`` verb) is latched instead of killing the process mid-
  decode.  The replica flips into DRAIN mode — the heartbeat phase
  turns ``preempted`` (the driver's serving tier sees it, stops routing
  and spawns a replacement), intake keeps consuming whatever the
  dispatcher already queued, in-flight slots decode to completion, and
  the process exits 0.  Elastic membership turns the reclaim into a
  planned departure instead of a failure (docs/serving.md).

``args`` contract (all keys prefixed ``serve_``):

- ``serve_model_builder(args) -> (cfg, params)`` — a picklable callable
  (top-level function) building the model in the worker process: a
  ``GPTConfig`` and a state dict (on any device; it is moved to
  ``serve_device``);
- ``serve_device`` — where the engine runs (None: the card);
- ``serve_max_batch`` (default 4), ``serve_eos_id`` (default None),
  ``serve_batcher_kwargs`` (extra ``ContinuousBatcher`` kwargs, e.g.
  ``decode_block_steps``/``speculative_k`` — note blocks trade intake
  latency for dispatch amortization);
- ``serve_idle_poll`` / ``serve_busy_poll`` — intake timeouts (secs);
- ``serve_role`` (``"prefill"``/``"decode"``) and ``serve_disagg`` — a
  disaggregated pool member (``serving/disagg.py``);
- ``serve_model`` — the ``(model_id, version)`` a registry version spawned
  with (``serving/rollout.py``);
- ``serve_step_delay`` — an artificial per-step latency (a deterministic
  "slow version" for rollout-gate tests; a swap's overlay can change it).
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time as _time

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch import tracing
from tensorflowonspark_tpu_torch.marker import EndOfFeed, Marker
from tensorflowonspark_tpu_torch.preemption import PreemptionGuard
from tensorflowonspark_tpu_torch.serving.scheduler import (REQUEST_QUEUE,
                                                     RESPONSE_QUEUE)

logger = logging.getLogger(__name__)


def serving_device(args):
    """The replica's device (``serve_device``; None means the card, which
    must exist), with matrix products in full float32 as the JAX package
    computes them.  On the CPU the replica's intra-op threads follow its
    ``OMP_NUM_THREADS`` (a worker forked from the fork server inherits
    the thread pool torch sized there, from the driver's environment)."""
    import os

    import torch

    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device(args.get("serve_device"))
    strict_matmul_precision()
    if device.type == "cpu" and os.environ.get("OMP_NUM_THREADS", "").isdigit():
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    return device


def on_device(params: dict, device) -> dict:
    """A builder's (or a clone's) state dict on ``device``: tensors and
    numpy arrays moved, quantized leaves with their tensors moved."""
    import torch

    from tensorflowonspark_tpu_torch.ops.quant import _QuantArray

    return {n: v.to(device) if isinstance(v, _QuantArray) else torch.as_tensor(v).to(device)
            for n, v in params.items()}


def serving_aot_cache(args):
    """The tier's compile-site cache (``serving/aot.py``: each site a CUDA
    graph) when ``args["serve_aot_cache"]`` is set
    (``ServingCluster.run(aot_cache=True)``), else None.  It keeps nothing
    on disk: a graph cannot be serialized."""
    if not args.get("serve_aot_cache"):
        return None
    from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache

    return AOTExecutableCache(None)


def build_draft_model(args, shard=None, tp=None):
    """This arg view's draft model (``serve_draft_builder``, or
    ``serve_draft_base_builder`` [+ ``serve_draft_adapter``] for a
    registry adapter version), moved to the replica's device and wrapped
    in a :class:`~tensorflowonspark_tpu_torch.models.serving.DraftModel`
    with ``serve_draft_window``; None when no draft is configured.  The
    draft is "just another model version": the same builder/adapter
    resolution the hot-swap and standby-promote paths use.  A gang's
    draft is cut by ``shard(cfg, params)`` and runs over ``tp``."""
    builder = args.get("serve_draft_builder")
    base = args.get("serve_draft_base_builder")
    if builder is None and base is None:
        return None
    from tensorflowonspark_tpu_torch.models.serving import DraftModel

    # the draft version's own serve_args overlay applies only while
    # BUILDING the draft (rollout.draft_overlay stashes it here) — a
    # draft's seed/knobs must never leak into the target's arg view
    draft_args = dict(args)
    draft_args.update(args.get("serve_draft_args") or {})
    if builder is not None:
        cfg, params = builder(draft_args)
    else:
        from tensorflowonspark_tpu_torch.serving.rollout import build_registered_model

        draft_args["serve_base_builder"] = base
        draft_args["serve_adapter"] = args.get("serve_draft_adapter")
        cfg, params = build_registered_model(draft_args)
    if shard is not None:
        params = shard(cfg, params)
    return DraftModel(cfg, on_device(params, serving_device(args)),
                      window=int(args.get("serve_draft_window", 64)), tp=tp)


def arm_draft(batcher, args, shard=None) -> None:
    """(Re)arm or clear the batcher's draft model from an arg view —
    boot, standby promotion, and hot swap all funnel here so target and
    draft can never go incoherent: a view without draft keys CLEARS any
    armed draft (swap-away invalidation), one with them builds and
    validates the new draft (typed errors from ``set_draft``, raised
    before any params move).  A gang passes ``shard`` (``(cfg, params)
    -> this rank's shards``): its draft runs over the batcher's tp group."""
    draft = None
    if not getattr(batcher, "prefill_only", False) \
            and getattr(batcher, "spec_k", None) is not None:
        draft = build_draft_model(args, shard=shard, tp=getattr(batcher, "tp", None))
    batcher.set_draft(draft)


def serve_clone_request(batcher, item: dict, ctx, params=None, prefix: bool = True) -> None:
    """Source side of peer weight cloning: ship this replica's params to
    the requester named in ``item`` (a promoted warm standby), off the
    decode thread so a bulk transfer never stalls in-flight streams.  A
    gang leader passes the whole tree its ranks gathered (``params``, host
    arrays; None when it has none to give, and the standby builds instead)
    and no prefix pages (``prefix=False``: its pages hold its heads only).

    The transfer rides the requester's own node queue plane — a
    ``QueueClient`` to ``item["reply_addr"]`` (zero-copy shm negotiated
    automatically on a shared host) carrying one
    ``{"op": "standby", "event": "params"}`` message.  A paged batcher's
    message ALSO carries its shared prefix-cache pages
    (``ContinuousBatcher.export_prefix_cache``: content-hashed KV page
    data + chain keys over the page-transfer plane), so the promoted
    standby inherits this replica's prefix hits instead of starting
    cold.  The page gather runs HERE, on the serve-loop thread — the
    decode steps write the cache in place, so a concurrent off-thread
    gather could read a half-written page."""
    reg = _metrics.get_registry()
    m_clones = reg.counter(
        "tfos_replica_clones_served_total",
        "Peer weight-clone transfers served by this replica.")
    prefix_pages = None
    try:
        export = getattr(batcher, "export_prefix_cache", None)
        if export is not None and prefix:
            prefix_pages = export()
    # tfos: ignore[broad-except] — the weight clone is the heal-critical
    # payload; a failed prefix-page snapshot only costs post-heal TTFT
    except Exception:
        logger.exception("replica %d: prefix-cache export for clone "
                         "failed; shipping weights only", ctx.executor_id)

    def _send():
        from tensorflowonspark_tpu_torch.models.serving import host_params
        from tensorflowonspark_tpu_torch.queues import QueueClient

        try:
            # host-gather ONE copy; the queue plane's pickle-5 path moves
            # it out-of-band (shm zero-copy when driver-negotiated)
            tree = host_params(batcher.params) if params is None and prefix else params
            cli = QueueClient(tuple(item["reply_addr"]),
                              item["reply_authkey"], timeout=60.0)
            try:
                cli.put(REQUEST_QUEUE,
                        {"op": "standby", "event": "params",
                         "params": tree, "src": ctx.executor_id,
                         "prefix_pages": prefix_pages},
                        timeout=60)
            finally:
                cli.close()
            m_clones.inc()
            logger.info("replica %d served a weight clone to %s",
                        ctx.executor_id, item.get("reply_addr"))
        # tfos: ignore[broad-except] — a failed clone must not kill the
        # serving replica; the standby's clone timeout falls back to
        # checkpoint restore
        except Exception:
            logger.exception("replica %d: peer weight clone failed",
                             ctx.executor_id)

    threading.Thread(target=_send, name="serve-clone", daemon=True).start()


def resolve_version_params(args, item, base_cache: dict | None = None):
    """Build a model-version payload's state dict (the hot-swap message /
    the standby promote payload): the payload's ``builder`` — or
    ``base_builder`` + ``adapter`` delta for adapter versions — run over
    this worker's args with the version's ``serve_args`` overlaid (so a
    builder keying on e.g. ``seed`` sees the version's value).  Returns
    ``(params, version_args)``; the caller loads the params and keeps
    ``version_args`` as its live arg view.

    ``base_cache``: the worker's PRISTINE-BASE cache.  Adapter swaps ship
    delta-only payloads, and re-applying a delta over the cached base
    beats rebuilding base+delta every swap.  The cache is only consulted
    when the payload's ``serve_args`` overlay carries no builder-visible
    knob (a non-``serve_``-prefixed key like ``seed`` changes what the
    base builder returns) — otherwise the base is rebuilt.  Capped at one
    entry: a model's adapter versions share one base by construction
    (adapter-over-adapter is rejected at registration)."""
    version_args = dict(args)
    version_args.update(item.get("serve_args") or {})
    base = item.get("base_builder")
    if base is not None:
        from tensorflowonspark_tpu_torch.serving.rollout import apply_adapter

        delta = item.get("adapter")
        version_args["serve_base_builder"] = base
        version_args["serve_adapter"] = delta
        overlay = item.get("serve_args") or {}
        cacheable = (base_cache is not None
                     and not any(not str(k).startswith("serve_")
                                 for k in overlay))
        key = (getattr(base, "__module__", None),
               getattr(base, "__qualname__", repr(base)))
        base_params = base_cache.get(key) if cacheable else None
        if base_params is None:
            _, base_params = base(version_args)
            if cacheable:
                base_cache.clear()
                base_cache[key] = base_params
        # apply_adapter never mutates the base leaves (delta'd names get
        # fresh tensors), so the cached state dict stays pristine
        params = (apply_adapter(base_params, delta) if delta
                  else base_params)
    else:
        builder = item.get("builder") or args["serve_model_builder"]
        _, params = builder(version_args)
    return params, version_args


def _donation_counter():
    """The one donation-counter family (both the export and import
    sites record into it; a single definition cannot drift)."""
    return _metrics.get_registry().counter(
        "tfos_replica_prefix_donations_total",
        "Cross-pool prefix-cache page donations by direction.",
        labelnames=("direction",))


def serve_prefix_donation(batcher, item, ctx) -> None:
    """Source side of cross-pool prefix-page donation: snapshot this
    (prefill) replica's shared prefix-cache pages and ship them straight
    to the requesting decode replica's queue plane (zero-copy/bulk
    negotiated like any tensor payload).  The gather runs HERE, on the
    serve-loop thread — decode steps write the cache in place, so an
    off-thread gather could read a half-written page; only the send is
    off-thread."""
    pages = None
    try:
        pages = batcher.export_prefix_cache()
    # tfos: ignore[broad-except] — a donation is an optimization; a
    # failed snapshot must not kill the serving replica
    except Exception:
        logger.exception("replica %d: prefix-cache export for donation "
                         "failed", ctx.executor_id)
    if not pages:
        logger.info("replica %d: nothing to donate (empty/dense prefix "
                    "cache)", ctx.executor_id)
        return
    m_donations = _donation_counter()

    def _send():
        from tensorflowonspark_tpu_torch.queues import QueueClient

        try:
            cli = QueueClient(tuple(item["reply_addr"]),
                              item["reply_authkey"], timeout=60.0)
            try:
                cli.put(REQUEST_QUEUE,
                        {"op": "prefix", "event": "pages", "export": pages,
                         "src": ctx.executor_id}, timeout=60)
            finally:
                cli.close()
            m_donations.inc(direction="exported")
            logger.info("replica %d donated %d prefix page(s) to %s",
                        ctx.executor_id, pages["pages"],
                        item.get("reply_addr"))
        # tfos: ignore[broad-except] — the recipient may have died; the
        # donation just doesn't happen
        except Exception:
            logger.exception("replica %d: prefix-page donation failed",
                             ctx.executor_id)

    threading.Thread(target=_send, name="serve-prefix-donate",
                     daemon=True).start()


def serving_batcher_kwargs(args) -> dict:
    """The ``ContinuousBatcher`` kwargs for this worker's role:
    ``serve_batcher_kwargs`` overlaid with the role's entry from
    ``serve_disagg`` (``{"prefill_kwargs": ..., "decode_kwargs": ...}``)
    and — for a prefill-pool worker — ``prefill_only=True``.  Shared by
    the replica and the warm standby, so every specialization builds the
    identical engine."""
    kwargs = dict(args.get("serve_batcher_kwargs") or {})
    role = args.get("serve_role")
    if role:
        kwargs.update(dict(
            (args.get("serve_disagg") or {}).get(f"{role}_kwargs") or {}))
    if role == "prefill":
        kwargs["prefill_only"] = True
    if (args.get("serve_draft_builder")
            or args.get("serve_draft_base_builder")) \
            and role != "prefill" and not kwargs.get("prefill_only") \
            and not (args.get("serve_disagg") and role is None) \
            and "speculative_k" not in kwargs \
            and "decode_block_steps" not in kwargs:
        # a configured draft implies speculation: arm the verify window
        # (serve_draft_k) unless the caller pinned either decode knob.
        # Role-less workers of a disagg tier (warm standbys) stay
        # unarmed — they may be promoted into a prefill pool, which
        # set_role refuses under decode-time knobs.
        kwargs["speculative_k"] = int(args.get("serve_draft_k", 4))
    return kwargs


def serve_replica(args, ctx) -> None:
    """The serving-tier ``map_fun``: serve generate requests until the
    driver sends ``EndOfFeed``."""
    # torch (and the model stack) import inside the worker process only
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher

    device = serving_device(args)
    cfg, params = args["serve_model_builder"](args)
    batcher = ContinuousBatcher(
        cfg, on_device(params, device),
        max_batch=int(args.get("serve_max_batch", 4)),
        eos_id=args.get("serve_eos_id"),
        aot_cache=serving_aot_cache(args),
        **serving_batcher_kwargs(args))
    del params
    arm_draft(batcher, args)
    run_serve_loop(args, ctx, batcher, role=args.get("serve_role"))


def run_serve_loop(args, ctx, batcher, *, gang=None, label: str = "replica",
                   role: str | None = None,
                   base_args: dict | None = None) -> None:
    """THE serving loop (module docstring): intake ⇄ step interleave over
    the node queue plane until ``EndOfFeed`` / a drained preemption.
    Shared by :func:`serve_replica`, a promoted warm standby and the
    mesh-sharded gang leader (``serving/sharded.py``), which passes its
    ``gang`` (a ``GangBarrier`` over the gang's gloo world): each ``gen``
    request the batcher took and each session it adopted is handed to
    ``gang.mirror``, a ``clone`` request to ``gang.serve_clone`` (every
    rank gathers its shards for the requester), a hot swap or a prefix donation to ``gang.refuse`` (which raises: the
    members could not apply it); each step runs as ``gang.step(batcher,
    steps)`` (the descriptor broadcast first), a prefill gang's exported
    sessions come back whole from ``gang.sessions``, ``gang.collect(steps,
    load, deltas)`` gathers every rank's token digest after the step's
    deltas are flushed, so the protocol never delays token delivery, and
    an idle loop calls ``gang.tick()``.  A gang exception (a lost shard)
    propagates out like a device failure, crashing the worker so the
    driver classifies the whole gang dead.

    ``role`` specializes the loop for a disaggregated pool
    (docs/serving.md "Disaggregated prefill/decode"): every response
    message carries the role so the scheduler can audit routing;
    ``"prefill"`` flushes each admitted request's exported session as a
    ``{"event": "handoff"}`` message (the batcher never decode-steps
    it); ``"decode"`` accepts ``{"op": "adopt"}`` intake items and seats
    them via ``batcher.adopt_session`` — a corrupt/raced transfer's
    ``ValueError`` bounces back as a typed error without touching the
    engine.

    ``base_args`` (a promoted standby passes its PRISTINE boot args
    while ``args`` carries the promoted version's serve_args overlay)
    is the base a later hot swap's version_args build from — so a
    rollback away from the promoted version fully sheds its knobs."""
    from tensorflowonspark_tpu_torch.bert_train import kernel_launches

    mgr = ctx.mgr
    if mgr is None:
        raise RuntimeError("the serving loop needs the node queue server "
                           "(InputMode.SPARK)")
    idle_poll = float(args.get("serve_idle_poll", 0.5))
    busy_poll = float(args.get("serve_busy_poll", 0.005))
    # how long a preempted replica keeps polling intake after its queue
    # looks empty: covers the window before the driver notices the
    # 'preempted' heartbeat phase and stops routing (heartbeat interval
    # + monitor poll), so a request dispatched into that window is still
    # served rather than stranded
    preempt_grace = float(args.get("serve_preempt_grace", 2.0))
    #: artificial per-step latency (benches/chaos: a deterministic
    #: "slow version" for rollout-gate testing); a model swap's
    #: serve_args overlay can change it live
    step_delay = float(args.get("serve_step_delay", 0.0))

    deltas: dict[int, list[int]] = {}   # batcher rid -> tokens this step
    carry = None   # gen request read during a full-slots control sweep
    pending_swap = None   # a model hot-swap awaiting an idle batcher

    def on_token(brid: int, tok: int) -> None:
        deltas.setdefault(brid, []).append(int(tok))

    # batcher rid -> (scheduler rid, trace id)
    rid_map: dict[int, tuple[int, str | None]] = {}
    first_sent: set[int] = set()        # batcher rids past first delta
    stopping = False
    steps = 0
    served = 0

    # telemetry: this worker process's registry rides the heartbeat
    # payload back to the driver (health.HeartbeatReporter); spans land
    # in <working_dir>/trace_events.jsonl (tracing.py)
    reg = _metrics.get_registry()
    m_steps = reg.counter("tfos_replica_steps_total",
                          "Decode steps executed by this replica.")
    m_tokens = reg.counter("tfos_replica_tokens_total",
                           "Tokens streamed by this replica.")
    m_served = reg.counter("tfos_replica_requests_total",
                           "Requests served to completion by this replica.")
    g_load = reg.gauge("tfos_replica_load_count",
                       "Batcher queue depth (active+pending+reserved).")
    # engine counters the batcher already keeps, surfaced as heartbeat-
    # carried metrics: tokens-per-dispatch (steps+tokens over dispatches)
    # is the amortization ratio, spec proposed/accepted the speculation
    # win, free pages + prefix outcomes the paged-KV story
    m_disp = reg.counter(
        "tfos_replica_decode_dispatches_total",
        "Decode DISPATCHES (a scanned block or fused verify counts "
        "once; compare tfos_replica_steps_total for the ratio).")
    m_prefill = reg.counter(
        "tfos_replica_prefill_dispatches_total",
        "Prefill dispatches (a batched admission group counts once).")
    m_spec = reg.counter(
        "tfos_replica_spec_tokens_total",
        "Speculative tokens by outcome (proposed/accepted).",
        labelnames=("outcome",))
    h_accept = reg.histogram(
        "tfos_replica_spec_accept_len_count",
        "Accepted draft length per drafted row per verify dispatch — "
        "the tokens-per-dispatch distribution behind the "
        "proposed/accepted totals (each commit is accept_len + 1 bonus "
        "token from one dispatch).")
    g_pages = reg.gauge(
        "tfos_replica_kv_pages_free_count",
        "Allocatable KV pages (free + evictable cached) in the paged "
        "pool; 0 for a dense-cache batcher.")
    m_prefix = reg.counter(
        "tfos_replica_prefix_cache_requests_total",
        "Prefix-cache admission outcomes (hit/miss/partial).",
        labelnames=("outcome",))
    m_sessions = reg.counter(
        "tfos_replica_sessions_total",
        "KV-page handoff sessions by direction (exported by a prefill "
        "pool / adopted by a decode pool).", labelnames=("direction",))
    m_aot = reg.counter(
        "tfos_replica_aot_resolves_total",
        "Serve-step site captures by outcome (compile = a CUDA graph "
        "captured, error = a failed capture or a call the graph could "
        "not replay, run eagerly; load stays 0: nothing is on disk).",
        labelnames=("outcome",))
    m_kernels = reg.counter(
        "tfos_replica_kernel_launches_total",
        "Launches of the repo's hand-written kernels in this process, "
        "by kernel (the wrappers' own counts).", labelnames=("kernel",))
    last = {"decode_dispatches": 0, "prefill_dispatches": 0,
            "spec_proposed": 0, "spec_accepted": 0,
            "sessions_exported": 0, "sessions_adopted": 0,
            "hit": 0, "miss": 0, "partial": 0,
            "aot_loads": 0, "aot_compiles": 0, "aot_errors": 0}
    launched = dict.fromkeys(kernel_launches(), 0)
    for name in launched:
        m_kernels.inc(0, kernel=name)    # every kernel's series, from 0

    def publish_engine_counters() -> None:
        """Move the batcher's lifetime counters (and the process's kernel
        launches) into the registry as deltas (the registry is
        cumulative per process already)."""
        for attr, inc in (("decode_dispatches", m_disp.inc),
                          ("prefill_dispatches", m_prefill.inc)):
            cur = getattr(batcher, attr, 0)
            if cur > last[attr]:
                inc(cur - last[attr])
                last[attr] = cur
        for attr, outcome in (("spec_proposed", "proposed"),
                              ("spec_accepted", "accepted")):
            cur = getattr(batcher, attr, 0)
            if cur > last[attr]:
                m_spec.inc(cur - last[attr], outcome=outcome)
                last[attr] = cur
        for attr, direction in (("sessions_exported", "exported"),
                                ("sessions_adopted", "adopted")):
            cur = getattr(batcher, attr)
            if cur > last[attr]:
                m_sessions.inc(cur - last[attr], direction=direction)
                last[attr] = cur
        for n in batcher.take_spec_accept_lens():
            h_accept.record(n)
        aot = batcher._aot
        if aot is not None:
            for attr, outcome in (("loads", "load"),
                                  ("compiles", "compile"),
                                  ("errors", "error")):
                cur = getattr(aot, attr, 0)
                if cur > last[f"aot_{attr}"]:
                    m_aot.inc(cur - last[f"aot_{attr}"], outcome=outcome)
                    last[f"aot_{attr}"] = cur
        stats = batcher.prefix_stats()
        for outcome in ("hit", "miss", "partial"):
            if stats[outcome] > last[outcome]:
                m_prefix.inc(stats[outcome] - last[outcome], outcome=outcome)
                last[outcome] = stats[outcome]
        for name, cur in kernel_launches().items():
            if cur > launched[name]:
                m_kernels.inc(cur - launched[name], kernel=name)
                launched[name] = cur

    tracer = tracing.tracer_for(ctx.working_dir)
    #: role piggyback on every response message — the scheduler audits
    #: that a pool member really serves its registered specialization
    role_extra = {} if role is None else {"role": role}

    def busy() -> bool:
        return batcher.load()["total"] > 0

    swap_base = base_args if base_args is not None else args
    #: pristine-base cache for delta-only adapter swaps (see
    #: resolve_version_params) — lives for the serve loop's lifetime
    swap_base_cache: dict = {}

    def apply_model_swap(item: dict, cur_delay: float):
        """Apply a drained hot swap (docs/serving.md "Multi-model
        serving"): params from a peer clone (the version already serves
        elsewhere) or the payload's builder/adapter.  ``load_params``
        checks names, shapes and dtypes before a weight changes (an
        incompatible version bounces back typed, the OLD params keep
        serving) and then COPIES the values into the batcher's storage
        when its sites are captured — a graph replays the storage it was
        captured over, so rebinding would keep serving the old weights.
        Returns the new per-step delay, ``cur_delay`` on a failed swap,
        or None when an EndOfFeed interrupted the clone wait (tier
        shutdown)."""
        old_draft = batcher._draft_model
        params = None
        version_args = dict(swap_base)
        version_args.update(item.get("serve_args") or {})
        peer = item.get("peer")
        # adapter payloads are DELTA-ONLY: re-applying the delta over the
        # pristine base (cached locally) always beats cloning full params
        # from a peer, so the peer hint is ignored for them
        if peer is not None and item.get("base_builder") is None:
            from tensorflowonspark_tpu_torch.serving.standby import (
                _STOP, _clone_from_peer)

            got = _clone_from_peer(ctx, mgr, peer, timeout=float(
                args.get("serve_clone_timeout", 60.0)))
            if got is _STOP:
                return None
            if got is not None:
                params = got["params"]
        try:
            if params is None:
                params, version_args = resolve_version_params(
                    swap_base, item, base_cache=swap_base_cache)
            # draft coherence BEFORE the params move: the new version's
            # draft arms (or a version without one clears the old draft)
            # while the old target still serves — a bad draft payload
            # bounces typed below with the old (params, draft) pair
            # fully intact
            arm_draft(batcher, version_args)
            batcher.load_params(params)
        # tfos: ignore[broad-except] — a bad version payload must bounce
        # back typed, not kill a serving replica; load_params validated
        # before it copied, so the old weights still serve
        except Exception as e:
            if batcher._draft_model is not old_draft:
                batcher.set_draft(old_draft)
            logger.exception("replica %d: model swap to %s@%s failed",
                             ctx.executor_id, item.get("model"),
                             item.get("version"))
            mgr.queue_put(RESPONSE_QUEUE,
                          {"rid": None, "event": "model_swap_failed",
                           "error": f"{type(e).__name__}: {e}",
                           "swap_token": item.get("swap_token"),
                           "load": 0, **role_extra})
            return cur_delay
        mgr.queue_put(RESPONSE_QUEUE,
                      {"rid": None, "event": "model_swapped",
                       "model": item.get("model"),
                       "version": item.get("version"),
                       "swap_token": item.get("swap_token"), "load": 0,
                       **role_extra})
        logger.info("replica %d hot-swapped to model %s@%s",
                    ctx.executor_id, item.get("model"),
                    item.get("version"))
        return float(version_args.get("serve_step_delay", 0.0))

    served_model = args.get("serve_model")
    logger.info("%s %d serving (max_batch=%d%s%s)", label, ctx.executor_id,
                batcher.max_batch,
                "" if not served_model
                else f", model {served_model[0]}@{served_model[1]}",
                "" if role is None else f", role {role}")
    draining = False
    drain_started = 0.0
    guard = PreemptionGuard()
    with guard:
        while True:
            if guard.preempted and not draining:
                draining = True
                drain_started = _time.monotonic()
                logger.warning(
                    "replica %d preempted: draining in-flight work, then "
                    "exiting cleanly (grace poll %.1fs)", ctx.executor_id,
                    preempt_grace)
                tracer.event("replica_preempted", None,
                             replica=ctx.executor_id,
                             inflight=batcher.load()["total"])
            if pending_swap is not None and not stopping \
                    and carry is None and not busy():
                # the driver drained this replica first, so the batcher
                # is idle here; a swap racing early-routed work simply
                # waits for the next idle step
                item, pending_swap = pending_swap, None
                got = apply_model_swap(item, step_delay)
                if got is None:     # EndOfFeed landed mid-clone
                    stopping = True
                    break
                step_delay = got
            queue_idle = False
            while not stopping:
                free = batcher.has_free_slot()
                if carry is not None:
                    if not free:
                        break
                    item, carry = carry, None
                else:
                    try:
                        # even with every slot busy, sweep the queue with
                        # a near-zero timeout: CONTROL messages (clone,
                        # EndOfFeed) must not starve behind a full batch
                        # — a promoted standby's weight clone would
                        # otherwise wait out the whole decode convoy
                        item = mgr.queue_get(
                            REQUEST_QUEUE,
                            timeout=(busy_poll if busy()
                                     else (0.05 if draining else idle_poll))
                            if free else 0.001)
                    except (_queue.Empty, TimeoutError):
                        queue_idle = True
                        break
                    if not free and isinstance(item, dict) \
                            and item.get("op") == "gen":
                        # a gen request read during the control sweep:
                        # hold it for the next free slot (it would have
                        # sat at the queue head anyway)
                        carry = item
                        break
                if isinstance(item, EndOfFeed):
                    stopping = True
                    break
                if isinstance(item, Marker):
                    continue
                if gang is not None and isinstance(item, dict) \
                        and item.get("op") in ("model", "prefix"):
                    gang.refuse(item["op"])
                if isinstance(item, dict) and item.get("op") == "clone":
                    # a promoted standby asks for this replica's weights
                    if gang is None:
                        serve_clone_request(batcher, item, ctx)
                    else:
                        gang.serve_clone(batcher, item, ctx)
                    continue
                if isinstance(item, dict) and item.get("op") == "model":
                    ev = item.get("event")
                    if ev == "swap":
                        # a hot swap: applied at the loop top once the
                        # batcher is idle (the driver drained first, so
                        # normally it already is)
                        pending_swap = item
                    elif ev == "cancel":
                        # the driver's swap call gave up (ack timeout):
                        # drop a swap not yet applied.  One already
                        # applied acks late instead, and the scheduler
                        # relabels on the late ack — the routing label
                        # always tracks the served version.
                        pending_swap = None
                    continue
                if isinstance(item, dict) and item.get("op") == "prefix":
                    ev = item.get("event")
                    if ev == "export":
                        # a decode replica asks for this pool's prefix
                        # pages (cross-pool donation)
                        serve_prefix_donation(batcher, item, ctx)
                    elif ev == "pages":
                        # a donated page set arrives: import as cached,
                        # refcount-0, evictable pages — matchable by
                        # the very next admission/adopt
                        try:
                            n = batcher.import_prefix_cache(item.get("export"))
                            if n:
                                _donation_counter().inc(
                                    n, direction="imported")
                            logger.info(
                                "replica %d imported %d donated prefix "
                                "page(s) from %s", ctx.executor_id, n,
                                item.get("src"))
                        # tfos: ignore[broad-except] — a corrupt/
                        # mismatched donation is rejected by the hash/
                        # layout checks; the replica serves on
                        except Exception:
                            logger.exception(
                                "replica %d: donated prefix-page import "
                                "failed", ctx.executor_id)
                    continue
                if isinstance(item, dict) and item.get("op") == "adopt":
                    # a handed-off session: seat it without re-prefilling.
                    # adopt_session verifies layout + per-page content
                    # hashes HERE — a corrupt or raced transfer raises
                    # before any device write and bounces back typed,
                    # the engine stays healthy
                    try:
                        brid = batcher.adopt_session(item["session"],
                                                     on_token=on_token)
                    except ValueError as e:
                        mgr.queue_put(RESPONSE_QUEUE,
                                      {"rid": item.get("rid"),
                                       "event": "error", "error": str(e),
                                       **role_extra})
                        continue
                    if gang is not None:
                        gang.mirror(item)
                    rid_map[brid] = (item["rid"], item.get("trace"))
                    tracer.event(
                        "replica_adopt", item.get("trace"),
                        rid=item["rid"], replica=ctx.executor_id,
                        pages=int(item["session"].get("pages", 0)))
                    continue
                if not (isinstance(item, dict) and item.get("op") == "gen"):
                    logger.warning("replica %d: ignoring non-request item %r",
                                   ctx.executor_id, type(item))
                    continue
                try:
                    brid = batcher.submit(
                        item["prompt"], int(item["max_new_tokens"]),
                        temperature=float(item.get("temperature", 0.0)),
                        top_p=float(item.get("top_p", 1.0)),
                        seed=int(item.get("seed", 0)), on_token=on_token)
                except ValueError as e:
                    # a malformed request must not kill the replica; bounce
                    # the typed error back to the scheduler
                    mgr.queue_put(RESPONSE_QUEUE,
                                  {"rid": item.get("rid"), "event": "error",
                                   "error": str(e), **role_extra})
                    continue
                if gang is not None:
                    gang.mirror(item)
                rid_map[brid] = (item["rid"], item.get("trace"))
                tracer.event("replica_intake", item.get("trace"),
                             rid=item["rid"], replica=ctx.executor_id,
                             prompt_tokens=len(item["prompt"]))
            if not busy():
                if stopping:
                    break
                if draining and queue_idle and (
                        _time.monotonic() - drain_started >= preempt_grace):
                    break   # grace-window drain complete: exit cleanly
                if gang is not None:
                    gang.tick()
                continue
            done = batcher.step() if gang is None else gang.step(batcher, steps + 1)
            if step_delay:
                _time.sleep(step_delay)
            steps += 1
            # serving-phase heartbeat: arms the hang watchdog on the decode
            # loop and gives chaos its at_step trigger.  A draining replica
            # reports phase 'preempted' — every step would otherwise clobber
            # the preemption flip back to 'serving' and the driver would
            # never see the grace window (it drains-and-replaces off this).
            # guard.preempted, not just `draining`: a SIGTERM landing MID-
            # iteration (after the loop-top check) must not have this very
            # step publish 'serving' over note_preempted's flip — if the
            # batcher idles right after, no later step would ever correct it
            ctx.report_step(steps,
                            phase="preempted" if (draining or guard.preempted)
                            else "serving")
            ld = batcher.load()
            load = ld["total"]
            free_pages = int(ld.get("free_pages", 0))
            # acceptance piggyback: cumulative proposed/accepted ride
            # every response message of a speculating replica, so the
            # scheduler's metrics()["replicas"] shows tokens-per-
            # dispatch without log scraping
            spec_extra = {} if batcher.spec_k is None \
                else {"spec": {"proposed": batcher.spec_proposed,
                               "accepted": batcher.spec_accepted}}
            m_steps.inc()
            g_load.set(load)
            g_pages.set(free_pages)
            publish_engine_counters()
            step_tokens = dict(deltas) if gang is not None else None
            for brid, toks in deltas.items():
                rid, trace = rid_map[brid]
                if brid not in first_sent:
                    first_sent.add(brid)
                    tracer.event("replica_first_token", trace, rid=rid,
                                 replica=ctx.executor_id)
                m_tokens.inc(len(toks))
                mgr.queue_put(RESPONSE_QUEUE,
                              {"rid": rid, "event": "tok",
                               "tokens": toks, "load": load,
                               "free_pages": free_pages, **spec_extra,
                               **role_extra})
            deltas.clear()
            for brid in done:
                batcher.result(brid, pop=True)  # tokens already streamed
                rid, trace = rid_map.pop(brid)
                first_sent.discard(brid)
                tracer.event("replica_done", trace, rid=rid,
                             replica=ctx.executor_id)
                m_served.inc()
                mgr.queue_put(RESPONSE_QUEUE,
                              {"rid": rid, "event": "done", "load": load,
                               "free_pages": free_pages, **spec_extra,
                               **role_extra})
                served += 1
            if role == "prefill":
                # prefill pool: flush each admitted request's exported
                # session AFTER its first-token delta (same queue, FIFO:
                # the driver sees TTFT close before the handoff).  The
                # session's KV pages ride the queue/shm plane as host
                # arrays — zero-copy on a shared host.  A prefill gang's
                # leader gathers its members' heads: the session it hands
                # off is whole, as a single replica's.
                sessions = batcher.take_sessions()
                if gang is not None:
                    sessions = gang.sessions(sessions)
                for brid, session in sessions:
                    rid, trace = rid_map.pop(brid)
                    first_sent.discard(brid)
                    tracer.event(
                        "replica_handoff", trace, rid=rid,
                        replica=ctx.executor_id,
                        pages=int(session.get("pages", 0)),
                        bytes=int(sum(a.nbytes for a in session["kv"])))
                    mgr.queue_put(RESPONSE_QUEUE,
                                  {"rid": rid, "event": "handoff",
                                   "session": session, "load": load,
                                   "free_pages": free_pages,
                                   **role_extra})
                    served += 1
            if gang is not None:
                # the digests AFTER the step's deltas are flushed, so the
                # protocol never delays token delivery
                gang.collect(steps, load, step_tokens)
    logger.info("%s %d %s: %d requests over %d steps "
                "(%d prefill + %d decode dispatches)", label,
                ctx.executor_id,
                "drained after preemption" if draining else "drained",
                served, steps, batcher.prefill_dispatches,
                batcher.decode_dispatches)
