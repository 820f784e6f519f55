"""Driver failover: rebuild a live serving control plane from the journal.

Port of ``tensorflowonspark_tpu/serving/failover.py``: a copy.

The driver is deliberately the STATELESS half of the serving tier:
workers host the queue servers, own the KV state, and keep decoding
through a driver death — the driver is only a queue *client* plus
in-memory bookkeeping, and every piece of that bookkeeping that matters
is write-ahead journaled (:mod:`~tensorflowonspark_tpu_torch.serving.journal`).
:func:`resume_driver` is the warm-standby path that exploits this::

    serving = ServingCluster.run(..., working_dir=wd)      # journals
    ...                                                    # <driver dies>
    serving2 = resume_driver(cluster, max_batch=4, ...)    # heals
    resume_rollouts(serving2)         # mid-canary rollouts CONTINUE

What a resume does, in order (docs/robustness.md "Control-plane
failover"):

1. **Replay** the fsync'd journal into a
   :class:`~tensorflowonspark_tpu_torch.serving.journal.JournalState` —
   idempotent under duplicate lines, torn tails skipped.
2. **Re-attach** to the live reservation/queue plane: a fresh
   :class:`~tensorflowonspark_tpu_torch.serving.scheduler.ReplicaScheduler`
   rebuilds its queue clients from the surviving cluster's reservation
   records; journal-dead replicas are marked dead before dispatch ever
   sees them, and the rebooted monitor ignores their corpses.
3. **Requeue** every accepted-but-uncommitted request under a NEW rid
   with a journaled ``requeue`` alias (requeue-once skip-dedup: stale
   token streams from surviving replicas miss the new rid and drop
   silently, exactly like the replica-death path), with the original
   admission's prompt/params/tenant/priority/trace.
4. **Re-adopt** registry state (the caller re-registers builders —
   callables cannot live in a JSONL journal — and the journal restores
   eval verdicts + version states) and **rebind** the frontend, by
   default on the crashed frontend's own port so riding-through clients
   (``ServeClient(failover_wait=...)``) reconnect where they were and
   ``resume`` their streams mid-token.
5. :func:`resume_rollouts` then CONTINUES any mid-flight rollout from
   its journaled position — only the canary percents without a
   ``rollout_step_done`` re-execute.

Zero-loss contract: every request the old driver *accepted* either
commits on the resumed tier or fails typed; greedy streams resume
oracle-exact (``python -m tensorflowonspark_tpu_torch.bench_serving
--failover`` gates this).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time

from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch.health import ClusterMonitor
from tensorflowonspark_tpu_torch.serving.frontend import (ServeFrontend,
                                                    ServingCluster)
from tensorflowonspark_tpu_torch.serving.journal import (ControlPlaneJournal,
                                                   JournalState)
from tensorflowonspark_tpu_torch.serving.scheduler import ReplicaScheduler

logger = logging.getLogger(__name__)


def _failover_hist():
    return tpu_metrics.get_registry().histogram(
        "tfos_serving_failover_seconds",
        "Driver-kill to control-plane-resumed heal latency.")


def resume_driver(cluster, *, journal_path: str | None = None,
                  address: tuple | None = None, max_batch: int = 4,
                  overcommit: int = 2, max_queue_depth: int | None = None,
                  requeue_limit: int = 1, frontend_mode: str = "local",
                  client_timeout: float = 600.0,
                  hang_timeout: float = 120.0,
                  step_timeout: float | None = None, monitor: bool = True,
                  tenants: dict | None = None, gang_size: int = 1,
                  roles: dict | None = None, model: tuple | None = None,
                  registry=None,
                  crashed_at: float | None = None) -> ServingCluster:
    """Stand a fresh driver control plane over a cluster whose previous
    driver died, from the journal — zero accepted requests lost.

    ``cluster`` is the surviving :class:`~tensorflowonspark_tpu_torch.cluster.
    TPUCluster` (in-process cold restart; a standby process re-attaches
    by rebuilding queue clients from the same reservation records).
    Scheduler shape knobs (``max_batch``/``gang_size``/``roles``/
    ``model``/``tenants``...) mirror :meth:`ServingCluster.run` — the
    journal records transitions, not the tier's construction arguments,
    so the resume is told the same shape the boot was.

    ``address`` (pass the crashed tier's ``serving.address``) rebinds
    the old frontend's port so clients riding through with
    ``failover_wait=`` reconnect without re-resolving; ``None`` binds an
    ephemeral port.  ``registry`` must
    carry the re-registered builders of every version the journal names
    (entries are matched by ``(model_id, version)``; eval verdicts and
    states are restored from the journal, so re-running evals is NOT
    required).  ``crashed_at`` (epoch seconds, e.g. from
    :func:`~tensorflowonspark_tpu_torch.chaos.fired_at`) closes the
    ``tfos_serving_failover_seconds`` heal measurement.

    Returns a live :class:`ServingCluster` whose ``resume_state`` holds
    the folded :class:`JournalState` the tier was rebuilt from.
    """
    if journal_path is None:
        wd = getattr(cluster, "working_dir", None)
        if not wd:
            raise ValueError("resume_driver needs journal_path= when the "
                             "cluster has no working_dir")
        journal_path = os.path.join(wd, "control_plane.jsonl")
    state = ControlPlaneJournal.replay(journal_path)
    if not state.admitted and not state.replicas:
        raise ValueError(
            f"journal {journal_path!r} replays empty — nothing to resume "
            "(wrong path, or the tier never journaled?)")
    # append-mode: the resumed driver extends the SAME journal — a
    # second failover replays both lives
    jnl = ControlPlaneJournal(journal_path)
    scheduler = mon = frontend = None
    try:
        scheduler = ReplicaScheduler(
            cluster, slots_per_replica=max_batch, overcommit=overcommit,
            max_queue_depth=max_queue_depth, requeue_limit=requeue_limit,
            tenants=tenants, gang_size=gang_size, roles=roles, model=model,
            journal=jnl)
        # adopt BEFORE start(): journal-dead replicas must be dead and
        # the unfinished admissions queued before any dispatch runs
        adopted = scheduler.adopt(state)
        if monitor:
            mon = ClusterMonitor(cluster, hang_timeout=hang_timeout,
                                 step_timeout=step_timeout,
                                 abort_on_failure=False, keep_polling=True,
                                 on_failure=scheduler.on_cluster_failure)
            gone = sorted({w for eid, ent in state.replicas.items()
                           if ent.get("alive") is False
                           for w in (eid, *(ent.get("members") or ()))})
            if gone:
                # corpses the OLD driver already failed over: never
                # re-classify them against the resumed tier
                mon.ignore_workers(gone)
            mon.start()
        scheduler.start()
        frontend = ServeFrontend(
            scheduler, authkey=cluster.cluster_meta["authkey"],
            mode=frontend_mode, default_timeout=client_timeout,
            port=0 if address is None else int(address[1]))
        # wire the ride-through state BEFORE accepting connections: a
        # fast client must not resume into an empty dict
        frontend.resumed = dict(adopted["requeued"])
        frontend.resumed_done = dict(adopted["done"])
        addr = frontend.start()
        serving = ServingCluster(cluster, scheduler, mon, frontend, addr)
        serving.journal = jnl
        serving.registry = registry
        serving.resume_state = state
        serving._default_model = (None if model is None
                                  else (str(model[0]), str(model[1])))
        if registry is not None:
            registry.bind_journal(jnl)
            registry.adopt(state)
    except Exception:
        for part in (frontend, scheduler, mon):
            if part is not None:
                with contextlib.suppress(Exception):
                    part.stop()
        jnl.close()
        raise
    heal_secs = None
    if crashed_at is not None:
        heal_secs = max(0.0, time.time() - float(crashed_at))
        _failover_hist().record(heal_secs)
    jnl.record("driver_resumed",
               requeued=len(adopted["requeued"]),
               committed=len(adopted["done"]),
               replicas=sorted(int(e) for e, ent in state.replicas.items()
                               if ent.get("alive", True)
                               and not ent.get("retired")),
               heal_secs=heal_secs)
    scheduler.emit_event(
        "driver_resumed", journal=journal_path,
        requeued=len(adopted["requeued"]), heal_secs=heal_secs,
        resumes=state.resumes + 1)
    logger.info(
        "driver resumed from %s: %d request(s) requeued, %d journal "
        "replica(s) (%d dead), %d open rollout(s)%s", journal_path,
        len(adopted["requeued"]), len(state.replicas),
        sum(1 for ent in state.replicas.values()
            if ent.get("alive") is False),
        len(state.open_rollouts()),
        "" if heal_secs is None else f", heal {heal_secs:.2f}s")
    return serving


def resume_rollouts(serving: ServingCluster, state: JournalState = None,
                    *, policy=None, block: bool = True) -> list:
    """CONTINUE every mid-flight rollout the journal left open — from
    its recorded position, not from scratch.

    For each model with a ``rollout_started`` but no ``rollout_done``,
    builds a :class:`~tensorflowonspark_tpu_torch.serving.rollout.
    RolloutController` whose step plan is narrowed to
    :meth:`JournalState.remaining_steps` — already-gated percents are
    skipped, a step whose intent was journaled but whose gate never
    committed re-executes (idempotent: re-setting a split is a no-op),
    and a rollout whose every step gated but whose promotion never
    committed finishes with the bare ``(100,)`` step.  The controller's
    canary arm short-circuits onto a surviving canary replica
    (``rollout_canary`` event with ``mode="resumed"``) instead of
    spawning a second one.

    ``state`` defaults to ``serving.resume_state`` (set by
    :func:`resume_driver`).  ``policy`` seeds gating knobs (bake time,
    regression bounds); its ``steps`` are overridden per model.  Returns
    the controllers (terminal when ``block``, running otherwise).
    """
    from tensorflowonspark_tpu_torch.serving.rollout import (RolloutController,
                                                       RolloutPolicy)

    if state is None:
        state = serving.resume_state
    if state is None:
        raise ValueError("resume_rollouts needs a JournalState — resume "
                         "the driver first (resume_driver) or pass "
                         "state= explicitly")
    controllers = []
    for model_id, rec in sorted(state.open_rollouts().items()):
        remaining = state.remaining_steps(model_id)
        pol = policy if policy is not None else RolloutPolicy()
        pol = dataclasses.replace(pol, steps=tuple(remaining))
        logger.info("resuming rollout %s -> %s at steps %s "
                    "(journal: %s done)", model_id, rec["version"],
                    remaining, rec["done_steps"] or "none")
        ctl = RolloutController(serving, model_id, rec["version"],
                                policy=pol)
        controllers.append(ctl)
        if block:
            ctl.run()
        else:
            ctl.start()
    return controllers
