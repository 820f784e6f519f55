"""Deterministic, env-driven fault injection for kill/restore testing.

Port of ``tensorflowonspark_tpu/chaos.py``: a copy (the kill, term, stall,
drop, replace and flap faults; the driver scope).

VERDICT.md called the recovery story "tested-on-CPU" until a real
kill/restore demonstration exists; this module is the injection half of
that demonstration.  Worker processes *self-apply* faults from a plan in
the ``TFOS_CHAOS`` environment variable, so tests and
``scripts/bench_recovery.py`` can script byte-reproducible failure
scenarios end-to-end through ``LocalProcessBackend`` (and, unchanged,
through ``AgentBackend`` — the env rides ``worker_env``).

Plan grammar (full reference: ``docs/robustness.md``)::

    TFOS_CHAOS = action [';' action]...
    action     = verb SP scope SP assignments # 'kill node=1 at_step=3'
    scope      = 'node='<int> | 'driver'      # 'kill driver after_secs=2'
    assignments= key'='value [[',' | SP] key'='value]...
    verb       = 'kill' | 'term' | 'stall' | 'drop' | 'replace' | 'flap'

Keys:

- ``node=<int>`` (required unless the scope is ``driver``) — executor id
  the action targets.  The bare token ``driver`` scopes the action to
  the DRIVER process instead (``kill`` only, ``after_secs=`` only —
  there are no worker steps on the driver): the serving tier arms it
  (``ServingCluster.run``) and fires it as a hard control-plane crash,
  the failover drill ``serving/failover.py`` heals from.  Same
  once-per-job sentinel (``chaos.driver.<index>``).
- ``at_step=<int>`` — fire when ``ctx.report_step()`` reaches this step.
- ``after_secs=<float>`` — fire this long after the worker's harness
  starts (checked on the heartbeat tick) — for faults before step 1.
- ``grace=<float>`` (``term`` only) — follow the SIGTERM with SIGKILL
  after this many seconds, modelling a preemption grace window.
- ``secs=<float>`` (``stall`` only) — how long to stall heartbeats
  (default: forever).
- ``every=<float>`` / ``count=<int>`` (``flap`` only) — ``every`` is the
  flap verb's own trigger (no ``at_step``/``after_secs`` needed).

Verbs:

- ``kill`` — SIGKILL self: the hard crash (no finally blocks, no crash
  file) the driver must notice from process exit + silence alone.
- ``term`` — SIGTERM self (optionally SIGKILL after ``grace``): the
  preemption shape; with a :class:`~tensorflowonspark_tpu_torch.preemption.
  PreemptionGuard` installed the worker checkpoints and exits cleanly,
  without one it dies and the monitor classifies ``preemption``.
- ``stall`` — suppress heartbeat publishing while the process stays
  alive: the wedged-on-a-collective shape the hang watchdog exists for.
- ``drop`` — stop the node's queue server: feeders and the monitor's kv
  polls lose their connection while training continues.
- ``replace`` — the elastic-serving kill-and-heal scenario, first
  class: SIGTERM self (optionally SIGKILL after ``grace``), exactly the
  reclaim shape a spot host sees.  A serving replica's
  ``PreemptionGuard`` latches it, drains in flight, and exits cleanly;
  the driver's ``ServingCluster`` sees heartbeat phase ``preempted``
  (or the classified exit) and spawns a replacement — same signal as
  ``term``, named separately so plans and benches state intent:
  ``replace node=1 at_step=8`` reads as "heal this", not "break this".
- ``flap`` — REPEATED failure: SIGKILL this node ``count`` times
  (default 1), once per process incarnation, each time the incarnation
  has been up for ``every`` seconds.  A flapping replica is the
  sustained-churn shape that exercises ``run_with_recovery`` restart
  budgets and the serving tier's warm-pool backfill — each kill's
  replacement/backfill survives ``every`` seconds, then dies too, until
  the count is spent.  Unlike the one-shot verbs, flap keeps ONE
  sentinel per firing (``chaos.<node>.<index>.f<k>``), so the
  once-per-job rule bounds the total at ``count`` across all attempts.

Every action fires at most once **per job**, not per attempt: before
firing, the worker writes a sentinel file ``chaos.<node>.<index>``
(containing ``time.time()``, which doubles as the fired-at timestamp for
detection-latency accounting) into ``TFOS_CHAOS_DIR`` — defaulting to the
cluster's working dir — and an existing sentinel disarms the action.
Restarted attempts therefore run clean, which is exactly what a
kill-then-recover scenario needs from a static env var.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import signal
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

PLAN_ENV = "TFOS_CHAOS"
STATE_DIR_ENV = "TFOS_CHAOS_DIR"

VERBS = ("kill", "term", "stall", "drop", "replace", "flap")

#: ``ChaosAction.node`` value for driver-scope actions (``kill driver
#: after_secs=F``) — no executor ever has this id, so worker agents
#: filter them out for free; sentinels use the literal ``driver``
DRIVER_NODE = -1

_INT_KEYS = ("node", "at_step", "count")
_FLOAT_KEYS = ("after_secs", "grace", "secs", "every")


class ChaosPlanError(ValueError):
    """Malformed ``TFOS_CHAOS`` plan — raised at parse time, in the worker
    harness, so a typo'd plan fails the job loudly instead of silently
    injecting nothing."""


@dataclasses.dataclass
class ChaosAction:
    """One parsed fault: what to do, on which node, triggered by what."""

    verb: str
    node: int
    at_step: int | None = None
    after_secs: float | None = None
    grace: float | None = None
    secs: float | None = None
    every: float | None = None   # flap: kill each incarnation after this
    count: int | None = None     # flap: total kills across the job
    index: int = 0  # position in the plan → sentinel-file identity

    def describe(self) -> str:
        scope = ("driver" if self.node == DRIVER_NODE
                 else f"node={self.node}")
        if self.verb == "flap":
            return (f"flap {scope} every={self.every:g} "
                    f"count={self.count or 1}")
        trig = (f"at_step={self.at_step}" if self.at_step is not None
                else f"after_secs={self.after_secs}")
        return f"{self.verb} {scope} {trig}"


def parse_plan(spec: str) -> list[ChaosAction]:
    """Parse a ``TFOS_CHAOS`` plan string into actions (see module doc)."""
    actions: list[ChaosAction] = []
    for idx, raw in enumerate(s for s in spec.split(";") if s.strip()):
        parts = [p for p in re.split(r"[,\s]+", raw.strip()) if p]
        verb = parts[0].lower()
        if verb not in VERBS:
            raise ChaosPlanError(
                f"unknown chaos verb {verb!r} in {raw!r} (want one of {VERBS})")
        kwargs: dict = {}
        for assign in parts[1:]:
            if "=" not in assign:
                if assign.lower() == "driver":
                    if "node" in kwargs:
                        raise ChaosPlanError(
                            f"chaos action {raw!r}: 'driver' and node= are "
                            f"mutually exclusive scopes")
                    kwargs["node"] = DRIVER_NODE
                    continue
                raise ChaosPlanError(f"expected key=value, got {assign!r} in {raw!r}")
            key, val = assign.split("=", 1)
            key = key.strip().lower()
            try:
                if key in _INT_KEYS:
                    kwargs[key] = int(val)
                elif key in _FLOAT_KEYS:
                    kwargs[key] = float(val)
                else:
                    raise ChaosPlanError(
                        f"unknown chaos key {key!r} in {raw!r} "
                        f"(want one of {_INT_KEYS + _FLOAT_KEYS})")
            except ValueError as e:
                if isinstance(e, ChaosPlanError):
                    raise
                raise ChaosPlanError(f"bad value for {key!r} in {raw!r}: {val!r}")
        if "node" not in kwargs:
            raise ChaosPlanError(
                f"chaos action {raw!r} needs a scope: node=<int> or driver")
        if kwargs["node"] < 0 and kwargs["node"] != DRIVER_NODE:
            raise ChaosPlanError(
                f"chaos action {raw!r}: node must be >= 0")
        if kwargs["node"] == DRIVER_NODE:
            if verb != "kill":
                raise ChaosPlanError(
                    f"chaos action {raw!r}: only 'kill' supports the "
                    f"driver scope")
            if kwargs.get("at_step") is not None:
                raise ChaosPlanError(
                    f"chaos action {raw!r}: at_step= does not apply to "
                    f"the driver (no worker steps); use after_secs=")
            if kwargs.get("after_secs") is None:
                raise ChaosPlanError(
                    f"chaos action {raw!r} needs a trigger: after_secs=")
        if verb == "flap":
            if kwargs.get("every") is None:
                raise ChaosPlanError(
                    f"chaos action {raw!r} needs every=<secs> "
                    f"(flap's own trigger)")
            if kwargs.get("at_step") is not None \
                    or kwargs.get("after_secs") is not None:
                # a one-shot trigger on flap would route it through the
                # single-fire path and silently drop every=/count=
                raise ChaosPlanError(
                    f"chaos action {raw!r}: at_step=/after_secs= do not "
                    f"apply to flap (every= is its trigger)")
            if kwargs.get("count") is not None and kwargs["count"] < 1:
                raise ChaosPlanError(
                    f"chaos action {raw!r}: count must be >= 1, "
                    f"got {kwargs['count']}")
        else:
            if kwargs.get("every") is not None \
                    or kwargs.get("count") is not None:
                raise ChaosPlanError(
                    f"chaos action {raw!r}: every=/count= are flap-only")
            if kwargs.get("at_step") is None \
                    and kwargs.get("after_secs") is None:
                raise ChaosPlanError(
                    f"chaos action {raw!r} needs a trigger: at_step= or "
                    f"after_secs=")
        actions.append(ChaosAction(verb=verb, index=idx, **kwargs))
    return actions


class ChaosAgent:
    """Self-applies the subset of a plan targeting this executor.

    Mounted on the worker's :class:`~tensorflowonspark_tpu_torch.health.
    HeartbeatReporter`: ``on_step`` runs inside ``ctx.report_step()``
    (deterministic step triggers), ``on_tick`` on the heartbeat thread
    (time triggers).  Firing order within one trigger follows plan order.
    """

    def __init__(self, actions: list[ChaosAction], executor_id: int,
                 state_dir: str | None = None, node_ctx=None):
        self.executor_id = int(executor_id)
        self.actions = [a for a in actions if a.node == self.executor_id]
        # an explicit $TFOS_CHAOS_DIR wins over the harness default (the
        # cluster working dir) — the operator writing the plan knows where
        # the driver-side latency accounting will look for sentinels
        self.state_dir = os.environ.get(STATE_DIR_ENV) or state_dir \
            or tempfile.gettempdir()
        self.node_ctx = node_ctx
        self._reporter = None
        self._armed_at = time.monotonic()
        self._fired: set[int] = set()
        for a in self.actions:
            logger.warning("chaos armed on node %d: %s", executor_id,
                           a.describe())

    def attach(self, reporter) -> None:
        self._reporter = reporter

    # -- triggers --------------------------------------------------------
    def on_step(self, step: int) -> None:
        for a in self.actions:
            if a.at_step is not None and step >= a.at_step:
                self._fire(a)

    def on_tick(self) -> None:
        elapsed = time.monotonic() - self._armed_at
        for a in self.actions:
            if a.verb == "flap":
                self._maybe_flap(a, elapsed)
            elif a.after_secs is not None and elapsed >= a.after_secs:
                self._fire(a)

    # -- firing ----------------------------------------------------------
    def _sentinel(self, action: ChaosAction) -> str:
        return os.path.join(self.state_dir,
                            f"chaos.{action.node}.{action.index}")

    def _flap_sentinel(self, action: ChaosAction, k: int) -> str:
        return f"{self._sentinel(action)}.f{k}"

    def flap_fired_count(self, action: ChaosAction) -> int:
        """Kills this flap action already delivered across ALL attempts
        (one ``.f<k>`` sentinel per firing)."""
        k = 0
        while os.path.exists(self._flap_sentinel(action, k)):
            k += 1
        return k

    def _maybe_flap(self, action: ChaosAction, elapsed: float) -> None:
        """One kill per incarnation once it has lived ``every`` seconds,
        until ``count`` total kills were delivered across the job."""
        if action.index in self._fired:      # this incarnation's kill is
            return                           # already on its way
        k = self.flap_fired_count(action)
        if k >= (action.count or 1) or elapsed < action.every:
            return
        self._fired.add(action.index)
        try:
            with open(self._flap_sentinel(action, k), "w") as f:
                f.write(f"{time.time():.6f}")
        except OSError:
            logger.warning("chaos: cannot write flap sentinel; firing "
                           "anyway")
        logger.warning("chaos FLAP %d/%d on node %d: %s", k + 1,
                       action.count or 1, self.executor_id,
                       action.describe())
        self._fire_flap(action)

    def _fire_flap(self, action: ChaosAction) -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    def _fire(self, action: ChaosAction) -> None:
        if action.index in self._fired:
            return
        self._fired.add(action.index)
        sentinel = self._sentinel(action)
        if os.path.exists(sentinel):  # already fired in a previous attempt
            return
        try:
            with open(sentinel, "w") as f:
                f.write(f"{time.time():.6f}")
        except OSError:
            logger.warning("chaos: cannot write sentinel %s; firing anyway",
                           sentinel)
        logger.warning("chaos FIRING on node %d: %s", self.executor_id,
                       action.describe())
        getattr(self, f"_fire_{action.verb}")(action)

    def _fire_kill(self, action: ChaosAction) -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    def _fire_term(self, action: ChaosAction) -> None:
        if action.grace:
            pid = os.getpid()
            t = threading.Timer(action.grace,
                                lambda: os.kill(pid, signal.SIGKILL))
            t.daemon = True
            t.start()
        os.kill(os.getpid(), signal.SIGTERM)

    def _fire_replace(self, action: ChaosAction) -> None:
        # same reclaim signal as `term`; the distinct verb lets a plan
        # say "drain-and-replace this node" — on a serving replica the
        # PreemptionGuard turns it into a clean elastic departure
        self._fire_term(action)

    def _fire_stall(self, action: ChaosAction) -> None:
        if self._reporter is not None:
            self._reporter.stall(action.secs)

    def _fire_drop(self, action: ChaosAction) -> None:
        ctx = self.node_ctx
        if ctx is not None and getattr(ctx, "mgr", None) is not None:
            try:
                ctx.mgr.stop()
            except Exception:
                logger.exception("chaos: drop failed")


class DriverChaos:
    """Driver-side arm of the plan: fires ``kill driver after_secs=F``.

    The worker verbs self-apply inside the worker harness; a
    driver-scope action has no harness, so the serving tier arms this
    object in ``ServingCluster.run``.  Firing means invoking ``on_fire``
    — the tier's hard control-plane crash
    (:meth:`~tensorflowonspark_tpu_torch.serving.frontend.ServingCluster.
    crash`): frontend sockets drop, scheduler threads stop with no
    drain/fail/cleanup of queued work, and only the fsync'd journal
    survives — the in-process equivalent of SIGKILLing a standalone
    driver process, minus taking the bench/test process with it.  Same
    once-per-job sentinel discipline as the worker verbs
    (``chaos.driver.<index>`` under ``TFOS_CHAOS_DIR``/``state_dir``,
    holding the fired-at wall clock for failover-latency accounting).
    """

    def __init__(self, actions: list[ChaosAction], on_fire,
                 state_dir: str | None = None):
        self.actions = [a for a in actions if a.node == DRIVER_NODE]
        self.on_fire = on_fire
        self.state_dir = os.environ.get(STATE_DIR_ENV) or state_dir \
            or tempfile.gettempdir()
        self._timers: list[threading.Timer] = []
        self._fired: set[int] = set()
        for a in self.actions:
            logger.warning("chaos armed on driver: %s", a.describe())

    def start(self) -> "DriverChaos":
        for a in self.actions:
            t = threading.Timer(a.after_secs or 0.0, self._fire, args=(a,))
            t.daemon = True
            t.start()
            self._timers.append(t)
        return self

    def stop(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers.clear()

    def _sentinel(self, action: ChaosAction) -> str:
        return os.path.join(self.state_dir, f"chaos.driver.{action.index}")

    def _fire(self, action: ChaosAction) -> None:
        if action.index in self._fired:
            return
        self._fired.add(action.index)
        sentinel = self._sentinel(action)
        if os.path.exists(sentinel):  # already fired in a previous attempt
            return
        try:
            with open(sentinel, "w") as f:
                f.write(f"{time.time():.6f}")
        except OSError:
            logger.warning("chaos: cannot write sentinel %s; firing anyway",
                           sentinel)
        logger.warning("chaos FIRING on driver: %s", action.describe())
        try:
            self.on_fire(action)
        except Exception:
            logger.exception("chaos: driver kill handler failed")


def driver_from_env(on_fire, state_dir: str | None = None) \
        -> DriverChaos | None:
    """Build the driver's chaos arm from ``$TFOS_CHAOS``; None when unset
    or when no action carries the ``driver`` scope."""
    spec = os.environ.get(PLAN_ENV)
    if not spec:
        return None
    drv = DriverChaos(parse_plan(spec), on_fire, state_dir=state_dir)
    return drv if drv.actions else None


def fired_at(state_dir: str, node: "int | str", index: int = 0) \
        -> float | None:
    """Read the fired-at wall time a sentinel recorded (bench/test helper);
    None if that action has not fired.  ``node="driver"`` reads a
    driver-scope action's sentinel."""
    path = os.path.join(state_dir, f"chaos.{node}.{index}")
    try:
        with open(path) as f:
            return float(f.read().strip())
    except (OSError, ValueError):
        return None


def from_env(executor_id: int, state_dir: str | None = None,
             node_ctx=None) -> ChaosAgent | None:
    """Build this worker's agent from ``$TFOS_CHAOS``; None when unset or
    when no action targets this executor (the common, zero-cost case)."""
    spec = os.environ.get(PLAN_ENV)
    if not spec:
        return None
    agent = ChaosAgent(parse_plan(spec), executor_id, state_dir=state_dir,
                       node_ctx=node_ctx)
    return agent if agent.actions else None
