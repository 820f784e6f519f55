"""Steady-state failure detection: heartbeats, watchdog, classification.

The reference's recovery model is whole-job restart + checkpoint resume
(SURVEY.md §5), and the rebuild has the restart loop
(``cluster.run_with_recovery``) and preemption latching (``preemption.py``)
— but until this module, failure *detection* existed only at bootstrap:
``cluster._watch_for_crashes`` exits once reservations complete, so a
mid-training crash was noticed only when a feeder socket happened to break,
and a hung worker (the SPMD-collective wedge named in ``TPUCluster._abort``'s
docstring) was never detected before ``shutdown``'s multi-day join timeout.
Spark gave the reference this for free (executor heartbeats + task failure
propagation); this module is the from-scratch equivalent:

- :class:`HeartbeatReporter` — worker side.  A background thread in
  ``node.run``'s harness publishes ``{seq, time, step, phase}`` into the
  node's existing kv store every ``interval`` seconds; the user's
  ``map_fun`` advances the ``step`` field through ``ctx.report_step()``.
- :class:`ClusterMonitor` — driver side, running for the cluster's whole
  life.  Polls ``backend.alive()``/``failed()`` and per-node heartbeat age,
  classifies what it sees (:class:`ClusterFailure` kinds ``crash`` /
  ``hang`` / ``preemption``), emits health events through
  :class:`~tensorflowonspark_tpu_torch.observability.EventLog`, and triggers
  fail-fast :meth:`TPUCluster._abort` so a half-dead SPMD job is torn down
  in seconds instead of wedging on collectives.

Staleness is measured on the *driver's* clock from when a heartbeat payload
last **changed** (the ``seq`` counter), so cross-host clock skew cannot
false-positive the watchdog.  The hang watchdog only arms once a node has
reported at least one step — a long first kernel build or model load
before step 1 must not be mistaken for a wedge.

Restart policy helpers (:func:`classify_failure`, :func:`classify_restart`,
:func:`backoff_delay`, :class:`RestartBudget`) back the
``cluster.run_with_recovery`` loop: deterministic user errors (a
``ValueError`` out of the map_fun's first step) are not retried, infra
failures always are, with exponential backoff + jitter inside a
max-R-restarts-per-T-seconds budget window.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import re
import signal
import threading
import time
from collections import deque

from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch import observability
from tensorflowonspark_tpu_torch.queues import QueueClient

logger = logging.getLogger(__name__)

HEARTBEAT_KEY = "heartbeat"

# Failure kinds a ClusterFailure / classify_failure can carry.
CRASH = "crash"            # worker process exited nonzero / was killed
HANG = "hang"              # heartbeat stale or step progress stalled
PREEMPTION = "preemption"  # SIGTERM-shaped exit (spot/preemptible reclaim)
USER = "user"              # deterministic error raised by the map_fun
INFRA = "infra"            # everything environmental (sockets, timeouts...)
#: terminal outcome kind: ``run_with_recovery``'s sliding-window restart
#: budget overflowed — the driver GAVE UP (emitted to the health
#: EventLog and as ``tfos_restarts_total{kind="budget_exhausted"}``
#: before the final re-raise, so operators can tell "gave up" from
#: "still retrying")
BUDGET_EXHAUSTED = "budget_exhausted"

# Exception types that mean "the user's code is wrong and will be wrong
# again on the next attempt" — retrying burns the restart budget for
# nothing.  Matched by *name* against worker tracebacks, which arrive as
# text (cluster._raise_worker_errors re-raises crash files).
_NO_RETRY_ERRORS = frozenset({
    "ValueError", "TypeError", "KeyError", "IndexError", "AttributeError",
    "AssertionError", "ZeroDivisionError", "NotImplementedError",
    "ImportError", "ModuleNotFoundError", "NameError",
    # submit-time payload rejection (analysis.preflight): deterministic —
    # the same payload fails identically on every attempt
    "PreflightError",
})

_TB_ERROR_RE = re.compile(r"^([A-Za-z_][\w.]*(?:Error|Exception|Interrupt))\b",
                          re.MULTILINE)


class ClusterFailure(RuntimeError):
    """A classified steady-state failure detected by :class:`ClusterMonitor`.

    ``kind`` is one of ``crash`` / ``hang`` / ``preemption``;
    ``failed_workers`` names the executor ids the detection implicates;
    ``detected_at`` is the driver's ``time.time()`` at detection (used by
    ``scripts/bench_recovery.py`` for detection-latency accounting).
    """

    def __init__(self, kind: str, message: str, failed_workers=()):
        super().__init__(message)
        self.kind = kind
        self.failed_workers = tuple(failed_workers)
        self.detected_at = time.time()


# ------------------------------------------------------------- worker side

class HeartbeatReporter:
    """Background liveness publisher for one worker process.

    Publishes ``{seq, time, step, phase, pid}`` under kv key ``heartbeat``
    every ``interval`` seconds through ``mgr`` (the node's in-process
    :class:`~tensorflowonspark_tpu_torch.queues.QueueServer` — the driver's
    monitor reads it over the same TCP kv the feed already uses, so no new
    port or protocol).  ``report_step`` publishes immediately, so the
    driver sees step progress with sub-interval latency.

    The reporter is also the mount point for chaos injection
    (the JAX package's ``chaos`` module; not yet ported): step- and time-triggered faults
    piggyback on ``report_step`` / the beat thread, and the ``stall``
    fault suppresses publishing to simulate a wedged process whose OS
    process is still alive.
    """

    def __init__(self, mgr, interval: float = 1.0):
        self.mgr = mgr
        self.interval = float(interval)
        self._seq = 0
        self._step: int | None = None
        self._phase = "boot"
        self._goodput = None            # observability.GoodputRecorder
        self._metrics_extras: dict = {}  # last snapshot, reused per publish
        # RLock: set_phase("preempted") runs inside the SIGTERM handler,
        # which executes on the MAIN thread and may interrupt report_step
        # while it holds this lock — a plain Lock would self-deadlock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._stall_until = 0.0          # monotonic deadline; inf = forever
        self._chaos = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "HeartbeatReporter":
        self._publish(include_metrics=True)
        self._thread = threading.Thread(target=self._run, name="heartbeat",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- producer API ----------------------------------------------------
    def report_step(self, step: int, phase: str = "step") -> None:
        """Record training progress (the ``ctx.report_step()`` hook).

        Arms the driver's hang watchdog from the first step ≥ 1 onward and
        gives chaos actions their deterministic ``at_step`` trigger.
        """
        with self._lock:
            self._step = int(step)
            self._phase = phase
        self._publish()
        if self._chaos is not None:
            self._chaos.on_step(int(step))

    def set_phase(self, phase: str) -> None:
        """Lifecycle phase (``boot``/``init``/``run``/``preempted``/...)
        surfaced to the driver's classifier."""
        with self._lock:
            self._phase = phase
        self._publish(include_metrics=True)

    def attach_goodput(self, recorder) -> None:
        """Carry ``recorder.summary()`` in the heartbeat payload so the
        driver's aggregated ``metrics()`` view shows per-node goodput
        live, not only as an end-of-job JSON file (``ctx.goodput()`` is
        the map_fun-side entry point)."""
        self._goodput = recorder
        self._publish(include_metrics=True)

    def note_preempted(self) -> None:
        """Signal-handler-safe phase flip to ``preempted``: one attribute
        store, NO locks and NO kv write — ``_publish`` goes through the
        queue server's non-reentrant kv lock, which the interrupted main
        thread may hold mid-``report_step``.  The beat thread publishes
        the new phase within one ``interval``; the driver reads it only
        after the exit, so the delay is immaterial."""
        self._phase = "preempted"

    def stall(self, secs: float | None = None) -> None:
        """Stop publishing for ``secs`` (``None`` = forever) — the chaos
        'wedged process' fault: the OS process stays alive, the heartbeat
        goes stale, and the driver's watchdog must notice."""
        self._stall_until = (float("inf") if secs is None
                             else time.monotonic() + float(secs))

    def attach_chaos(self, agent) -> None:
        self._chaos = agent
        agent.attach(self)

    # -- internals -------------------------------------------------------
    def _publish(self, include_metrics: bool = False) -> None:
        """Publish the heartbeat payload.  ``include_metrics`` refreshes
        this process's metrics-registry snapshot (and goodput summary) —
        the zero-new-sockets telemetry transport.  Only the periodic
        beat (and phase changes) pay the snapshot cost; ``report_step``'s
        per-step publishes reuse the cached extras so a fast decode/
        train loop never folds histograms on its hot path, yet EVERY
        payload the driver samples carries telemetry (at most one
        ``interval`` stale)."""
        if time.monotonic() < self._stall_until:
            return
        if include_metrics:
            # snapshot outside the reporter lock: it takes registry locks
            # of its own and runs collect hooks
            try:
                extras = {"metrics": tpu_metrics.get_registry().snapshot()}
                if self._goodput is not None:
                    extras["goodput"] = self._goodput.summary()
                self._metrics_extras = extras
            # tfos: ignore[broad-except] — telemetry enrichment must never
            # block liveness reporting; the bare heartbeat still goes out
            except Exception:
                logger.debug("heartbeat metrics snapshot failed",
                             exc_info=True)
        with self._lock:
            self._seq += 1
            payload = {"seq": self._seq, "time": time.time(),
                       "step": self._step, "phase": self._phase,
                       "pid": os.getpid(), **self._metrics_extras}
        try:
            self.mgr.kv_set(HEARTBEAT_KEY, payload)
        # tfos: ignore[broad-except] — liveness reporting must never kill
        # training; a dropped heartbeat IS the signal the driver detects
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if self._chaos is not None:
                self._chaos.on_tick()
            self._publish(include_metrics=True)


# ------------------------------------------------------------- driver side

class ClusterMonitor:
    """Steady-state watchdog over one running :class:`TPUCluster`.

    Runs a daemon thread from the end of ``TPUCluster.run`` until
    ``shutdown``/``_abort``, doing two checks per ``poll_interval``:

    1. **process check** — ``backend.failed()``; a nonzero exit is
       classified ``crash``, a uniformly SIGTERM-shaped exit (or one whose
       last reported phase was ``preempted``) is ``preemption``.
    2. **heartbeat check** — per-node kv read of the ``heartbeat`` payload
       via a dedicated short-timeout :class:`QueueClient` (``shm=False``:
       the monitor must not consume zero-copy ring slots).  A node whose
       payload has not *changed* for ``hang_timeout`` seconds — measured on
       the driver's clock — is classified ``hang``; likewise, with
       ``step_timeout`` set, a node whose *step* has not advanced.  Both
       checks arm only once that node has reported step ≥ 1, so long
       initial compiles cannot false-positive.

    On any failure the monitor records a :class:`ClusterFailure`, emits a
    health event, and (with ``abort_on_failure``, the default) triggers the
    cluster's fail-fast ``_abort()`` so surviving workers are torn down
    instead of wedging on collectives.  ``TPUCluster.shutdown`` re-raises
    the recorded failure; ``cluster.run_with_recovery`` classifies it for
    the restart decision.

    **Serving-tier mode** (``abort_on_failure=False, keep_polling=True,
    on_failure=...``): an online serving cluster must OUTLIVE a replica
    death — the right response is re-routing, not teardown.  With
    ``keep_polling`` the monitor does not stop at the first failure: each
    classified failure is appended to :attr:`failures`, handed to the
    ``on_failure(failure)`` callback (exceptions suppressed — detection
    must outlive a buggy subscriber), and the implicated workers are
    retired from both checks so one dead replica is reported exactly once
    while the survivors stay under watch.  Training clusters keep the
    default fail-fast single-shot behavior.
    """

    def __init__(self, cluster, hang_timeout: float = 120.0,
                 poll_interval: float = 0.5, step_timeout: float | None = None,
                 abort_on_failure: bool = True, event_log=None,
                 client_factory=None, on_failure=None,
                 keep_polling: bool = False, on_phase=None):
        self.cluster = cluster
        self.hang_timeout = float(hang_timeout)
        self.poll_interval = float(poll_interval)
        self.step_timeout = None if step_timeout is None else float(step_timeout)
        self.abort_on_failure = abort_on_failure
        self._own_events = event_log is None and bool(
            getattr(cluster, "working_dir", None))
        if self._own_events:
            event_log = observability.EventLog(
                os.path.join(cluster.working_dir, "health_events.jsonl"))
        self.events = event_log
        self._client_factory = client_factory or (
            lambda info: QueueClient(info["addr"], info["authkey"],
                                     timeout=2.0, shm=False))
        self.on_failure = on_failure
        #: ``on_phase(eid, phase)`` fires when a node's heartbeat-reported
        #: lifecycle phase CHANGES (exceptions suppressed, like
        #: ``on_failure``).  The serving tier subscribes to catch phase
        #: ``preempted`` while the process is still alive — its grace
        #: window — and turn it into drain-and-replace instead of waiting
        #: for the exit.
        self.on_phase = on_phase
        self.keep_polling = bool(keep_polling)
        #: every classified failure, in detection order (one entry per
        #: failure with ``keep_polling``; at most one without)
        self.failures: list[ClusterFailure] = []
        self._handled: set[int] = set()  # workers already reported
        self._clients: dict[int, QueueClient] = {}
        self._kv_retry_at: dict[int, float] = {}  # reconnect cooldowns
        self._hb: dict[int, dict] = {}
        self._failures_total = tpu_metrics.get_registry().counter(
            "tfos_health_failures_total",
            "Classified cluster failures detected by the monitor.",
            labelnames=("kind",))
        self._failure: ClusterFailure | None = None
        self._failure_evt = threading.Event()
        self._stop = threading.Event()
        self._poll_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ClusterMonitor":
        self._emit("monitor_started",
                   workers=len(self.cluster.cluster_info),
                   hang_timeout=self.hang_timeout,
                   step_timeout=self.step_timeout)
        self._thread = threading.Thread(target=self._loop,
                                        name="cluster-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # the monitor thread itself reaches stop() through cluster._abort()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        for c in self._clients.values():
            with contextlib.suppress(Exception):
                c.close()
        # tfos: ignore[lock-discipline] — the monitor thread is joined above;
        # a >5s join straggler only swaps per-eid entries (GIL-atomic) and
        # its next _poll_kv sees _stop set
        self._clients.clear()
        if self._own_events and self.events is not None:
            self.events.close()
            self.events = None
            self._own_events = False

    @property
    def failure(self) -> ClusterFailure | None:
        return self._failure

    def wait(self, timeout: float | None = None) -> ClusterFailure | None:
        """Block until a failure is detected (or ``timeout``); returns it."""
        self._failure_evt.wait(timeout)
        return self._failure

    def node_metrics(self) -> dict[int, dict]:
        """Last heartbeat-carried telemetry per node: ``{eid: {"metrics":
        <registry snapshot>, "goodput": <summary|None>, "step", "phase",
        "age_secs"}}`` — the driver-side aggregation point behind
        ``TPUCluster.metrics()`` / ``ServingCluster.metrics()``.  Purely
        a read of what the monitor already polls; no extra kv round."""
        now = time.monotonic()
        out: dict[int, dict] = {}
        for eid, rec in list(self._hb.items()):
            if eid in self._handled:
                # dead/retired workers must drop off the merged page,
                # not freeze at their last-reported values
                continue
            out[eid] = {"metrics": rec.get("metrics") or {},
                        "goodput": rec.get("goodput"),
                        "step": rec.get("step"), "phase": rec.get("phase"),
                        "age_secs": now - rec.get("seen", now)}
        return out

    def live_unhandled(self) -> list[int]:
        """Executor ids still alive and not yet retired from watching —
        the scoring/serving capacity a ``keep_polling`` consumer (the
        serving tier, the batch dispatcher) can still route work to.
        One backend sweep; no kv round."""
        _codes, alive, _failed = self._backend_snapshot()
        out = []
        for node in list(self.cluster.cluster_info):
            eid = node["executor_id"]
            if eid in self._handled:
                continue
            if eid < len(alive) and not alive[eid]:
                continue
            out.append(eid)
        return out

    def ignore_worker(self, executor_id: int) -> None:
        """Retire ``executor_id`` from both checks: a deliberately
        drained-and-stopped member (elastic scale-down, preemption
        drain) must not be classified as a crash/hang when it exits —
        nor keep contributing a frozen row to ``node_metrics``.  Its
        kv client is dropped."""
        eid = int(executor_id)
        with self._poll_lock:  # serialize vs an in-flight poll's checks
            self._handled.add(eid)
            cli = self._clients.pop(eid, None)
        if cli is not None:
            with contextlib.suppress(Exception):
                cli.close()

    def ignore_workers(self, executor_ids) -> None:
        """Retire several workers at once — the serving tier's gang verb:
        a mesh-sharded replica drains/dies as one unit, so its whole
        executor-id block leaves the watch together."""
        for eid in executor_ids:
            self.ignore_worker(int(eid))

    def poll_now(self) -> ClusterFailure | None:
        """One synchronous check, returning any (new or prior) failure.

        ``TPUCluster.shutdown`` calls this right after ``backend.join``
        returns: a worker that died *during* the join unblocks it
        immediately — possibly inside the monitor thread's poll sleep — and
        must still leave with a classified failure, not fall through to the
        generic nonzero-exit error.
        """
        with self._poll_lock:
            if self._failure is None or self.keep_polling:
                self._poll_once()
        return self._failure

    # -- monitor loop ----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                with self._poll_lock:
                    if self._failure is not None and not self.keep_polling:
                        return
                    if self._poll_once() and not self.keep_polling:
                        return
            except Exception:  # the watchdog must outlive its own bugs
                logger.exception("cluster monitor poll failed")
            self._stop.wait(self.poll_interval)

    def _poll_once(self) -> bool:
        codes, alive, failed = self._backend_snapshot()
        return (self._check_processes(codes, failed)
                or self._check_heartbeats(alive))

    def _backend_snapshot(self):
        """One backend sweep per poll: ``(exitcodes, alive, failed)``.

        Derived from a single ``exitcodes()`` call when the backend has one
        (exitcode None ⇔ alive, on both LocalProcessBackend and
        AgentBackend) — on AgentBackend each separate ``alive()``/
        ``failed()`` call would be a full STATUS round to every agent, and
        reading one snapshot also removes the window where the two calls
        could disagree within a poll.
        """
        backend = self.cluster.backend
        exitcodes = getattr(backend, "exitcodes", None)
        if exitcodes is not None:
            try:
                codes = dict(exitcodes())
                alive = [codes.get(i) is None
                         for i in range(len(self.cluster.cluster_info))]
                failed = [i for i, c in sorted(codes.items())
                          if c not in (0, None)]
                return codes, alive, failed
            except Exception:
                logger.debug("backend.exitcodes() failed; falling back to "
                             "alive()/failed()", exc_info=True)
        codes = {}
        try:
            alive = list(backend.alive())
        except Exception:
            logger.debug("backend.alive() failed mid-poll", exc_info=True)
            alive = []
        try:
            failed = list(backend.failed())
        except Exception:
            logger.debug("backend.failed() failed mid-poll", exc_info=True)
            failed = []
        return codes, alive, failed

    def _check_processes(self, codes: dict, failed: list) -> bool:
        failed = [i for i in failed if i not in self._handled]
        if not failed:
            return False
        sigterm = -int(signal.SIGTERM)
        preempted = (
            all(codes.get(i) == sigterm for i in failed)
            or any(self._hb.get(i, {}).get("phase") == "preempted"
                   for i in failed))
        kind = PREEMPTION if preempted else CRASH
        detail = ", ".join(f"worker {i} exit={codes.get(i)}" for i in failed)
        self._fail(ClusterFailure(
            kind, f"{kind} detected: {detail}", failed_workers=failed))
        return True

    def _check_heartbeats(self, alive: list) -> bool:
        now = time.monotonic()
        # copy: cluster_info grows in place when workers are added live
        for node in list(self.cluster.cluster_info):
            eid = node["executor_id"]
            if eid in self._handled:
                continue  # already reported; keep_polling watches the rest
            if eid < len(alive) and not alive[eid]:
                continue  # exited; crash/preemption handled by process check
            payload = self._poll_kv(node)
            rec = self._hb.setdefault(eid, {
                "seq": None, "seen": now, "step": None, "step_seen": now,
                "phase": None})
            if payload and payload.get("seq") != rec["seq"]:
                rec["seq"] = payload.get("seq")
                rec["seen"] = now
                new_phase = payload.get("phase")
                if new_phase != rec["phase"]:
                    rec["phase"] = new_phase
                    if self.on_phase is not None:
                        try:
                            self.on_phase(eid, new_phase)
                        except Exception:
                            logger.exception("on_phase subscriber raised")
                # heartbeat-carried telemetry (metrics.py): keep the last
                # snapshot/goodput per node for the aggregated cluster view
                if "metrics" in payload:
                    rec["metrics"] = payload.get("metrics")
                if "goodput" in payload:
                    rec["goodput"] = payload.get("goodput")
                if payload.get("step") != rec["step"]:
                    rec["step"] = payload.get("step")
                    rec["step_seen"] = now
            if rec["step"] is None or rec["step"] < 1:
                continue  # watchdog unarmed until the node reports a step
            hb_age = now - rec["seen"]
            if hb_age > self.hang_timeout:
                self._fail(ClusterFailure(
                    HANG,
                    f"hang detected: worker {eid} heartbeat stale for "
                    f"{hb_age:.1f}s (hang_timeout={self.hang_timeout}s, "
                    f"last step {rec['step']}, phase {rec['phase']})",
                    failed_workers=(eid,)))
                return True
            step_age = now - rec["step_seen"]
            if self.step_timeout is not None and step_age > self.step_timeout:
                self._fail(ClusterFailure(
                    HANG,
                    f"hang detected: worker {eid} stuck at step "
                    f"{rec['step']} for {step_age:.1f}s "
                    f"(step_timeout={self.step_timeout}s)",
                    failed_workers=(eid,)))
                return True
        return False

    def _poll_kv(self, node: dict):
        eid = node["executor_id"]
        now = time.monotonic()
        if now < self._kv_retry_at.get(eid, 0.0):
            return None  # recent connect failure: don't stall this poll
        cli = self._clients.get(eid)
        try:
            if cli is None:
                cli = self._clients[eid] = self._client_factory(node)
            payload = cli.kv_get(HEARTBEAT_KEY)
            self._kv_retry_at.pop(eid, None)
            return payload
        # tfos: ignore[broad-except] — deliberate: an unreachable kv is an
        # EXPECTED state the watchdog is built to absorb, and the handler
        # acts on it (drops the client, arms the reconnect backoff)
        except Exception:
            # unreachable kv: drop the client and back off reconnecting —
            # a netsplit node's connect can otherwise block a whole poll
            # (delaying detection for every OTHER node); driver-clock
            # staleness accrues regardless, so a wedged node still becomes
            # a hang once armed
            if cli is not None:
                with contextlib.suppress(Exception):
                    cli.close()
            self._clients.pop(eid, None)
            self._kv_retry_at[eid] = now + max(2.0, 4 * self.poll_interval)
            return None

    def _fail(self, failure: ClusterFailure) -> None:
        """Record + publish one classified failure (_poll_lock held by
        caller — every path here runs inside a _poll_once)."""
        self._failure = failure
        self.failures.append(failure)
        self._failures_total.inc(kind=failure.kind)
        logger.error("cluster monitor: %s", failure)
        self._emit(failure.kind, message=str(failure),
                   workers=list(failure.failed_workers))
        self._failure_evt.set()
        if self.keep_polling:
            self._handled.update(failure.failed_workers)
        if self.on_failure is not None:
            try:
                self.on_failure(failure)
            except Exception:
                logger.exception("on_failure subscriber raised")
        if self.abort_on_failure:
            self._emit("abort", reason=failure.kind)
            with contextlib.suppress(Exception):
                self.cluster._abort()

    def _emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            with contextlib.suppress(Exception):
                self.events.emit(kind, **fields)


# ------------------------------------------------------ restart policy

def classify_failure(exc: BaseException) -> str:
    """Map a failed attempt's exception to a failure kind.

    ``ClusterFailure`` carries its own kind; worker tracebacks (the
    ``RuntimeError`` text re-raised from crash files) are scanned for the
    exception types they contain — deterministic user errors classify
    ``user``, anything environmental classifies ``infra``.
    """
    if isinstance(exc, ClusterFailure):
        return exc.kind
    if isinstance(exc, (ConnectionError, EOFError, TimeoutError)):
        return INFRA
    found = _TB_ERROR_RE.findall(str(exc))
    if found and all(name.rsplit(".", 1)[-1] in _NO_RETRY_ERRORS
                     for name in found):
        return USER
    if type(exc).__name__ in _NO_RETRY_ERRORS and not found:
        return USER
    return INFRA


def classify_restart(kind: str) -> bool:
    """Should ``run_with_recovery`` relaunch after a ``kind`` failure?
    Deterministic user errors fail the same way every attempt — everything
    else (crash/hang/preemption/infra) is worth a restart."""
    return kind != USER


def backoff_delay(attempt: int, base: float = 1.0, cap: float = 30.0) -> float:
    """Exponential backoff with jitter for restart ``attempt`` (1-based):
    ``min(cap, base * 2**(attempt-1))`` scaled by uniform(0.5, 1.0), so
    simultaneous restarting drivers don't stampede a recovering service."""
    d = min(float(cap), float(base) * (2.0 ** max(0, attempt - 1)))
    return d * random.uniform(0.5, 1.0)


class RestartBudget:
    """Sliding-window restart budget: at most ``max_restarts`` restarts in
    any ``window_secs`` span.  A crash loop that respects per-attempt
    limits can still burn quota forever; the window bounds the *rate*."""

    def __init__(self, max_restarts: int, window_secs: float):
        self.max_restarts = int(max_restarts)
        self.window_secs = float(window_secs)
        self._times: deque[float] = deque()

    def allow(self, now: float | None = None) -> bool:
        """Record a restart at ``now``; False once the window overflows."""
        now = time.monotonic() if now is None else now
        self._times.append(now)
        while self._times and now - self._times[0] > self.window_secs:
            self._times.popleft()
        return len(self._times) <= self.max_restarts
