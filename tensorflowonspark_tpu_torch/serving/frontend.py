"""Online serving frontend: the TCP edge + the cluster composition.

Port of ``tensorflowonspark_tpu/serving/frontend.py``.  The tier, its
edge, membership, warm standbys, drain-and-replace, the autoscaler, the
model registry with hot swaps and rollouts, disaggregated prefill/decode
pools, the control-plane journal and the driver crash are the JAX
package's; the replicas' batchers run on the card (``run(device=None)``)
or, when asked, on the CPU.  Mesh-sharded gangs (``mesh``, ``gang_size``,
``shard_params``) run GPT over ``tp``, every rank of a gang stepping its own
shards (``serving/sharded.py``); a gang with warm standbys or disaggregated
pools raises ``NotImplementedError`` (ROADMAP A6 part 2, item 8).

:class:`ServeFrontend` is the process boundary of the serving tier: it
listens on a TCP port, authenticates clients with the same mutual-HMAC
authkey handshake the rest of the stack uses
(:class:`~tensorflowonspark_tpu_torch.reservation.MessageSocket`), and turns
each ``generate`` op into a :meth:`ReplicaScheduler.submit` — typed
load-shed rejections and deadline expiries travel back as ``("ERR",
reason, message)`` frames, streamed tokens as ``("TOK", [deltas])``.

:class:`ServingCluster` composes the whole tier::

    serving = ServingCluster.run(model_builder, num_replicas=2,
                                 max_batch=4, eos_id=50256)
    client = serving.client()
    tokens = client.generate(prompt, max_new_tokens=64)
    for delta in client.generate_stream(prompt, 64):
        ...
    serving.shutdown()

Wiring (docs/serving.md has the picture):

- replicas are ordinary cluster workers running
  :func:`~tensorflowonspark_tpu_torch.serving.replica.serve_replica`
  (``TPUCluster.run`` with ``InputMode.SPARK``), so bootstrap,
  reservation, heartbeats, crash files and shutdown all reuse the
  training-path machinery;
- the cluster's fail-fast monitor is replaced by a serving-mode
  :class:`~tensorflowonspark_tpu_torch.health.ClusterMonitor`
  (``abort_on_failure=False, keep_polling=True``) whose classified
  failures feed :meth:`ReplicaScheduler.on_cluster_failure` — a replica
  death triggers failover, not teardown;
- ``shutdown`` drains the scheduler, stops the edge, then runs the
  normal cluster shutdown; worker exits caused by replica deaths the
  scheduler already failed over are tolerated (they were *handled*, and
  every accepted request completed or got a typed error), anything else
  re-raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import logging
import os
import queue
import socket
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as tpu_metrics
from tensorflowonspark_tpu_torch import observability
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster
from tensorflowonspark_tpu_torch.health import PREEMPTION, ClusterMonitor
from tensorflowonspark_tpu_torch.marker import EndOfFeed
from tensorflowonspark_tpu_torch.reservation import (FrameFormatError,
                                               MessageSocket, _peer_name)
from tensorflowonspark_tpu_torch.serving.scheduler import (REQUEST_QUEUE,
                                                     ReplicaScheduler,
                                                     RequestRejected,
                                                     ServingError)

logger = logging.getLogger(__name__)


class ServeFrontend(MessageSocket):
    """TCP edge of the serving tier (one thread per client connection).

    Client protocol (after the authkey handshake), all frames pickled
    through the shared ``MessageSocket`` wire format:

    - ``{"op": "generate", "prompt", "max_new_tokens", "temperature",
      "top_p", "seed", "stream", "timeout"}`` → a sequence of
      ``("TOK", [tokens])`` frames (``stream=True`` only) terminated by
      ``("DONE", payload)`` — payload is the full generated token array
      for ``stream=False``, the total token count for streams — or
      ``("ERR", reason, message)``;
    - ``{"op": "stats"}`` → ``("OK", metrics_dict)``;
    - ``{"op": "ping"}`` → ``"OK"``;
    - ``{"op": "resume", "trace", "received", "stream", "timeout"}`` →
      the tail of a replayed stream after a DRIVER failover
      (docs/robustness.md "Control-plane failover"): the client names
      the trace it was streaming and how many tokens it already holds,
      and the resumed frontend replays the rest exactly.
    """

    def __init__(self, scheduler: ReplicaScheduler, authkey: bytes,
                 mode: str = "local", default_timeout: float = 600.0,
                 port: int = 0):
        self.scheduler = scheduler
        self.authkey = bytes(authkey)
        self.mode = mode
        self.default_timeout = float(default_timeout)
        self._port = int(port)
        self.done = threading.Event()
        self._listener: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.connections = 0
        #: trace -> replayed ServeRequest a driver failover re-queued
        #: (``serving.failover.resume_driver`` wires these); claimed
        #: one-shot by the first resume naming the trace
        self.resumed: dict = {}
        #: trace -> token count of requests whose commit landed just
        #: before the crash — the client may only be missing DONE
        self.resumed_done: dict = {}
        self._m_ops = tpu_metrics.get_registry().counter(
            "tfos_frontend_requests_total",
            "Frontend operations received, by op.", labelnames=("op",))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> tuple[str, int]:
        host = "127.0.0.1" if self.mode == "local" else "0.0.0.0"
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # port != 0: a RESUMED driver rebinds the crashed frontend's
        # address so riding-through clients reconnect where they were.
        # SO_REUSEADDR only exempts TIME_WAIT — the crashed frontend's
        # accepted conns linger in FIN_WAIT/CLOSE_WAIT for a moment, so
        # the rebind retries while they drain (clients are in their own
        # failover_wait backoff anyway)
        deadline = time.monotonic() + 15.0
        while True:
            try:
                self._listener.bind((host, self._port))
                break
            except OSError as e:
                if (self._port == 0 or e.errno != errno.EADDRINUSE
                        or time.monotonic() > deadline):
                    raise
                time.sleep(0.2)
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, name="serve-frontend",
                         daemon=True).start()
        from tensorflowonspark_tpu_torch.reservation import get_ip_address

        self.addr = ("127.0.0.1" if self.mode == "local"
                     else get_ip_address(), self.port)
        logger.info("serving frontend listening at %s", self.addr)
        return self.addr

    def stop(self) -> None:
        self.done.set()
        if self._listener is not None:
            # shut the listener down before closing it: a close alone does
            # not wake the accept thread blocked on it, and the socket then
            # stays LISTENing — a resumed driver could not rebind its port
            # until some client happened to connect
            with contextlib.suppress(OSError):
                self._listener.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                self._listener.close()
        # close established connections too: their threads block in
        # receive() and would otherwise linger past the tier's life
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            with contextlib.suppress(OSError):
                conn.close()

    # -- serving -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self.done.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            self.connections += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            nonce = self.auth_challenge(conn)
            if not self.auth_verify(conn, self.authkey, nonce):
                return
            while not self.done.is_set():
                msg = self.receive(conn)
                op = msg.get("op") if isinstance(msg, dict) else None
                # label only the known op set — a client-controlled label
                # value must not mint unbounded counter series
                self._m_ops.inc(op=op if op in ("generate", "stats",
                                                "ping", "resume")
                                else "other")
                if op == "generate":
                    self._handle_generate(conn, msg)
                elif op == "resume":
                    self._handle_resume(conn, msg)
                elif op == "stats":
                    self.send(conn, ("OK", self.scheduler.metrics()))
                elif op == "ping":
                    self.send(conn, "OK")
                else:
                    self.send(conn, ("ERR", "bad_request",
                                     f"unknown op {op!r}"))
        except FrameFormatError as e:
            logger.error("dropping serve peer %s: %s", _peer_name(conn), e)
        except (EOFError, OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            with contextlib.suppress(OSError):
                conn.close()

    def _handle_generate(self, conn: socket.socket, msg: dict) -> None:
        stream = bool(msg.get("stream"))
        # clients send an explicit "timeout": None for "no deadline asked";
        # the tier's default_timeout must still apply then, or a saturated
        # tier would hold this connection thread forever
        timeout = msg.get("timeout")
        if timeout is None:
            timeout = self.default_timeout
        try:
            # the edge stamps the trace id (honoring a client-supplied
            # one): every downstream event for this request carries it
            req = self.scheduler.submit(
                msg["prompt"], int(msg["max_new_tokens"]),
                temperature=float(msg.get("temperature", 0.0)),
                top_p=float(msg.get("top_p", 1.0)),
                seed=int(msg.get("seed", 0)), timeout=timeout,
                trace=msg.get("trace"),
                tenant=str(msg.get("tenant") or "default"),
                priority=msg.get("priority"),
                model=msg.get("model"))
        except (RequestRejected, ServingError) as e:
            self.send(conn, ("ERR", getattr(e, "reason", "rejected"), str(e)))
            return
        except (ValueError, TypeError, KeyError) as e:
            self.send(conn, ("ERR", "bad_request", str(e)))
            return
        self._pump_request(conn, req, stream)

    def _pump_request(self, conn: socket.socket, req, stream: bool,
                      skip: int = 0) -> None:
        """Drain ``req``'s event queue onto ``conn`` until terminal.

        ``skip`` suppresses the first N generated tokens — the RESUME
        path's dedup cut: a replayed request's queue carries the whole
        stream from token 0, and the reconnecting client already holds
        ``skip`` of them.  The cut lives here, frontend-side, so the
        scheduler's replay never races who reconnects when.
        """
        try:
            while True:
                remaining = (None if req.deadline is None
                             else req.deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self.scheduler.abandon(req)
                    self.send(conn, ("ERR", "deadline",
                                     "deadline exceeded mid-request"))
                    return
                try:
                    ev = req.events.get(timeout=remaining)
                except queue.Empty:
                    continue        # loop re-checks remaining (<= 0 now)
                if ev[0] == "tok":
                    toks = ev[1]
                    if skip:
                        cut = min(skip, len(toks))
                        skip -= cut
                        toks = toks[cut:]
                    if stream and toks:
                        self.send(conn, ("TOK", toks))
                elif ev[0] == "done":
                    self.send(conn, ("DONE",
                                     ev[1] if stream
                                     else np.asarray(req.tokens, np.int32)))
                    return
                else:  # ("err", reason, message)
                    self.send(conn, ("ERR", ev[1], ev[2]))
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-request: stop tracking so replica
            # output for it is dropped instead of queuing forever
            self.scheduler.abandon(req, reason="disconnect")
            raise

    def _handle_resume(self, conn: socket.socket, msg: dict) -> None:
        """Re-attach a client that lost its stream to a driver crash
        (docs/robustness.md "Control-plane failover").  The client names
        its trace plus how many tokens it already holds; a replayed
        request's queue carries the WHOLE stream from token 0, so the
        dedup cut happens here in :meth:`_pump_request`."""
        trace = msg.get("trace")
        received = max(0, int(msg.get("received") or 0))
        stream = bool(msg.get("stream"))
        req = self.resumed.pop(trace, None) if trace else None
        if req is None:
            done = self.resumed_done.get(trace) if trace else None
            if done is not None and stream and received >= int(done):
                # the commit landed just before the kill: the client
                # already holds every token, only DONE was lost
                self.send(conn, ("DONE", int(done)))
                return
            # non-stream clients (received == 0) land here too even when
            # committed: the journal holds token COUNTS, not values —
            # the client's resume fallback re-submits the original
            # generate, and determinism recomputes the same stream
            self.send(conn, ("ERR", "unknown_request",
                             f"no replayed request for trace {trace!r}"))
            return
        timeout = msg.get("timeout")
        if timeout is None:
            timeout = self.default_timeout
        # the journal carries no wall-clock deadlines (they died with the
        # old driver): re-bound the wait from re-attach time
        req.deadline = time.monotonic() + float(timeout)
        self._pump_request(conn, req, stream, skip=received)


class ServingCluster:
    """A running online-serving tier: cluster + monitor + scheduler +
    frontend, shut down as one unit (see module docstring)."""

    def __init__(self, cluster: TPUCluster, scheduler: ReplicaScheduler,
                 monitor: ClusterMonitor | None, frontend: ServeFrontend,
                 address: tuple[str, int]):
        self.cluster = cluster
        self.scheduler = scheduler
        self.monitor = monitor
        self.frontend = frontend
        self.address = address
        self.metrics_http = None
        #: ``(host, port)`` of the /metrics + /statusz endpoint, or None
        self.metrics_address: tuple[str, int] | None = None
        #: the running :class:`~tensorflowonspark_tpu_torch.serving.autoscaler.
        #: Autoscaler`, when ``run(autoscale=...)`` asked for one
        self.autoscaler = None
        #: per-pool autoscalers of a disaggregated tier (one per role,
        #: independent signals/bounds/cooldowns); empty otherwise
        self.autoscalers: list = []
        #: the :class:`~tensorflowonspark_tpu_torch.serving.rollout.
        #: ModelRegistry` of a multi-model tier (``run(registry=)``),
        #: else None — ``deploy_model``/``swap_replica_model``/
        #: ``rollout`` resolve version payloads through it
        self.registry = None
        #: the founding ``(model_id, version)`` label (``run(model=)``):
        #: model-less spawns on a multi-model tier (the autoscaler's
        #: ``scale_up(n)``) inherit it — an UNLABELED replica would
        #: match every model's routing while serving only these weights
        self._default_model: tuple | None = None
        #: the normalized ``disagg=`` spec when this tier runs
        #: specialized prefill/decode pools, else None
        self.disagg = None
        self._shutdown_done = False
        self._replace_preempted = True
        self._drain_timeout = 60.0
        self._membership_lock = threading.Lock()
        self._replaced: set[int] = set()  # preempted eids already replaced
        #: the tier's :class:`~tensorflowonspark_tpu_torch.serving.sharded.
        #: GangSpec` when replicas are mesh-sharded gangs, else None
        self.gang_spec = None
        self._reaped: set[int] = set()    # gang leaders already reaped
        #: the warm-standby pool (:class:`~tensorflowonspark_tpu_torch.serving.
        #: standby.StandbyPool`) when ``run(warm_standbys=N)``, else None
        self.standbys = None
        #: the tier's write-ahead :class:`~tensorflowonspark_tpu_torch.serving.
        #: journal.ControlPlaneJournal` when the cluster has a
        #: working_dir (``<working_dir>/control_plane.jsonl``), else None
        self.journal = None
        #: armed driver-scope chaos (``TFOS_CHAOS="kill driver ..."``)
        self._driver_chaos = None
        #: the folded :class:`~tensorflowonspark_tpu_torch.serving.journal.
        #: JournalState` a resumed tier was rebuilt from
        #: (``serving.failover.resume_driver``), else None
        self.resume_state = None
        self._serve_args: dict = {}       # standbys re-use the args
        self._standby_clone = True
        self._replace_failed = False
        #: promoted standby -> (decision monotonic, source,
        #: ready event) until its ``standby_ready`` ack closes the heal
        #: measurement — the event also gates the pool's deferred
        #: backfill (heal first, restock second).  Own leaf lock (never
        #: wraps scheduler/membership calls): the ack path reads it
        #: UNDER the scheduler lock
        self._promotions: dict[int, tuple] = {}
        self._promotions_lock = threading.Lock()
        self._promoted: dict[str, int] = {}   # source -> promotions
        #: decision-to-restored-capacity latencies of warm promotions
        self.heal = observability.LatencyHistogram()
        reg = tpu_metrics.get_registry()
        self._m_promotions = reg.counter(
            "tfos_serving_promotions_total",
            "Warm-standby promotions by trigger "
            "(failure/preemption/scale_up).", labelnames=("source",))
        self._h_heal = reg.histogram(
            "tfos_serving_heal_seconds",
            "Heal-decision to restored-capacity latency of warm "
            "promotions (standby_ready ack).")

    # ------------------------------------------------------------------ run
    @classmethod
    def run(cls, model_builder, num_replicas: int, *, max_batch: int = 4,
            eos_id: int | None = None, batcher_kwargs: dict | None = None,
            replica_args: dict | None = None, overcommit: int = 2,
            max_queue_depth: int | None = None, requeue_limit: int = 1,
            hang_timeout: float = 120.0, step_timeout: float | None = None,
            monitor: bool = True, frontend_mode: str = "local",
            client_timeout: float = 600.0,
            metrics_port: int | None = 0, tenants: dict | None = None,
            autoscale=None, replace_preempted: bool = True,
            replace_failed: bool = False,
            drain_timeout: float = 60.0, mesh: dict | None = None,
            gang_size: int | None = None, shard_params=None,
            warm_standbys: int = 0, standby_clone: bool = True,
            compile_cache=None, aot_cache=None, draft_model=None,
            disagg: dict | None = None,
            model: tuple | None = None, registry=None, device=None,
            **cluster_kwargs) -> "ServingCluster":
        """Boot ``num_replicas`` serving workers and the driver-side tier.

        ``model_builder(args) -> (cfg, params)`` must be a picklable
        top-level callable (it runs inside each worker process).
        ``cluster_kwargs`` pass through to :meth:`TPUCluster.run`
        (``backend=``, ``worker_env=``, ``working_dir=``, ``queue_shm=``,
        ``queue_depth=``, ``reservation_timeout=``...).

        ``metrics_port`` binds the Prometheus ``/metrics`` + JSON
        ``/statusz`` endpoint next to the frontend (0 = an ephemeral
        port, surfaced as ``serving.metrics_address``; ``None``
        disables it).

        ``tenants`` configures per-tenant admission (token buckets +
        priority classes — see :class:`~tensorflowonspark_tpu_torch.serving.
        scheduler.ReplicaScheduler`); ``autoscale`` (a dict of
        :class:`~tensorflowonspark_tpu_torch.serving.autoscaler.
        AutoscalerConfig` knobs, or a config instance) starts a
        metrics-driven autoscaler over the tier.  With
        ``replace_preempted`` (default), a replica whose host is
        reclaimed (SIGTERM / heartbeat phase ``preempted``) is drained
        and REPLACED instead of counting as a failure.

        ``mesh`` turns every replica into a MESH-SHARDED GANG
        (docs/serving.md "Sharded replicas"): an axis-name → size dict
        (e.g. ``{"tp": 2}``) giving each replica's device mesh.  The
        tier then boots ``num_replicas x gang_size`` workers (gang_size
        defaults to the mesh's device count, one process a device)
        running :func:`~tensorflowonspark_tpu_torch.serving.sharded.
        serve_sharded_replica`; each gang is ONE routable endpoint with
        capacity weight = its device count, and add/retire/failover
        operate on whole gangs.  ``shard_params`` optionally overrides
        the parameter layout (a picklable ``(cfg, params, mesh) ->
        params`` giving this rank's shards; default: GPT's Megatron
        rules over ``tp``).  The port's gangs shard over ``tp`` only, run
        eagerly (no ``aot_cache``: a CUDA graph cannot capture their gloo
        collectives), and take neither ``warm_standbys`` nor ``disagg``
        (ROADMAP A6 part 2, item 8).

        ``disagg`` specializes the tier into DISAGGREGATED PREFILL/
        DECODE POOLS (docs/serving.md "Disaggregated prefill/decode"):
        ``{"prefill": P, "decode": D}`` boots P prefill gangs (compute
        the prompt KV once, never decode-step) and D decode gangs (only
        ever step), with each session handed off as a verified KV-page
        transfer on the queue/shm plane.  ``num_replicas`` must equal
        ``P + D``; ``batcher_kwargs`` must set ``kv_page_tokens`` (the
        handoff is page-granular); optional ``"prefill_kwargs"`` /
        ``"decode_kwargs"`` entries overlay per-pool batcher knobs
        (e.g. ``prefill_chunk`` for the prefill pool's streaming
        admission).  With ``autoscale={"prefill": {...}, "decode":
        {...}}`` each pool gets its own independent autoscaler —
        TTFT-p95/queue pressure drives prefill, handoff-queue depth
        drives decode.  Composes with ``aot_cache`` (a captured decode
        batcher seats an adopted session's pages in its pool in place)
        and with ``warm_standbys``: standbys are built
        ROLE-LESS (one spare fleet backs both specializations) and
        specialize at promotion — the promote control message carries
        the target pool's role, the standby flips its engine
        (``ContinuousBatcher.set_role``) and registers into that pool
        (promote-with-role).

        ``warm_standbys`` keeps N fully-initialized spare replicas
        (process up, serve steps run — captured, with ``aot_cache`` —
        params UNLOADED,
        heartbeat phase ``standby``) that heal paths PROMOTE instead of
        cold-spawning — replica deaths, preemption drain-and-replace,
        and autoscaler scale-ups all consume the pool first, and the
        pool backfills itself in the background (docs/robustness.md
        "Warm standbys").  ``standby_clone`` (default) lets a promoted
        standby pull weights from a live peer replica over the queue/shm
        data plane instead of re-running the model builder (the
        checkpoint-restore fallback).  ``replace_failed`` spawns a
        replacement for CRASH/HANG deaths too (cold when no pool), so
        the tier never shrinks by failure; with a warm pool, crash heals
        promote regardless.  ``compile_cache`` has no counterpart here
        and raises if given: the JAX package's fleet-wide persistent XLA
        cache saves compiles, and eager PyTorch compiles nothing.

        ``aot_cache`` arms the tier's compile-site cache
        (``serving/aot.py``): every replica and warm standby captures
        each serve-step site as a CUDA graph at its first call (a warm
        standby in its warm-up sweep, ahead of traffic) and replays it
        after (``True``; nothing is written to disk: a graph cannot be
        serialized).  A hot swap copies the new version's weights into
        the storage the graphs read (``ContinuousBatcher.load_params``).

        ``device`` is where the replicas' batchers run: None means the
        card (a worker without one raises), ``"cpu"`` the CPU.

        ``draft_model`` arms DRAFT-MODEL SPECULATIVE DECODING on every
        decode-capable replica: a picklable ``builder(args) -> (cfg,
        params)`` for the small draft, or a registered ``(model_id,
        version)`` tuple (needs ``registry=``; adapter-or-full, like any
        version).  Each decode step then runs one draft forward
        proposing ``serve_draft_k`` (replica_args; default 4) tokens per
        eligible greedy row and one verify call on the target
        — output-exact by construction (the verify only commits tokens
        the target's own argmax agrees with; sampled rows keep the
        single-token path).  Tune via ``replica_args``:
        ``serve_draft_window`` (draft context, default 64),
        ``serve_draft_k``.  The draft vocab must match the target's
        (validated at boot, typed).  Hot swaps re-resolve the draft from
        the incoming version's ``serve_args`` — a version without draft
        keys clears it.
        """
        from tensorflowonspark_tpu_torch.serving.replica import serve_replica

        if mesh is not None and (warm_standbys or disagg is not None):
            raise NotImplementedError(
                "ServingCluster.run(mesh=...) with "
                f"{'warm_standbys' if warm_standbys else 'disagg'}=...: gangs with warm "
                "standbys and with disaggregated pools are not ported yet "
                "(ROADMAP A6 part 2, item 8)")
        if mesh is not None and aot_cache:
            raise ValueError(
                "ServingCluster.run(mesh=..., aot_cache=True): a gang's batchers run "
                "eagerly — a CUDA graph cannot capture their gloo collectives")
        if compile_cache is not None:
            raise ValueError(
                "compile_cache has no counterpart in the port: eager PyTorch compiles "
                "nothing to cache (aot_cache= captures the serve steps as CUDA graphs)")
        args = dict(replica_args or {})
        args.update({
            "serve_model_builder": model_builder,
            "serve_max_batch": int(max_batch),
            "serve_eos_id": eos_id,
            "serve_batcher_kwargs": dict(batcher_kwargs or {}),
            "serve_device": None if device is None else str(device),
        })
        if model is not None:
            # multi-model tier (docs/serving.md "Multi-model serving &
            # live rollout"): the founding replicas are labeled with the
            # (model_id, version) they serve; with a registry the
            # version's registered builder + serve_args overlay applies
            # (an explicit model_builder wins), and the incumbent needs
            # no eval gate — it IS the baseline later versions gate
            # against
            model = (str(model[0]), str(model[1]))
            if registry is not None:
                if model_builder is not None:
                    # ONE source of truth: every later payload path
                    # (deploy/heal/promote/swap) ships the REGISTRY
                    # entry's builder — a second, different founding
                    # builder here would resurface on the first heal or
                    # rollback as silently different weights under the
                    # same label
                    raise ValueError(
                        "ambiguous founding builder: the registered "
                        f"{model[0]}@{model[1]} entry is the builder of "
                        "record — pass model_builder=None (register "
                        "your builder in the entry instead)")
                args.update(registry.version(*model).serve_args())
        if args.get("serve_model_builder") is None:
            raise ValueError(
                "no model builder: pass model_builder=, or registry= + "
                "model= naming a registered version")
        if aot_cache:
            args["serve_aot_cache"] = True
        if draft_model is not None:
            if isinstance(draft_model, tuple):
                if registry is None:
                    raise ValueError(
                        "draft_model=(model_id, version) needs registry= "
                        "— or pass the draft's builder callable directly")
                from tensorflowonspark_tpu_torch.serving.rollout import \
                    draft_overlay

                args.update(draft_overlay(registry.version(*draft_model)))
            elif callable(draft_model):
                args["serve_draft_builder"] = draft_model
            else:
                raise ValueError(
                    "draft_model must be a builder callable or a "
                    "registered (model_id, version) tuple, got "
                    f"{type(draft_model).__name__}")
        if warm_standbys < 0:
            raise ValueError(f"warm_standbys must be >= 0, "
                             f"got {warm_standbys}")
        map_fun, num_workers = serve_replica, num_replicas
        gang = None
        if mesh is not None:
            from tensorflowonspark_tpu_torch.serving.sharded import (
                GangSpec, check_servable, serve_sharded_replica)

            gang = GangSpec(axes=dict(mesh), gang_size=gang_size)
            check_servable(gang)
            args["serve_mesh"] = dict(gang.axes)
            args["serve_gang_size"] = gang.gang_size
            if shard_params is not None:
                args["serve_shard_params"] = shard_params
            map_fun = serve_sharded_replica
            num_workers = num_replicas * gang.gang_size
        elif gang_size is not None or shard_params is not None:
            raise ValueError("gang_size=/shard_params= need mesh= "
                             "(sharded replicas)")
        roles = None
        if disagg is not None:
            from tensorflowonspark_tpu_torch.serving.disagg import (
                boot_roles, serve_disagg_replica, validate_disagg)

            disagg = validate_disagg(disagg)
            if num_replicas != disagg["prefill"] + disagg["decode"]:
                raise ValueError(
                    f"disagg pools sum to "
                    f"{disagg['prefill'] + disagg['decode']} gangs but "
                    f"num_replicas={num_replicas} — pass their sum")
            if (batcher_kwargs or {}).get("kv_page_tokens") is None:
                raise ValueError(
                    "disagg needs paged KV: set batcher_kwargs="
                    "{'kv_page_tokens': ...} — the prefill→decode "
                    "handoff is a KV-page transfer")
            if warm_standbys:
                # a standby's engine is built from the BASE kwargs and
                # must be able to set_role() into EITHER pool at
                # promotion; decode-only knobs in the base would make
                # every prefill promotion crash the standby AFTER the
                # driver registered it — fail here, at boot, instead
                bad = [k for k in ("speculative_k", "decode_block_steps")
                       if (batcher_kwargs or {}).get(k) is not None]
                if bad:
                    raise ValueError(
                        f"disagg with warm_standbys: {bad} must live in "
                        "disagg['decode_kwargs'], not the base "
                        "batcher_kwargs — a role-less standby built "
                        "with them cannot specialize into a prefill "
                        "pool at promotion")
            args["serve_disagg"] = disagg
            roles = boot_roles(disagg)
            map_fun = serve_disagg_replica
        # monitor=False: the training monitor's fail-fast abort is the
        # wrong policy here — a serving-mode monitor is attached below
        cluster = TPUCluster.run(map_fun, args, num_workers,
                                 input_mode=InputMode.SPARK, monitor=False,
                                 **cluster_kwargs)
        scheduler = mon = frontend = tier = journal = None
        try:
            wd = getattr(cluster, "working_dir", None)
            if wd:
                # the write-ahead control-plane journal: every accept/
                # route/commit/membership/rollout transition fsync'd
                # before it takes effect, so a driver death replays to
                # a zero-loss resume (docs/robustness.md "Control-plane
                # failover"); no working_dir = nowhere durable to put it
                from tensorflowonspark_tpu_torch.serving.journal import \
                    ControlPlaneJournal

                journal = ControlPlaneJournal(
                    os.path.join(wd, "control_plane.jsonl"))
            scheduler = ReplicaScheduler(
                cluster, slots_per_replica=max_batch, overcommit=overcommit,
                max_queue_depth=max_queue_depth, requeue_limit=requeue_limit,
                tenants=tenants,
                gang_size=1 if gang is None else gang.gang_size,
                roles=roles, model=model, journal=journal)
            if monitor:
                mon = ClusterMonitor(
                    cluster, hang_timeout=hang_timeout,
                    step_timeout=step_timeout, abort_on_failure=False,
                    keep_polling=True,
                    on_failure=scheduler.on_cluster_failure)
                mon.start()
            scheduler.start()
            frontend = ServeFrontend(
                scheduler, authkey=cluster.cluster_meta["authkey"],
                mode=frontend_mode, default_timeout=client_timeout)
            address = frontend.start()
            tier = cls(cluster, scheduler, mon, frontend, address)
            tier.disagg = disagg
            tier.gang_spec = gang
            tier.registry = registry
            tier.journal = journal
            tier._default_model = model
            if registry is not None and journal is not None:
                # bind BEFORE the founding mark: the journal snapshot
                # of pre-boot registrations/evals plus every later
                # mutation is what a resumed driver re-folds
                registry.bind_journal(journal)
            if registry is not None and model is not None:
                registry.mark(*model, "serving")
            tier._replace_preempted = bool(replace_preempted)
            tier._replace_failed = bool(replace_failed)
            if warm_standbys or replace_failed or replace_preempted:
                # this tier HEALS lost gangs: when a pool's last acceptor
                # dies, dispatch holds its requeued work briefly (until
                # the heal's expect_replica announcement, or this bound)
                # instead of shedding it sub-second as no_replica
                scheduler.heal_grace = 30.0
            tier._drain_timeout = float(drain_timeout)
            tier._serve_args = args
            tier._standby_clone = bool(standby_clone)
            scheduler.on_replica_ready = tier._on_standby_ready
            if mon is not None:
                # re-point the monitor's hooks at the tier: classified
                # failures still retire replicas in the scheduler, but
                # preemptions (exit-shape OR live grace-window phase
                # flips) now ALSO drive drain-and-replace
                mon.on_failure = tier._on_cluster_failure
                mon.on_phase = tier._on_phase
            if warm_standbys:
                from tensorflowonspark_tpu_torch.serving.standby import \
                    StandbyPool

                # pool before the autoscaler: its first scale-up must
                # already see promotable standbys
                tier.standbys = StandbyPool(tier, int(warm_standbys))
                tier.standbys.fill()
            if autoscale is not None:
                from tensorflowonspark_tpu_torch.serving.autoscaler import (
                    Autoscaler, AutoscalerConfig)

                if disagg is not None:
                    # one independent controller per pool: prefill
                    # scales on prompt-queue/TTFT pressure, decode on
                    # handoff-queue/outstanding pressure
                    if not (isinstance(autoscale, dict)
                            and set(autoscale) <= {"prefill", "decode"}
                            and autoscale):
                        raise ValueError(
                            "a disagg tier autoscales per pool: pass "
                            "autoscale={'prefill': {...}, 'decode': "
                            "{...}} (either subset)")
                    for role, spec in autoscale.items():
                        cfg = (spec if isinstance(spec, AutoscalerConfig)
                               else AutoscalerConfig(**dict(spec)))
                        cfg = dataclasses.replace(cfg, role=role)
                        tier.autoscalers.append(
                            Autoscaler(tier, cfg).start())
                else:
                    cfg = (autoscale
                           if isinstance(autoscale, AutoscalerConfig)
                           else AutoscalerConfig(**dict(autoscale)))
                    tier.autoscaler = Autoscaler(tier, cfg).start()
            if metrics_port is not None:
                tier.metrics_http = tpu_metrics.MetricsHTTPServer(
                    tier.metrics_text, statusz=tier.metrics,
                    host="127.0.0.1" if frontend_mode == "local"
                    else "0.0.0.0", port=metrics_port)
                bound = tier.metrics_http.start()
                # surface a connectable address, not the wildcard bind:
                # remote mode advertises the same host the frontend does
                tier.metrics_address = (
                    (address[0], bound[1]) if bound[0] == "0.0.0.0"
                    else bound)
            # driver-scope chaos (TFOS_CHAOS="kill driver after_secs=F"):
            # armed LAST, once the tier is fully live — firing calls
            # tier.crash(), the in-process equivalent of SIGKILLing a
            # standalone driver (docs/robustness.md)
            from tensorflowonspark_tpu_torch import chaos as tfos_chaos

            tier._driver_chaos = tfos_chaos.driver_from_env(
                on_fire=lambda action: tier.crash(), state_dir=wd)
            if tier._driver_chaos is not None:
                tier._driver_chaos.start()
        except Exception:
            # a late failure (e.g. the metrics port is taken) must tear
            # down everything already live: the autoscaler's control
            # thread, the frontend's accept thread and bound port, the
            # scheduler's threads AND its registry collect hook
            # (scheduler.stop unhooks it), the monitor
            autoscaler = tier.autoscaler if tier is not None else None
            autoscalers = tier.autoscalers if tier is not None else []
            standbys = tier.standbys if tier is not None else None
            for part in (autoscaler, *autoscalers, standbys, frontend,
                         scheduler, mon):
                if part is not None:
                    with contextlib.suppress(Exception):
                        part.stop()
            if journal is not None:
                with contextlib.suppress(Exception):
                    journal.close()
            cluster._abort()
            raise
        return tier

    # -------------------------------------------------------------- clients
    @property
    def authkey(self) -> bytes:
        return self.cluster.cluster_meta["authkey"]

    def client(self, **kwargs):
        """A connected :class:`~tensorflowonspark_tpu_torch.serving.client.
        ServeClient` for this tier (one per concurrent request stream)."""
        from tensorflowonspark_tpu_torch.serving.client import ServeClient

        return ServeClient(self.address, self.authkey, **kwargs)

    # ----------------------------------------------------- live membership
    def add_replicas(self, n: int = 1, timeout: float | None = None,
                     role: str | None = None,
                     model: tuple | None = None) -> list[int]:
        """Grow the tier by ``n`` replicas, live: the cluster re-opens
        its reservation path and spawns fresh serving workers (same
        model builder/args the tier booted with), the scheduler
        registers each as it reserves, and queued requests start
        dispatching to the newcomers immediately.  With mesh-sharded
        replicas each added replica is a WHOLE GANG (``gang_size``
        workers, one routable endpoint).  A disaggregated tier grows
        one POOL at a time: ``role`` ("prefill" | "decode") pins the
        newcomers' specialization (mandatory — eid arithmetic cannot
        classify late joiners).  ``model`` spawns the newcomers with
        that registered ``(model_id, version)``'s builder/args and
        labels them for model-routed dispatch (multi-model tiers;
        re-armed heals pass the dead gang's own model).  Returns the
        new replicas' leader executor ids."""
        if self._shutdown_done:
            raise RuntimeError("serving tier is shut down")
        gsz = 1 if self.gang_spec is None else self.gang_spec.gang_size
        if (role is not None) != (self.disagg is not None):
            raise ValueError(
                "add_replicas(role=) and a disagg tier go together: "
                f"role={role!r} on a tier with disagg={self.disagg!r}")
        if model is None:
            # a model-less spawn on a labeled tier (the autoscaler's
            # scale path) serves the FOUNDING builder — label it so, or
            # the unlabeled newcomer would match EVERY model's routing
            # while holding only the founding weights
            model = self._default_model
        tf_args = None
        if model is not None:
            model = (str(model[0]), str(model[1]))
            if model != self._default_model:
                if self.registry is None:
                    # no registry = no builder for another model: the
                    # newcomer would carry the FOUNDING weights under
                    # this label and serve the wrong model silently
                    raise ValueError(
                        f"add_replicas(model={model!r}) needs a "
                        "ModelRegistry (ServingCluster.run(registry=)) "
                        "— without one the spawn would serve the "
                        "founding weights under this label")
                tf_args = dict(self._serve_args)
                tf_args.update(
                    self.registry.version(*model).serve_args())
            # founding version: the stored boot payload IS its builder/
            # args (run()'s explicit model_builder wins over a registry
            # entry there, and must keep winning on heals/scale-ups)
        spawn_kwargs = {}
        if role is not None:
            from tensorflowonspark_tpu_torch.serving.disagg import \
                serve_disagg_replica

            spawn_kwargs = {"map_fun": serve_disagg_replica,
                            "tf_args": dict(tf_args or self._serve_args,
                                            serve_role=role)}
        elif tf_args is not None:
            spawn_kwargs = {"tf_args": tf_args}
        with self._membership_lock:
            added = self.cluster.add_workers(n * gsz, timeout=timeout,
                                             **spawn_kwargs)
            leaders = []
            for i in range(0, len(added), gsz):
                block = added[i:i + gsz]
                self.scheduler.add_replica(
                    block[0],
                    members=tuple(int(b["executor_id"])
                                  for b in block[1:]), role=role,
                    model=model)
                leaders.append(int(block[0]["executor_id"]))
        if role == "decode":
            # prefix-page donation (docs/serving.md): a fresh decode
            # replica starts with an EMPTY prefix index — pre-warm it
            # from a prefill pool's cache so its first adopts hit instead
            # of importing page data the fleet already holds
            for eid in leaders:
                threading.Thread(target=self.donate_prefix_pages,
                                 args=(eid,),
                                 name=f"prefix-donate-{eid}",
                                 daemon=True).start()
        logger.info("serving tier grew by %d replica(s): %s%s%s%s", n,
                    leaders, f" (gangs of {gsz})" if gsz > 1 else "",
                    f" (role {role})" if role else "",
                    f" (model {model[0]}@{model[1]})" if model else "")
        return leaders

    def scale_up(self, n: int = 1, timeout: float | None = None,
                 source: str = "scale_up",
                 role: str | None = None,
                 model: tuple | None = None) -> list[int]:
        """Grow the tier by ``n`` replicas, consuming the warm-standby
        pool FIRST (promotion: control message + weight clone, capacity
        restored in well under a cold boot) and cold-spawning only the
        remainder through :meth:`add_replicas`.  The autoscaler's
        scale-up path calls this.  On a disaggregated tier ``role``
        (mandatory there) is carried in the promote message — the
        standby specializes its engine at promotion and registers into
        the named pool (promote-with-role; standbys are built role-less
        so ONE pool backs both specializations).  Returns the new
        replicas' executor ids."""
        added: list[int] = []
        for _ in range(int(n)):
            eid = self.promote_standby(source, role=role, model=model)
            if eid is None:
                break
            added.append(eid)
        remaining = int(n) - len(added)
        if remaining:
            added.extend(self.add_replicas(remaining, timeout=timeout,
                                           role=role, model=model))
        return added

    def promote_standby(self, source: str = "scale_up",
                        role: str | None = None,
                        model: tuple | None = None) -> int | None:
        """Promote one warm standby into a routable replica: pop it from
        the pool (atomic — a concurrent failure + scale decision can
        never double-promote the same standby), send it the promote
        control message naming a live CLONE PEER (or None → it restores
        through the model builder), register it with the scheduler, and
        backfill the pool in the background.  On a disaggregated tier
        ``role`` is mandatory (per-role pool accounting: the scheduler
        registers the newcomer into the named prefill/decode pool, and
        the promote message tells the standby which specialization to
        arm).  On a multi-model tier ``model`` RE-ARMS the standby for
        that ``(model_id, version)``: one shared spare pool backs every
        hosted model, the promote message carries the version's builder
        payload, and the clone peer is restricted to replicas serving
        that exact version.  Returns the promoted standby's executor id,
        or None when the pool is empty/absent (callers fall back to a
        cold spawn)."""
        pool = self.standbys
        if pool is None or self._shutdown_done:
            return None
        if (role is not None) != (self.disagg is not None):
            # mismatched call (role on a unified tier / no role on a
            # disagg tier): fall back to the cold path, whose
            # add_replicas raises the explicit error for real misuse —
            # a heal thread must never die on this
            logger.warning("promote_standby(role=%r) on a tier with "
                           "disagg=%r: skipping warm pool", role,
                           self.disagg)
            return None
        if model is None:
            # like add_replicas: a model-less promotion on a labeled
            # tier re-arms the FOUNDING version (the promoted standby
            # restores through the founding builder)
            model = self._default_model
        payload: dict = {}
        adapter_payload = False
        if model is not None:
            model = (str(model[0]), str(model[1]))
            payload = {"model": model[0], "version": model[1]}
            if self.registry is not None:
                payload.update(self.registry.version(*model).swap_payload())
                adapter_payload = payload.get("base_builder") is not None
        got = pool.acquire()
        if got is None:
            return None
        eid, info = got
        # adapter versions promote DELTA-ONLY: the payload already
        # carries the small delta and the standby rebuilds base+delta
        # locally — naming a clone peer would ship the full base over
        # the wire for nothing
        peer = (self.scheduler.peer_replica_info(model=model)
                if self._standby_clone and not adapter_payload else None)
        ready = threading.Event()
        with self._promotions_lock:
            self._promotions[eid] = (time.monotonic(), source, ready)
        # register FIRST: if the promote message were sent and the
        # registration then failed, the standby would clone weights and
        # serve unregistered forever (early-routed requests just queue
        # on its plane until the post-promote serve loop drains them)
        try:
            self.scheduler.add_replica(info, role=role, model=model)
        except Exception:
            # scheduler stopping / registration guard: the caller
            # cold-spawns instead; the pool backfills
            logger.exception("promotion of standby %d failed to "
                             "register", eid)
            with self._promotions_lock:
                self._promotions.pop(eid, None)
            self.scheduler.emit_event("promote_failed", replica=eid,
                                      source=source, role=role)
            pool.backfill_async()
            return None
        try:
            self.cluster._client_for(eid).put(
                REQUEST_QUEUE,
                {"op": "standby", "event": "promote", "source": source,
                 "peer": peer, "role": role, **payload}, timeout=10)
        except Exception:
            # the standby died under us: roll the registration back as
            # a planned departure (anything already routed re-queues
            # without charging its failover budget)
            logger.exception("promotion of standby %d failed", eid)
            with self._promotions_lock:
                self._promotions.pop(eid, None)
            self.scheduler.retire_replica(eid, reason="promote_failed")
            self.scheduler.emit_event("promote_failed", replica=eid,
                                      source=source)
            pool.backfill_async()
            return None
        with self._promotions_lock:
            self._promoted[source] = self._promoted.get(source, 0) + 1
            if role is not None:
                key = f"role:{role}"      # per-role pool accounting
                self._promoted[key] = self._promoted.get(key, 0) + 1
            if model is not None:
                key = f"model:{model[0]}"  # per-model pool accounting:
                # the shared spare fleet's re-arm ledger
                self._promoted[key] = self._promoted.get(key, 0) + 1
        self._m_promotions.inc(source=source)
        self.scheduler.emit_event(
            "standby_promoted", replica=eid, source=source, role=role,
            model=None if model is None else model[0],
            version=None if model is None else model[1],
            peer=None if peer is None else int(peer["executor_id"]))
        logger.info("promoted warm standby %d (source=%s%s%s, "
                    "clone peer %s)",
                    eid, source, "" if role is None else f", role={role}",
                    "" if model is None
                    else f", model={model[0]}@{model[1]}",
                    "none" if peer is None else peer["executor_id"])
        if role == "decode":
            # prefix-page donation: pre-warm the promoted decode replica's
            # prefix index from a prefill pool (the peer clone may have
            # shipped a unified peer's pages; a prefill pool holds the
            # hottest prompt prefixes)
            threading.Thread(target=self.donate_prefix_pages, args=(eid,),
                             name=f"prefix-donate-{eid}",
                             daemon=True).start()

        def _backfill_after_ready():
            # restock AFTER the promotion restores capacity (or a grace
            # timeout): a fresh standby's boot and warm-up must not
            # compete with the heal it was triggered by
            ready.wait(30.0)
            pool.backfill_async()

        threading.Thread(target=_backfill_after_ready,
                         name=f"standby-restock-{eid}",
                         daemon=True).start()
        return eid

    def wait_standbys(self, timeout: float = 120.0) -> bool:
        """Block until every pooled standby is WARM (serve steps
        run, params unloaded, heartbeating phase ``standby``) —
        what a bench/test gates on before injecting the failure it wants
        healed warm.  False on timeout or when no pool/monitor exists."""
        return (self.standbys is not None
                and self.standbys.wait_warm(timeout))

    def _on_standby_ready(self, eid: int) -> dict | None:
        """Scheduler ``on_replica_ready`` hook (runs under the scheduler
        lock — no re-entry): close the heal-time measurement for a
        promotion this tier initiated."""
        with self._promotions_lock:
            rec = self._promotions.pop(eid, None)
        if rec is None:
            return None
        t0, source, ready = rec
        secs = time.monotonic() - t0
        self._h_heal.record(secs)
        self.heal.record(secs)
        ready.set()     # capacity restored: the deferred backfill may go
        return {"heal_secs": round(secs, 6), "promote_source": source}

    def retire_replica(self, executor_id: int,
                       drain_timeout: float | None = None) -> bool:
        """Drain-based scale-down of one replica: stop routing to it,
        wait out its in-flight requests (``drain_timeout``, default the
        tier's), remove it from the scheduler as a CLEAN departure (it
        never shows in ``dead_replicas``), then stop the worker(s) with
        per-worker ``EndOfFeed`` s.  ``executor_id`` may be ANY shard of
        a mesh-sharded gang — the whole gang drains and retires as one
        unit.  Returns True when the drain emptied within the timeout;
        on False the leftovers were re-queued to the survivors
        (exactness preserved by the failover skip-dedup), so zero
        accepted requests are lost either way."""
        eid = self.scheduler.resolve_gang(int(executor_id))
        dt = self._drain_timeout if drain_timeout is None else drain_timeout
        self.scheduler.mark_draining(eid, reason="scale_down")
        drained = self.scheduler.drain_replica(eid, timeout=dt)
        # retire BEFORE EndOfFeed: alive goes False first, so the recv
        # loop sees a planned departure, not a dead response channel
        self.scheduler.retire_replica(
            eid, reason="scale_down" if drained else "drain_timeout")
        self._stop_gang_workers(eid)
        return drained

    def _stop_gang_workers(self, leader_eid: int) -> None:
        """Stop every worker of a replica that LEFT the scheduler
        (retired or dead): per-worker ``EndOfFeed`` (the leader's serve
        loop and the members' step loops both exit on it; puts to an
        already-dead shard are best-effort), monitor retirement so late
        exits are never classified, and cluster retirement so shutdown
        skips the slot.  Idempotent per gang."""
        with self._membership_lock:
            if leader_eid in self._reaped:
                return
            self._reaped.add(leader_eid)
        gang = self.scheduler.gang_members(leader_eid)
        if self.monitor is not None:
            self.monitor.ignore_workers(gang)
        for eid in gang:
            with contextlib.suppress(Exception):
                self.cluster._client_for(eid).put(REQUEST_QUEUE,
                                                  EndOfFeed(), timeout=5)
            self.cluster.retire_worker(eid)

    # ------------------- multi-model hosting & live rollout (docs/
    # serving.md "Multi-model serving & live rollout")
    def deploy_model(self, model_id: str, version: str, *,
                     replicas: int = 1, role: str | None = None,
                     require_eval: bool = True,
                     timeout: float | None = None) -> list[int]:
        """Host an additional registered model on this live tier: spawn
        ``replicas`` fresh gangs built from the version's registry args
        and route ``model=model_id`` traffic to them.  ``require_eval``
        (default) enforces the offline-eval gate
        (:meth:`~tensorflowonspark_tpu_torch.serving.rollout.ModelRegistry.
        promotable`) — a version that never passed its GridSearch eval
        does not reach traffic."""
        if self.registry is None:
            raise RuntimeError("deploy_model needs a ModelRegistry "
                               "(ServingCluster.run(registry=))")
        if self._default_model is None:
            # an UNLABELED founding fleet matches every model's routing
            # (accepts_model), so hosting a second model beside it would
            # let the founding weights serve the new model's traffic
            raise RuntimeError(
                "deploy_model needs a model-labeled tier: boot with "
                "ServingCluster.run(model=(id, version), registry=...) "
                "so the founding gangs are labeled too")
        entry = self.registry.version(model_id, version)
        if require_eval and not self.registry.promotable(model_id,
                                                         version):
            raise RuntimeError(
                f"{model_id}@{version} has not passed its offline eval "
                "(ModelRegistry.evaluate_grid) — deploy_model("
                "require_eval=False) overrides")
        leaders = self.add_replicas(replicas, timeout=timeout, role=role,
                                    model=entry.key)
        self.registry.mark(model_id, version, "serving")
        self.scheduler.emit_event("model_deployed", model=str(model_id),
                                  version=str(version), replicas=leaders)
        return leaders

    def swap_replica_model(self, executor_id: int, model_id: str,
                           version: str,
                           timeout: float | None = None) -> None:
        """HOT-SWAP one replica to another registered version via the
        drain verbs — zero requests lost: stop routing to the replica
        (``mark_draining``), wait out its in-flight streams, ship the
        version payload over the queue/bulk plane (builder/adapter, or
        a peer clone when another replica already serves the version),
        let the replica copy the params into its already-built batcher
        (``ContinuousBatcher.load_params``: a captured batcher's graphs
        read the same storage, so no site is captured again),
        then resume routing under the new ``(model_id, version)`` label.
        Raises on drain timeout, swap failure, or a death mid-swap; a
        failed swap leaves the replica serving its OLD version.  On an
        ACK TIMEOUT a best-effort cancel drops a swap the replica has
        not yet applied; one already applied acks late, and the
        scheduler relabels on that ack — the routing label always
        tracks the version actually served."""
        if self.registry is None:
            raise RuntimeError("swap_replica_model needs a ModelRegistry "
                               "(ServingCluster.run(registry=))")
        if self._default_model is None:
            # same hole deploy_model guards: relabeling one gang beside
            # an UNLABELED founding fleet would let the founding weights
            # serve the new model's traffic (unlabeled matches anything)
            raise RuntimeError(
                "swap_replica_model needs a model-labeled tier: boot "
                "with ServingCluster.run(model=(id, version), "
                "registry=...) so the founding gangs are labeled too")
        if self.gang_spec is not None:
            raise ValueError(
                "in-place model swap supports single-process replicas; "
                "mesh-sharded gangs swap by retire_replica + "
                "deploy_model (the shard layout must be rebuilt)")
        entry = self.registry.version(model_id, version)
        eid = int(executor_id)
        dt = self._drain_timeout if timeout is None else float(timeout)
        if not self.scheduler.mark_draining(eid, reason="model_swap"):
            raise RuntimeError(f"replica {eid} is not routable "
                               "(unknown/dead/already draining)")
        ok, err = False, ""
        try:
            if not self.scheduler.drain_replica(eid, timeout=dt):
                err = f"replica {eid} did not drain within {dt:.0f}s"
            else:
                token = f"swap-{eid}-{time.monotonic_ns()}"
                waiter = self.scheduler.expect_swap(eid, token=token)
                # adapter versions swap DELTA-ONLY: the payload carries
                # the small delta and the worker re-applies it over its
                # pristine-base cache; a clone peer would ship full
                # params over the wire for nothing
                peer = (None if entry.base_builder is not None
                        else self.scheduler.peer_replica_info(
                            exclude={eid}, model=entry.key))
                # the registry entry is the builder of record for
                # EVERY version (run() rejects a conflicting explicit
                # model_builder), so the payload always carries it —
                # no worker-args fallback guessing
                payload = entry.swap_payload()
                self.cluster._client_for(eid).put(
                    REQUEST_QUEUE,
                    {"op": "model", "event": "swap",
                     "model": str(model_id), "version": str(version),
                     "peer": peer, "swap_token": token,
                     **payload}, timeout=10)
                # the swap builds/clones + loads a parameter tree: allow
                # it a model-build's worth of time on top of the drain
                ok, err = self.scheduler.wait_swap(waiter, dt + 120.0)
        finally:
            if not ok:
                # best-effort cancel: a swap the replica has not applied
                # yet is dropped; an applied one acks late and the
                # scheduler relabels (see the worker's cancel handler)
                with contextlib.suppress(Exception):
                    self.cluster._client_for(eid).put(
                        REQUEST_QUEUE,
                        {"op": "model", "event": "cancel"}, timeout=5)
                # the replica still serves its old version (or died, in
                # which case resume is a no-op and death handling owns
                # the gang)
                self.scheduler.resume_replica(eid)
        if not ok:
            raise RuntimeError(f"model swap of replica {eid} to "
                               f"{model_id}@{version} failed: {err}")
        self.registry.mark(model_id, version, "serving")

    def rollout(self, model_id: str, version: str, policy=None,
                block: bool = True):
        """Run a live canary rollout of ``model_id`` to ``version``
        (docs/serving.md): canary one gang, shift traffic by the
        policy's percent steps, auto-roll back on a metrics regression.
        ``block=True`` runs synchronously and returns the terminal
        :class:`~tensorflowonspark_tpu_torch.serving.rollout.
        RolloutController` (``.state`` is ``promoted`` /
        ``rolled_back``); ``block=False`` starts it on a background
        thread (``.wait()`` joins)."""
        from tensorflowonspark_tpu_torch.serving.rollout import RolloutController

        ctl = RolloutController(self, model_id, version, policy=policy)
        if block:
            ctl.run()
            return ctl
        return ctl.start()

    def donate_prefix_pages(self, to_replica: int,
                            from_replica: int | None = None) -> bool:
        """Prefix-page donation across pools (docs/serving.md): ask a
        prefill gang to ship its shared prefix-cache pages
        (``ContinuousBatcher.export_prefix_cache``, content-hashed)
        straight to ``to_replica``'s queue plane, where the decode
        gang imports them (``import_prefix_cache``) — so a decode-side
        prefix miss consults what a prefill pool already computed
        instead of importing page data the fleet already holds.  The
        donor defaults to the least-loaded prefill gang serving the
        SAME (model, version).  Returns False when no eligible donor
        exists or the tier runs mesh-sharded gangs (a gang's pages are
        cut over tp; host pages would need a resharding pass)."""
        if self.gang_spec is not None or self._shutdown_done:
            return False
        eid = int(to_replica)
        info = self.scheduler.replica_info(eid)
        if info is None:
            return False
        donor = from_replica
        if donor is None:
            donor = self.scheduler.prefix_donor(
                exclude={eid},
                model=self.scheduler.replica_model_version(eid))
        if donor is None:
            return False
        try:
            self.cluster._client_for(int(donor)).put(
                REQUEST_QUEUE,
                {"op": "prefix", "event": "export",
                 "reply_addr": tuple(info["addr"]),
                 "reply_authkey": info["authkey"]}, timeout=10)
        except Exception:  # tfos: ignore[broad-except] — a donation is
            # an optimization; a dead/unreachable donor must not fail
            # the membership path that triggered it
            logger.exception("prefix-page donation %s -> %s failed",
                             donor, eid)
            return False
        self.scheduler.emit_event("prefix_donation", donor=int(donor),
                                  to=eid)
        return True

    # ------------------------------------------------ preemption handling
    def _on_phase(self, eid: int, phase: str) -> None:
        """Monitor ``on_phase`` hook: a live replica flipping to
        ``preempted`` is in its reclaim grace window — drain and replace
        it NOW instead of waiting for the exit.  A gang SHARD's phase
        flip drains the whole gang (its leader)."""
        if phase == "preempted" and not self._shutdown_done:
            self._handle_preempted(self.scheduler.resolve_gang(int(eid)))

    def _on_cluster_failure(self, failure) -> None:
        """Monitor ``on_failure`` hook: absorb UNPROMOTED-standby deaths
        into the pool (shrink + backfill — the scheduler never knew
        them), then always fail over via the scheduler — which resolves
        a gang shard's death to the WHOLE gang, requeueing its in-flight
        work once — then reap the dead gang's surviving processes (a
        leaderless member would otherwise idle on its queue forever).  A
        PREEMPTION-classified exit (the replica died before
        or during its grace drain) additionally spawns a replacement;
        with a warm pool (or ``replace_failed``), CRASH/HANG deaths heal
        the same way — membership flexes, the tier never shrinks."""
        failed = [int(e) for e in getattr(failure, "failed_workers", ())]
        standby_owned: set[int] = set()
        if self.standbys is not None and not self._shutdown_done:
            standby_owned = self.standbys.handle_failure(failed)
        self.scheduler.on_cluster_failure(failure)
        failed = [e for e in failed if e not in standby_owned]
        leaders = {self.scheduler.resolve_gang(e) for e in failed}
        if self.gang_spec is not None and not self._shutdown_done:
            dead = self.scheduler.dead_replicas()
            for leader in leaders:
                if leader in dead:
                    # off the monitor's poll thread: reaping does queue
                    # I/O (EndOfFeed puts) and must not delay detection
                    threading.Thread(
                        target=self._stop_gang_workers, args=(leader,),
                        name=f"serve-gang-reap-{leader}",
                        daemon=True).start()
        if self._shutdown_done:
            return
        kind = getattr(failure, "kind", None)
        if self._replace_preempted and kind == PREEMPTION:
            for leader in leaders:
                self._spawn_replacement(leader, source="exit")
        elif kind != PREEMPTION and (self.standbys is not None
                                     or self._replace_failed):
            # crash/hang heal: only replicas the scheduler actually lost
            # (a failure naming an unknown worker must not grow the tier)
            dead = self.scheduler.dead_replicas()
            for leader in leaders:
                if leader in dead:
                    self._spawn_replacement(leader, source="failure",
                                            promote_source="failure")

    def _handle_preempted(self, eid: int) -> None:
        # mark_draining is the dedup: False when already draining/dead,
        # so repeated phase reports (or the exit racing the drain) start
        # exactly one drain-and-replace
        if not self.scheduler.mark_draining(eid, reason="preempted"):
            return
        threading.Thread(target=self._drain_and_replace, args=(eid,),
                         name=f"serve-preempt-{eid}", daemon=True).start()

    def _drain_and_replace(self, eid: int) -> None:
        try:
            self.scheduler.drain_replica(eid, timeout=self._drain_timeout)
            # the worker exits by itself after its grace drain; if it
            # died mid-drain the recv loop's _mark_dead already re-queued
            # the leftovers and this retire is a no-op
            self.scheduler.retire_replica(eid, reason="preempted")
            if self.gang_spec is not None:
                # the reclaim may have hit a MEMBER — the leader never saw
                # a SIGTERM and would serve forever; EndOfFeed every shard
                # so the full gang heals
                self._stop_gang_workers(eid)
        except Exception:
            logger.exception("preemption drain of replica %d failed", eid)
        if self._replace_preempted:
            self._spawn_replacement(eid, source="drain")

    def _spawn_replacement(self, eid: int, source: str,
                           promote_source: str = "preemption") -> None:
        if self._shutdown_done:
            return
        with self._membership_lock:
            if eid in self._replaced:
                return   # phase path and exit path both fired; one spawn
            self._replaced.add(eid)
        # the heal clock starts at the DECISION, before any boot/promote
        # work — bench_serving's heal-time rows measure from this event
        self.scheduler.emit_event("heal_started", replica=eid,
                                  source=source)
        # capture the lost replica's pool NOW: the replacement must
        # re-arm the SAME specialization (a decode replica replaced by a
        # prefill one would starve the other pool).  The expectation
        # makes dispatch QUEUE that pool's work for the heal window —
        # when the dead gang was a pool's LAST, its requeued handoffs/
        # prompts must wait for the replacement, not shed as no_replica.
        role = self.scheduler.replica_role(eid)
        # ... and its MODEL: on a multi-model tier the replacement must
        # serve the dead gang's own (model_id, version) — a shared spare
        # fleet re-armed per model at promotion, a cold spawn built from
        # the version's registry args
        model = self.scheduler.replica_model_version(eid)
        self.scheduler.expect_replica(role)

        def _go():
            try:
                if self._shutdown_done:
                    return
                # promote-with-role: a lost prefill/decode gang heals
                # from the (role-less) warm pool too — the promote
                # message carries the dead gang's role and the standby
                # specializes on arrival
                promoted = self.promote_standby(promote_source, role=role,
                                                model=model)
                if promoted is not None:
                    self.scheduler.emit_event(
                        "replica_replaced", replica=eid,
                        replacement=promoted, source=source, mode="warm",
                        role=role,
                        model=None if model is None else model[0])
                    return
                new = self.add_replicas(1, role=role, model=model)
                self.scheduler.emit_event(
                    "replica_replaced", replica=eid, replacement=new[0],
                    source=source, mode="cold", role=role,
                    model=None if model is None else model[0])
            except Exception:
                logger.exception("replacement for lost replica %d "
                                 "failed", eid)
                self.scheduler.emit_event("replace_failed", replica=eid,
                                          source=source)
            finally:
                self.scheduler.expect_done(role)

        threading.Thread(target=_go, name=f"serve-replace-{eid}",
                         daemon=True).start()

    def metrics(self) -> dict:
        """The scheduler's counters/latency view, plus ``"nodes"``: the
        heartbeat-carried per-replica registry snapshots and goodput
        aggregated by the serving-mode monitor (docs/observability.md)."""
        m = self.scheduler.metrics()
        m["nodes"] = (self.monitor.node_metrics()
                      if self.monitor is not None else {})
        if self.autoscaler is not None:
            m["autoscaler"] = {"scale_ups": self.autoscaler.scale_ups,
                               "scale_downs": self.autoscaler.scale_downs}
        if self.autoscalers:
            m["autoscalers"] = {
                s.cfg.role: {"scale_ups": s.scale_ups,
                             "scale_downs": s.scale_downs}
                for s in self.autoscalers}
        if self.standbys is not None:
            with self._promotions_lock:
                promotions = dict(self._promoted)
            m["standby"] = {**self.standbys.stats(),
                            "promotions": promotions,
                            "heal": self.heal.summary()}
        if self.registry is not None:
            m["registry"] = self.registry.summary()
        return m

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole tier: the driver
        registry (scheduler queue depth, per-replica outstanding, TTFT/
        e2e histograms, shed/requeue counters, frontend ops) merged with
        every replica's heartbeat-carried snapshot, samples labeled by
        ``node``."""
        return tpu_metrics.render_cluster_text(
            tpu_metrics.get_registry().snapshot(),
            self.monitor.node_metrics() if self.monitor is not None else {})

    # ------------------------------------------------------------- shutdown
    def crash(self) -> None:
        """Hard-kill the DRIVER half of the tier in place — the
        in-process equivalent of SIGKILLing a standalone driver process
        (the ``TFOS_CHAOS="kill driver ..."`` verb fires this).

        No drain, no requeue, no typed shutdown errors, nothing further
        journaled: frontend sockets drop mid-stream, scheduler threads
        stop with pending/outstanding work left exactly where it was.
        Workers, their queue servers, and everything in flight on them
        keep running — the obligations live in the fsync'd journal, and
        :func:`~tensorflowonspark_tpu_torch.serving.failover.resume_driver`
        rebuilds a control plane over the surviving data plane from it.
        """
        if self._shutdown_done:
            return
        self._shutdown_done = True        # membership paths stand down
        jnl, self.journal = self.journal, None
        logger.warning(
            "driver CRASH: dropping the control plane in place (journal "
            "%s survives)", "<none>" if jnl is None else jnl.path)
        if self._driver_chaos is not None:
            with contextlib.suppress(Exception):
                self._driver_chaos.stop()
        # driver-side control threads only — a dead process would take
        # these with it, and none of them messages a worker
        for scaler in ([self.autoscaler] if self.autoscaler is not None
                       else []) + list(self.autoscalers):
            with contextlib.suppress(Exception):
                scaler.stop()
        if self.metrics_http is not None:
            with contextlib.suppress(Exception):
                self.metrics_http.stop()
            self.metrics_http = None
        # a dead process journals nothing more: drop the scheduler's handle
        # before the frontend's sockets close, or a stream thread that loses
        # its client there journals its request abandoned and the resume
        # never requeues it
        self.scheduler.journal = None
        self.frontend.stop()
        self.scheduler.crash()
        if self.monitor is not None:
            with contextlib.suppress(Exception):
                self.monitor.stop()
        if jnl is not None:
            jnl.close()       # every record is already fsync'd; the fd
            # just dies with the "process", like a real SIGKILL

    def shutdown(self, timeout: float = 600.0,
                 drain_timeout: float = 60.0) -> None:
        """Drain in-flight requests, stop the tier, shut the cluster down.

        Worker failures the scheduler already failed over (dead replicas
        whose requests were re-queued or given typed errors) are
        tolerated — a serving tier that survived a replica death must not
        fail its own shutdown over the corpse.  Unhandled failures
        re-raise as usual.
        """
        if self._shutdown_done:
            return
        self._shutdown_done = True
        if self.standbys is not None:
            # no backfills may race the teardown; unpromoted standbys
            # exit on the cluster shutdown's EndOfFeed like replicas
            with contextlib.suppress(Exception):
                self.standbys.stop()
        for scaler in ([self.autoscaler] if self.autoscaler is not None
                       else []) + list(self.autoscalers):
            # no membership changes may race the teardown
            with contextlib.suppress(Exception):
                scaler.stop()
        if not self.scheduler.drain(drain_timeout):
            logger.warning("serving scheduler still busy after %.0fs drain; "
                           "remaining requests get typed shutdown errors",
                           drain_timeout)
        handled = self.scheduler.dead_replicas()
        if self.standbys is not None:
            # dead UNPROMOTED standbys were handled too (pool backfilled)
            handled |= self.standbys.dead
        if self.metrics_http is not None:
            with contextlib.suppress(Exception):
                self.metrics_http.stop()
            self.metrics_http = None
        if self._driver_chaos is not None:
            # a still-pending driver-kill timer must not fire into a
            # cleanly shut down tier
            with contextlib.suppress(Exception):
                self._driver_chaos.stop()
        self.frontend.stop()
        self.scheduler.stop()
        if self.journal is not None:
            # after scheduler.stop(): nothing records past this point
            self.journal.close()
            self.journal = None
        if self.monitor is not None:
            self.monitor.stop()
        try:
            self.cluster.shutdown(timeout=timeout)
        except Exception as e:
            failed = set()
            with contextlib.suppress(Exception):
                failed = set(self.cluster.backend.failed())
            if handled and failed and failed <= handled:
                logger.warning(
                    "tolerating worker exit(s) %s already failed over by "
                    "the serving tier: %s", sorted(failed), e)
            else:
                raise
