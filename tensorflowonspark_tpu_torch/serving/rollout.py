"""Multi-model serving with live rollout: registry, canary, auto-rollback.

Port of ``tensorflowonspark_tpu/serving/rollout.py``.  The registry, the
policy and the controller are the JAX package's; an adapter delta is keyed
by the port model's STATE-DICT names (``"layers.0.attn.query.weight"``)
where the JAX package keys it by flax paths, and
:func:`~tensorflowonspark_tpu_torch.models.gpt.adapter_from_flax` carries
a delta written for the JAX package over.  ``evaluate_grid`` takes any
object with the batch plane's ``trial_results(trial_id, decode=)``.

Upstream TFoS served exactly one SavedModel per job (``TFCluster.run`` →
one ``map_fun``, one model); a production tier multiplexes many models
and versions over one fleet and replaces versions LIVE.  This module is
the control plane for that (ROADMAP item 5):

- :class:`ModelRegistry` — the catalog: every ``(model_id, version)`` is
  either a FULL version (a picklable ``builder(args) -> (cfg, params)``)
  or an ADAPTER version (a delta applied over a shared base's
  params — the LoRA-shaped deployment where N versions share one weight
  payload).  A version must pass an OFFLINE EVAL before it is
  promotable: :meth:`ModelRegistry.evaluate_grid` runs the verdict over
  a ``GridSearch`` trial's
  merged results — the batch plane doubling as the eval harness — and
  :class:`RolloutController` refuses un-evaluated versions.
- **Hosting** — replicas carry a ``(model_id, version)`` label in the
  scheduler; requests route by ``model_id`` through the existing
  tenant/priority admission (``submit(model=...)``, the frontend/client
  pass it through), and a request naming an unhosted model is rejected
  typed (``RequestRejected(reason="unknown_model")``).  New models join
  a live tier via ``ServingCluster.deploy_model`` (fresh gangs built
  from the version's registry args); versions replace each other via
  the drain-verb HOT SWAP (``ServingCluster.swap_replica_model``: drain
  → ship the version payload over the queue/bulk plane → the replica
  rebuilds or peer-clones params and copies them into its batcher via
  ``ContinuousBatcher.load_params`` → resume routing) — zero requests
  lost, the swap window's traffic queues or rides the other gangs.
- :class:`RolloutController` — the live rollout: arm a CANARY gang on
  the new version (promote a warm standby re-armed FOR THAT MODEL —
  the shared spare pool closing ROADMAP item 4's leftover — else
  drain-swap one incumbent gang in place), shift traffic by declarative
  percent steps with a bake time per step
  (``ReplicaScheduler.set_traffic_split``), gate each step on the
  per-model/per-version metrics snapshot (error rate, TTFT/e2e p95 vs
  the incumbent), and AUTO-ROLL BACK on a regression: traffic snaps to
  the incumbent, the canary gang swaps back, the version is marked
  ``rolled_back`` — the old version never stopped serving.

``chip_smoke.py``'s phase 22 holds a canary rollout at GPT-124M-class
width to solo greedy under each version, on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as _metrics

logger = logging.getLogger(__name__)

#: a version's lifecycle states, in rough order
STATES = ("registered", "evaluated", "canary", "serving", "retired",
          "rolled_back")


class RolloutError(RuntimeError):
    """A rollout could not run (un-evaluated version, mixed incumbent
    versions, no swappable gang) — distinct from a GATED rollback, which
    is a normal outcome, not an error."""


def apply_adapter(params: dict, delta: dict) -> dict:
    """Apply an ADAPTER version's delta over a base state dict.

    ``delta`` maps state-dict names (``"layers.0.attn.query.weight"``) to
    arrays ADDED elementwise to the base entry — the merged-LoRA shape: N
    versions ship small deltas over one shared base payload.  Returns a
    new dict; the base's tensors are never written (a delta'd name gets
    a fresh tensor of the base's dtype and device, the rest are shared).
    Unknown names and shape mismatches raise ``ValueError`` naming the
    offender (a silently dropped delta would serve the base model under
    the new version's label)."""
    import torch

    out = dict(params)
    for name, d in dict(delta or {}).items():
        if name not in out:
            raise ValueError(
                f"adapter delta names unknown parameter {name!r} "
                f"(base has {len(out)} entries)")
        base = out[name]
        d = np.asarray(d)
        if tuple(d.shape) != tuple(base.shape):
            raise ValueError(
                f"adapter delta for {name!r} has shape {tuple(d.shape)}, "
                f"base entry is {tuple(base.shape)}")
        if isinstance(base, torch.Tensor):
            out[name] = base + torch.from_numpy(np.ascontiguousarray(d)).to(
                device=base.device, dtype=base.dtype)
        else:
            base = np.asarray(base)
            out[name] = base + d.astype(base.dtype)
    return out


def build_registered_model(args):
    """Worker-side builder for an ADAPTER version: build the shared base
    (``args["serve_base_builder"]``), apply ``args["serve_adapter"]``.
    Top level so the registry's spawn/swap payloads pickle it by
    reference like any other model builder."""
    cfg, params = args["serve_base_builder"](args)
    delta = args.get("serve_adapter")
    if delta:
        params = apply_adapter(params, delta)
    return cfg, params


class ModelVersion:
    """One registered ``(model_id, version)`` entry (see module
    docstring).  ``serve_args()`` is the worker-spawn overlay,
    ``swap_payload()`` the hot-swap wire payload — both carry the same
    builder-or-(base+adapter) resolution plus the version's extra
    ``serve_args`` (e.g. a ``seed`` the builder reads)."""

    __slots__ = ("model_id", "version", "builder", "base_builder",
                 "adapter", "extra_args", "metadata", "state",
                 "eval_metrics", "eval_passed", "evicted", "flavor")

    def __init__(self, model_id: str, version: str, builder=None, *,
                 base_builder=None, adapter=None, serve_args=None,
                 metadata=None):
        self.model_id = str(model_id)
        self.version = str(version)
        self.builder = builder
        self.base_builder = base_builder
        self.adapter = adapter
        self.extra_args = dict(serve_args or {})
        self.metadata = dict(metadata or {})
        self.state = "registered"
        self.eval_metrics: dict | None = None
        self.eval_passed: bool | None = None
        #: retention evicted the payloads (builder/adapter/serve_args);
        #: the row survives as lineage only
        self.evicted = False
        #: "adapter" | "full", fixed at registration (survives eviction)
        self.flavor = "adapter" if base_builder is not None else "full"

    @property
    def key(self) -> tuple[str, str]:
        return (self.model_id, self.version)

    def _check_payload(self) -> None:
        if self.evicted:
            raise RolloutError(
                f"{self.model_id}@{self.version} was evicted by registry "
                "retention (keep_versions); its payloads are gone — only "
                "the lineage row remains")

    def serve_args(self) -> dict:
        self._check_payload()
        a = dict(self.extra_args)
        a["serve_model"] = (self.model_id, self.version)
        if self.base_builder is not None:
            a["serve_model_builder"] = build_registered_model
            a["serve_base_builder"] = self.base_builder
            a["serve_adapter"] = self.adapter
        else:
            a["serve_model_builder"] = self.builder
        return a

    def swap_payload(self) -> dict:
        # NOTE: a swap's serve_args overlay REPLACES same-name keys on
        # the worker but absent keys persist from the worker's current
        # args (a promoted standby keeps its promotion overlay) — a
        # version that must RESET a knob another version set should
        # carry it explicitly (e.g. {"serve_step_delay": 0})
        self._check_payload()
        p = {"serve_args": dict(self.extra_args)}
        if self.base_builder is not None:
            p["base_builder"] = self.base_builder
            p["adapter"] = self.adapter
        else:
            p["builder"] = self.builder
        return p

    def describe(self) -> dict:
        return {"model": self.model_id, "version": self.version,
                "state": self.state,
                "kind": self.flavor,
                "eval_passed": self.eval_passed,
                "eval_metrics": self.eval_metrics,
                "evicted": self.evicted,
                "metadata": dict(self.metadata)}


def draft_overlay(version: ModelVersion) -> dict:
    """Map a registered version onto the DRAFT-side arg keys
    (``serve_draft_*``) — a speculation draft is "just another version":
    the same builder-or-(base+adapter) payload every serving path ships,
    renamed so the worker arms it as the proposer
    (``serving.replica.build_draft_model``) instead of the target.  The
    version's ``serve_draft_*`` extra args (e.g. ``serve_draft_window``,
    ``serve_draft_k``) pass through directly; its remaining extra args
    land in ``serve_draft_args``, overlaid onto the builder's arg view
    only while BUILDING the draft (a draft version's ``seed`` must not
    leak into the target's)."""
    a = {k: v for k, v in version.extra_args.items()
         if str(k).startswith("serve_draft_")}
    rest = {k: v for k, v in version.extra_args.items()
            if not str(k).startswith("serve_draft_")}
    if rest:
        a["serve_draft_args"] = rest
    a["serve_draft_model"] = version.key
    if version.base_builder is not None:
        a["serve_draft_base_builder"] = version.base_builder
        a["serve_draft_adapter"] = version.adapter
    else:
        a["serve_draft_builder"] = version.builder
    return a


class ModelRegistry:
    """Catalog of models/versions one serving tier hosts (module
    docstring).  Thread-safe; the tier, the rollout controller and user
    code all read it concurrently."""

    def __init__(self, keep_versions: int | None = None):
        """``keep_versions``: retention knob for the continual-emission
        loop — at most this many ``retired``/``rolled_back`` versions per
        model keep their payloads; older dead versions are EVICTED
        (builder/adapter/serve_args dropped, lineage row kept) so a
        standing pipeline can't grow the catalog unboundedly.  ``None``
        (default) keeps everything."""
        if keep_versions is not None and int(keep_versions) < 0:
            raise ValueError("keep_versions must be >= 0 or None")
        self.keep_versions = (None if keep_versions is None
                              else int(keep_versions))
        self._lock = threading.Lock()
        self._versions: dict[str, dict[str, ModelVersion]] = {}
        self._journal = None

    def bind_journal(self, journal) -> None:
        """Attach the tier's write-ahead control-plane journal
        (``serving/journal.py``): every registration, eval verdict and
        state flip appends a record, so a resumed driver replays the
        catalog's lifecycle state (:meth:`adopt`).  Binding SNAPSHOTS
        the current catalog first — registrations and eval verdicts
        made before the tier booted (the usual order) must replay too;
        the records are idempotent under the journal fold, so re-binding
        after a resume is harmless.  Builders are code and never
        journal — a resume re-registers them."""
        self._journal = journal
        with self._lock:
            entries = [e for vs in self._versions.values()
                       for e in vs.values()]
        for e in sorted(entries, key=lambda e: (e.model_id, e.version)):
            self._jrecord("registry_register", model=e.model_id,
                          version=e.version, flavor=e.flavor)
            if e.eval_passed is not None:
                self._jrecord("registry_eval", model=e.model_id,
                              version=e.version, passed=bool(e.eval_passed),
                              metrics=e.eval_metrics)
            if e.state != "registered":
                self._jrecord("registry_state", model=e.model_id,
                              version=e.version, state=e.state)
            if e.evicted:
                self._jrecord("registry_evict", model=e.model_id,
                              version=e.version)

    def _jrecord(self, kind: str, **fields) -> None:
        if self._journal is not None:
            self._journal.record(kind, **fields)

    def adopt(self, state) -> None:
        """Restore version states + eval verdicts from a replayed
        :class:`~tensorflowonspark_tpu_torch.serving.journal.JournalState`
        (``serving.failover.resume_driver``).  The caller re-registers
        each version's builder first; journaled versions with no
        matching registration are warned about and skipped."""
        for (mid, ver), ent in sorted(state.registry.items()):
            try:
                entry = self.version(mid, ver)
            except KeyError:
                logger.warning(
                    "journal names %s@%s but it is not re-registered in "
                    "the resumed registry; skipping", mid, ver)
                continue
            if ent.get("eval_passed") is not None:
                entry.eval_passed = bool(ent["eval_passed"])
                entry.eval_metrics = ent.get("eval_metrics")
            if ent.get("state") in STATES:
                entry.state = ent["state"]
            if ent.get("evicted"):
                # replay honors evictions: the re-registered payloads are
                # dropped again (already journaled — don't re-record)
                self._evict(entry, journal=False)

    # -- registration ------------------------------------------------------
    def register(self, model_id: str, version: str, builder=None, *,
                 base=None, adapter=None, serve_args: dict | None = None,
                 metadata: dict | None = None) -> ModelVersion:
        """Register one version.  Exactly one of:

        - ``builder`` — a picklable ``(args) -> (cfg, params)`` (FULL
          version);
        - ``base`` — a base builder callable, or a registered FULL
          version's ``(model_id, version)`` key, with an optional
          ``adapter`` delta (``{state-dict name: array}``, see
          :func:`apply_adapter`) applied over the base's params.

        ``serve_args`` are extra worker-args the version overlays at
        spawn/swap time (e.g. ``{"seed": 3}`` for a builder that keys on
        it).  The version starts ``registered`` and must pass an offline
        eval (:meth:`evaluate` / :meth:`evaluate_grid`) before
        :meth:`promotable` says yes."""
        if (builder is None) == (base is None):
            raise ValueError(
                "register needs exactly one of builder= (full version) "
                "or base= (adapter version)")
        if adapter is not None and base is None:
            raise ValueError("adapter= needs base=")
        base_builder = None
        if base is not None:
            if isinstance(base, tuple):
                ref = self.version(*base)
                if ref.base_builder is not None:
                    raise ValueError(
                        f"base {base!r} is itself an adapter version — "
                        "adapter-over-adapter is not supported; point at "
                        "the full base version")
                base_builder = ref.builder
            elif callable(base):
                base_builder = base
            else:
                raise ValueError(f"base must be a builder callable or a "
                                 f"(model_id, version) key, got {base!r}")
        entry = ModelVersion(model_id, version, builder,
                             base_builder=base_builder, adapter=adapter,
                             serve_args=serve_args, metadata=metadata)
        with self._lock:
            versions = self._versions.setdefault(entry.model_id, {})
            if entry.version in versions:
                raise ValueError(f"{entry.model_id}@{entry.version} is "
                                 "already registered")
            versions[entry.version] = entry
        logger.info("registered %s@%s (%s)", entry.model_id, entry.version,
                    "adapter" if base_builder is not None else "full")
        self._jrecord("registry_register", model=entry.model_id,
                      version=entry.version,
                      flavor="adapter" if base_builder is not None
                      else "full")
        return entry

    # -- lookup ------------------------------------------------------------
    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._versions)

    def versions(self, model_id: str) -> list[str]:
        with self._lock:
            return list(self._versions.get(str(model_id), {}))

    def version(self, model_id: str, version: str) -> ModelVersion:
        with self._lock:
            entry = self._versions.get(str(model_id), {}).get(str(version))
            known = [f"{m}@{v}" for m in sorted(self._versions)
                     for v in self._versions[m]]
        if entry is None:
            raise KeyError(f"unknown version {model_id}@{version} "
                           f"(registered: {known})")
        return entry

    def has_model(self, model_id: str) -> bool:
        with self._lock:
            return str(model_id) in self._versions

    def summary(self) -> dict:
        """JSON-able view for events/``/statusz``."""
        with self._lock:
            return {m: {v: e.describe() for v, e in vs.items()}
                    for m, vs in self._versions.items()}

    # -- offline eval gate -------------------------------------------------
    def record_eval(self, model_id: str, version: str, metrics: dict,
                    passed: bool) -> None:
        """Record an offline-eval verdict (the promotion gate's input);
        ``passed`` flips the version to ``evaluated``."""
        entry = self.version(model_id, version)
        entry.eval_metrics = dict(metrics or {})
        entry.eval_passed = bool(passed)
        if passed and entry.state == "registered":
            entry.state = "evaluated"
        logger.info("offline eval for %s@%s: %s %s", model_id, version,
                    "PASSED" if passed else "FAILED", metrics)
        self._jrecord("registry_eval", model=entry.model_id,
                      version=entry.version, passed=bool(passed),
                      metrics=entry.eval_metrics)

    def evaluate(self, model_id: str, version: str, scorer,
                 results) -> bool:
        """Run ``scorer(results) -> (metrics_dict, passed)`` over offline
        outputs and record the verdict.  Returns ``passed``."""
        metrics, passed = scorer(results)
        self.record_eval(model_id, version, metrics, passed)
        return bool(passed)

    def evaluate_grid(self, model_id: str, version: str, grid_search,
                      trial_id: str, scorer, decode: bool = False) -> bool:
        """The GridSearch-as-offline-eval gate: score one finished trial's
        merged results (``GridSearch.trial_results``) and record the
        verdict — run the search first (``grid_search.run(...)``)."""
        return self.evaluate(model_id, version, scorer,
                             grid_search.trial_results(trial_id,
                                                       decode=decode))

    def promotable(self, model_id: str, version: str) -> bool:
        """True once the version's offline eval passed — the gate
        :class:`RolloutController` (and ``deploy_model``) enforce.
        Evicted versions are never promotable (payloads are gone)."""
        entry = self.version(model_id, version)
        return bool(entry.eval_passed) and not entry.evicted

    def mark(self, model_id: str, version: str, state: str) -> None:
        if state not in STATES:
            raise ValueError(f"unknown state {state!r} (want one of "
                             f"{STATES})")
        self.version(model_id, version).state = state
        self._jrecord("registry_state", model=str(model_id),
                      version=str(version), state=state)
        if state in ("retired", "rolled_back"):
            self._enforce_retention(str(model_id))

    # -- retention ---------------------------------------------------------
    def _evict(self, entry: ModelVersion, journal: bool = True) -> None:
        entry.evicted = True
        entry.builder = None
        entry.base_builder = None
        entry.adapter = None
        entry.extra_args = {}
        if journal:
            logger.info("retention evicted %s@%s (payloads dropped, "
                        "lineage kept)", entry.model_id, entry.version)
            self._jrecord("registry_evict", model=entry.model_id,
                          version=entry.version)

    def _enforce_retention(self, model_id: str) -> None:
        """Evict the oldest dead versions beyond ``keep_versions``.
        Registration order approximates age (``_versions`` is
        insertion-ordered); live states are never touched."""
        if self.keep_versions is None:
            return
        with self._lock:
            dead = [e for e in self._versions.get(model_id, {}).values()
                    if e.state in ("retired", "rolled_back")
                    and not e.evicted]
        excess = len(dead) - self.keep_versions
        for e in dead[:max(0, excess)]:
            self._evict(e)


# ------------------------------------------------------------- rollout

@dataclasses.dataclass(frozen=True)
class RolloutPolicy:
    """Declarative canary policy: traffic percent steps (each baked
    ``bake_secs`` then gated), and the regression gate thresholds.

    The gate compares the canary version's bake-window snapshot against
    the incumbent's: ``max_error_rate`` bounds
    ``failed / (completed + failed)`` over the window;
    ``max_ttft_ratio`` / ``max_e2e_ratio`` bound the canary's p95
    against the incumbent's (``None`` disables that bound).  A gate
    needs ``min_samples`` canary completions before latency ratios are
    trusted (error rate always counts)."""

    steps: tuple = (10, 50, 100)
    bake_secs: float = 5.0
    min_samples: int = 5
    max_error_rate: float = 0.05
    max_ttft_ratio: float | None = None
    max_e2e_ratio: float | None = 2.0
    require_eval: bool = True

    def __post_init__(self):
        steps = tuple(int(s) for s in self.steps)
        if not steps or steps[-1] != 100 \
                or any(not 0 < s <= 100 for s in steps) \
                or list(steps) != sorted(set(steps)):
            raise ValueError(
                f"steps must be strictly increasing percents ending at "
                f"100, got {self.steps}")
        object.__setattr__(self, "steps", steps)
        if self.bake_secs < 0:
            raise ValueError(f"bake_secs must be >= 0, got {self.bake_secs}")
        if not 0 <= self.max_error_rate <= 1:
            raise ValueError(f"max_error_rate must be in [0, 1], got "
                             f"{self.max_error_rate}")
        for name in ("max_ttft_ratio", "max_e2e_ratio"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")


class RolloutController:
    """Drive one model's live version rollout (module docstring).

    States: ``idle`` → ``canary`` → ``shifting`` → terminal
    ``promoted`` | ``rolled_back`` | ``failed``.  :meth:`run` is
    synchronous; :meth:`start` runs it on a background thread
    (:meth:`wait` joins).  Every transition lands in the tier's
    ``serving_events.jsonl`` (``rollout_started`` / ``rollout_step`` /
    ``rollout_promoted`` / ``rollout_rolled_back`` / ``rollout_failed``)
    and in ``tfos_serving_rollouts_total{outcome}``."""

    def __init__(self, serving, model_id: str, version: str,
                 policy: RolloutPolicy | None = None):
        if serving.registry is None:
            raise RolloutError("the serving tier has no ModelRegistry "
                               "attached (ServingCluster.run(registry=))")
        self.serving = serving
        self.scheduler = serving.scheduler
        self.registry = serving.registry
        self.model_id = str(model_id)
        self.version = str(version)
        self.policy = policy or RolloutPolicy()
        self.state = "idle"
        self.detail: dict = {}
        self.steps_taken: list[dict] = []
        #: the incumbent's last bake window WITH samples — the latency
        #: baseline for steps where it no longer takes traffic
        self._stable_ref: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        reg = _metrics.get_registry()
        self._m_rollouts = reg.counter(
            "tfos_serving_rollouts_total",
            "Rollout outcomes (promoted/rolled_back/failed).",
            labelnames=("outcome",))
        self._g_canary = reg.gauge(
            "tfos_serving_canary_traffic_ratio",
            "Fraction of a model's traffic routed to the canary version "
            "mid-rollout.", labelnames=("model",))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "RolloutController":
        self._thread = threading.Thread(
            target=self.run, name=f"rollout-{self.model_id}", daemon=True)
        self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> str:
        if self._thread is not None:
            self._thread.join(timeout)
        return self.state

    def abort(self) -> None:
        """Request a rollback at the next gate check (a human pulling the
        cord mid-bake)."""
        self._stop.set()

    # -- the rollout -------------------------------------------------------
    def run(self) -> str:
        try:
            self._run()
        except RolloutError as e:
            self.state = "failed"
            self._m_rollouts.inc(outcome="failed")
            self.scheduler.emit_event("rollout_failed",
                                      model=self.model_id,
                                      version=self.version,
                                      error=str(e))
            self.scheduler.journal_record("rollout_done",
                                          model=self.model_id,
                                          version=self.version,
                                          outcome="failed")
            raise
        except Exception as e:  # tfos: ignore[broad-except] — a rollout
            # crash must leave a terminal state + event, not a silently
            # dead thread; the error is re-raised for synchronous callers
            self.state = "failed"
            self.detail = {"error": f"{type(e).__name__}: {e}"}
            self._m_rollouts.inc(outcome="failed")
            self.scheduler.emit_event("rollout_failed",
                                      model=self.model_id,
                                      version=self.version,
                                      error=str(e))
            self.scheduler.journal_record("rollout_done",
                                          model=self.model_id,
                                          version=self.version,
                                          outcome="failed")
            logger.exception("rollout %s@%s failed", self.model_id,
                             self.version)
            raise
        return self.state

    def _run(self) -> None:
        mid, ver, pol = self.model_id, self.version, self.policy
        entry = self.registry.version(mid, ver)
        if pol.require_eval and not self.registry.promotable(mid, ver):
            raise RolloutError(
                f"{mid}@{ver} has not passed its offline eval "
                "(ModelRegistry.evaluate_grid) — refusing to canary an "
                "unvetted version (RolloutPolicy(require_eval=False) "
                "overrides)")
        hosted = self.scheduler.model_versions(mid)
        incumbents = [v for v in hosted if v != ver]
        if not hosted:
            raise RolloutError(f"model {mid!r} is not hosted by this tier "
                               "(deploy_model first)")
        if len(incumbents) != 1:
            raise RolloutError(
                f"rollout needs exactly one incumbent version of {mid!r}, "
                f"found {sorted(hosted)}")
        old = incumbents[0]
        self.registry.mark(mid, ver, "canary")
        self.scheduler.emit_event("rollout_started", model=mid,
                                  version=ver, incumbent=old,
                                  steps=list(pol.steps),
                                  bake_secs=pol.bake_secs)
        # the journaled plan is THIS controller's steps — a resumed
        # rollout (serving/failover.py) re-starts with only the
        # remaining steps, so a second failover replays against the
        # narrowed plan, not the original one
        self.scheduler.journal_record("rollout_started", model=mid,
                                      version=ver, incumbent=old,
                                      steps=list(pol.steps))
        if len(self.scheduler.replicas_of(mid, version=old)) <= 1:
            # a single-gang incumbent disappears at canary arm — every
            # "percent" step then routes ALL of the model's traffic to
            # the canary; the pre-canary baseline below is then the
            # ONLY latency reference.  Say so loudly.
            logger.warning(
                "rollout %s@%s: single-gang incumbent — canary steps "
                "degrade to full cutover; gating latency against the "
                "pre-canary observation window only", mid, ver)
            self.scheduler.emit_event("rollout_single_gang_baseline",
                                      model=mid, version=ver)
        # pre-canary baseline: one observation window BEFORE any gang
        # drains.  The canary arm itself stalls the incumbent's traffic
        # (drain-queued requests complete with inflated latency inside
        # the first bake window), and a stall-inflated baseline would
        # mask a genuinely slow canary — the gate takes the LOWER of
        # this and each step's live window.
        base0 = self.scheduler.model_version_stats(mid)
        deadline = time.monotonic() + pol.bake_secs
        while time.monotonic() < deadline and not self._stop.is_set():
            time.sleep(min(0.1, max(0.0, deadline - time.monotonic())))
        pre = self._window(
            self.scheduler.model_version_stats(mid, base=base0).get(old),
            base0.get(old))
        if pre["completed"]:
            self._stable_ref = pre
        self.state = "canary"
        canary_eid = self._arm_canary(old)
        self.state = "shifting"
        try:
            for pct in pol.steps:
                # step INTENT lands before the shift: a driver killed
                # between here and the gate re-executes this step on
                # resume (re-setting a split is idempotent)
                self.scheduler.journal_record("rollout_step", model=mid,
                                              version=ver, percent=pct)
                self.scheduler.set_traffic_split(
                    mid, {ver: pct, old: 100 - pct} if pct < 100
                    else {ver: 100})
                self._g_canary.set(pct / 100.0, model=mid)
                self.scheduler.emit_event("rollout_step", model=mid,
                                          version=ver, percent=pct)
                base = self.scheduler.model_version_stats(mid)
                ok, detail = self._bake_and_gate(base, old)
                self.steps_taken.append({"percent": pct, "ok": ok,
                                         **detail})
                if not ok:
                    self._rollback(canary_eid, old, detail)
                    return
                self.scheduler.journal_record("rollout_step_done",
                                              model=mid, version=ver,
                                              percent=pct)
        except Exception:
            # a crash mid-shift must not strand a partial split
            with contextlib.suppress(Exception):
                self.scheduler.set_traffic_split(mid, {old: 100})
            raise
        finally:
            self._g_canary.remove(model=mid)
        # PROMOTION EVIDENCE gate: every step may have passed on
        # "insufficient samples" (a crash-looping or traffic-starved
        # canary completes nothing — its share silently falls back to
        # the incumbent), and promoting on zero evidence would hot-swap
        # the whole fleet onto an unobserved version.  Require at least
        # min_samples canary completions across the WHOLE rollout.
        seen = int(self.scheduler.model_version_stats(mid)
                   .get(ver, {}).get("completed", 0)
                   - (base0.get(ver) or {}).get("completed", 0))
        if seen < pol.min_samples:
            self._rollback(canary_eid, old, {
                "reason": f"only {seen} canary completion(s) observed "
                          f"across the rollout (min_samples="
                          f"{pol.min_samples}) — refusing to promote "
                          "without evidence"})
            return
        # every step baked clean: finish the fleet and clear the split
        try:
            for eid in self.scheduler.replicas_of(mid, version=old):
                self.serving.swap_replica_model(eid, mid, ver)
        except Exception:
            # a failed finishing swap leaves a mixed fleet: clear the
            # split so routing follows capacity across BOTH versions
            # (each still oracle-exact under its own label) instead of
            # pinning 100% onto the canary gang alone; the rollout
            # reports failed with live routing state intact
            with contextlib.suppress(Exception):
                self.scheduler.clear_traffic_split(mid)
            raise
        self.scheduler.clear_traffic_split(mid)
        self.registry.mark(mid, ver, "serving")
        with contextlib.suppress(KeyError):
            self.registry.mark(mid, old, "retired")
        self.detail = {"incumbent": old}
        self.state = "promoted"
        self._m_rollouts.inc(outcome="promoted")
        self.scheduler.emit_event("rollout_promoted", model=mid,
                                  version=ver, retired=old)
        self.scheduler.journal_record("rollout_done", model=mid,
                                      version=ver, outcome="promoted")
        logger.info("rollout %s@%s promoted (%s retired)", mid, ver, old)

    def _arm_canary(self, old: str) -> int:
        """One gang of the model onto the new version: promote a warm
        standby RE-ARMED for this model (then drain-retire one incumbent
        gang — capacity constant), falling back to an in-place
        drain-swap of an incumbent gang when no pool exists."""
        mid, ver = self.model_id, self.version
        existing = self.scheduler.replicas_of(mid, version=ver)
        if existing:
            # a RESUMED rollout (serving/failover.py): the canary gang
            # already serves the new version — continue it, don't re-arm
            # (re-swapping would drain a healthy canary for nothing)
            self.scheduler.emit_event("rollout_canary", model=mid,
                                      version=ver, replica=existing[0],
                                      mode="resumed")
            return existing[0]
        victims = self.scheduler.replicas_of(mid, version=old)
        if not victims:
            raise RolloutError(f"no {mid}@{old} gang to canary against")
        promoted = self.serving.promote_standby("rollout",
                                                model=(mid, ver))
        if promoted is not None:
            # capacity constant: the incumbent gang the standby replaces
            # drains out (zero loss — the drain verbs' contract)
            self.serving.retire_replica(victims[0])
            self.scheduler.emit_event("rollout_canary", model=mid,
                                      version=ver, replica=promoted,
                                      mode="standby", retired=victims[0])
            return promoted
        self.serving.swap_replica_model(victims[0], mid, ver)
        self.scheduler.emit_event("rollout_canary", model=mid, version=ver,
                                  replica=victims[0], mode="swap")
        return victims[0]

    def _bake_and_gate(self, base: dict, old: str) -> tuple[bool, dict]:
        """Sleep out the bake window (abort-aware), then compare the
        canary's WINDOWED snapshot against the incumbent's — both sides
        see only the bake window's samples (``model_version_stats(base=
        ...)``), so the incumbent's warm-up/compile history can never
        flatter the canary.  A window with too few canary completions
        extends the bake once before passing on error rate alone."""
        pol = self.policy
        for attempt in range(3):
            deadline = time.monotonic() + pol.bake_secs
            while time.monotonic() < deadline:
                if self._stop.is_set():
                    return False, {"reason": "aborted"}
                time.sleep(min(0.1, max(0.0,
                                        deadline - time.monotonic())))
            if self._stop.is_set():
                return False, {"reason": "aborted"}
            stats = self.scheduler.model_version_stats(self.model_id,
                                                       base=base)
            cn = self._window(stats.get(self.version),
                              base.get(self.version))
            st = self._window(stats.get(old), base.get(old))
            ref = self._stable_ref
            if ref is None and st["completed"]:
                self._stable_ref = st      # first populated window
            if not st["completed"] and ref is not None:
                # a late step (e.g. 100%) leaves the incumbent no
                # window traffic: gate against the retained baseline
                # rather than skipping the latency bounds entirely
                st = ref
            elif ref is not None:
                # both exist: take the LOWER p95 per axis — a live
                # window inflated by swap-drain stalls must not mask a
                # slow canary (erring toward rollback is the safe side)
                st = {**st, **{k: min(st[k], ref[k])
                               for k in ("ttft_p95", "e2e_p95")
                               if st.get(k) is not None
                               and ref.get(k) is not None}}
            detail = {"canary": cn, "stable": st}
            n = cn["completed"] + cn["failed"]
            if n and cn["failed"] / n > pol.max_error_rate:
                detail["reason"] = (f"canary error rate {cn['failed']}/"
                                    f"{n} > {pol.max_error_rate:g}")
                return False, detail
            if n >= pol.min_samples or attempt == 2:
                break
            # thin evidence: extend the bake (bounded) before deciding
        if n < pol.min_samples:
            # still not enough canary evidence for latency ratios: pass
            # the step on error rate alone (a 0-traffic canary cannot
            # gate)
            detail["reason"] = f"insufficient samples ({n})"
            return True, detail
        for name, bound, key in (
                ("ttft", pol.max_ttft_ratio, "ttft_p95"),
                ("e2e", pol.max_e2e_ratio, "e2e_p95")):
            if bound is None:
                continue
            c, s = cn.get(key), st.get(key)
            if c is not None and s is not None and s > 0 and c / s > bound:
                detail["reason"] = (f"canary {name} p95 {c:.3f}s is "
                                    f"{c / s:.2f}x the incumbent's "
                                    f"{s:.3f}s (bound {bound:g}x)")
                return False, detail
        return True, detail

    @staticmethod
    def _window(now: dict | None, base: dict | None) -> dict:
        now, base = now or {}, base or {}
        return {
            "completed": int(now.get("completed", 0)
                             - base.get("completed", 0)),
            "failed": int(now.get("failed", 0) - base.get("failed", 0)),
            "ttft_p95": (now.get("ttft") or {}).get("p95_secs"),
            "e2e_p95": (now.get("e2e") or {}).get("p95_secs"),
        }

    def _rollback(self, canary_eid: int, old: str, detail: dict) -> None:
        """The regression path: traffic snaps back to the incumbent
        FIRST (the canary stops seeing requests within one dispatch),
        then the canary gang swaps back to the old version — the old
        version was serving the whole time."""
        mid, ver = self.model_id, self.version
        logger.warning("rollout %s@%s ROLLING BACK: %s", mid, ver,
                       detail.get("reason"))
        self.scheduler.set_traffic_split(mid, {old: 100})
        try:
            self.serving.swap_replica_model(canary_eid, mid, old)
        except Exception:  # tfos: ignore[broad-except] — a canary that
            # cannot swap back (e.g. it died of the very regression) is
            # retired instead; the incumbent gangs carry the traffic
            logger.exception("canary %d could not swap back to %s@%s; "
                             "retiring it", canary_eid, mid, old)
            with contextlib.suppress(Exception):
                self.serving.retire_replica(canary_eid)
        self.scheduler.clear_traffic_split(mid)
        self.registry.mark(mid, ver, "rolled_back")
        self.detail = dict(detail)
        self.state = "rolled_back"
        self._m_rollouts.inc(outcome="rolled_back")
        self.scheduler.emit_event("rollout_rolled_back", model=mid,
                                  version=ver, incumbent=old,
                                  reason=detail.get("reason"))
        self.scheduler.journal_record("rollout_done", model=mid,
                                      version=ver, outcome="rolled_back")
