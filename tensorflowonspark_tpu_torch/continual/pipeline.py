"""The standing train→eval→rollout loop driver.

Port of ``tensorflowonspark_tpu/continual/pipeline.py``.
:class:`ContinualPipeline` runs the production scenario: a training
cluster continuously emits candidates
(:mod:`~tensorflowonspark_tpu_torch.continual.publisher`), each candidate is
gated OFFLINE by the batch plane (``GridSearch`` over a held-out eval
manifest → ``ModelRegistry.record_eval`` / ``promotable()``), and only
a passing candidate is canaried LIVE by ``RolloutController`` under the
windowed metrics gates with auto-rollback.  An unvetted version can
never reach a user: the rollout controller refuses versions without a
passing eval, and the offline gate runs before any traffic shift.

Durability: every lifecycle transition journals to the serving tier's
write-ahead control-plane journal (``continual_candidate`` /
``continual_stage`` / ``continual_done`` records), and ingested payloads
are persisted to a local store (atomic ``.npz`` rename) — so a driver
failover (``serving.resume_driver``) resumes the loop MID-STAGE via
:meth:`ContinualPipeline.resume`: a candidate mid-eval re-evaluates, a
candidate mid-rollout continues from its journaled canary step
(``resume_rollouts``), and a finished candidate is never re-emitted or
double-promoted (the journal is the dedupe).

Stage lifecycle (one candidate)::

    received ──> offline_eval ──────────────> rollout ──> promoted
       │              │                          │
       │              └──> rejected_offline      └──> rolled_back
       └ (corrupt/duplicate publications never get this far)

Metrics: ``tfos_continual_stage_seconds{stage=}`` and
``tfos_continual_versions_total{outcome=promoted|rejected_offline|
rolled_back}``; the publisher/collector side counts
``tfos_continual_publications_total{outcome=}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch import metrics as _metrics
from tensorflowonspark_tpu_torch.continual.publisher import (
    CONTINUAL_QUEUES, PUBLISH_QUEUE, Publication, PublicationCollector,
    build_published_full, payload_digest)

logger = logging.getLogger(__name__)

#: terminal outcomes (the ``tfos_continual_versions_total`` label set)
OUTCOMES = ("promoted", "rejected_offline", "rolled_back")


@dataclasses.dataclass
class OfflineEval:
    """The offline gate's configuration: score each candidate with a
    :class:`~tensorflowonspark_tpu_torch.batch.gridsearch.GridSearch` over a
    held-out eval manifest.

    ``predict_fn(model, records, trial_params)`` is the batch plane's
    normal per-shard hook; ``trial_params["continual_candidate"]``
    carries the candidate (``{"model","version","flavor","payload",
    "serve_args"}``) so the eval worker applies the delta / published
    weights over its ``model_builder``-built base before predicting.
    ``scorer(results) -> (metrics_dict, passed)`` renders the verdict
    (recorded via ``ModelRegistry.record_eval`` — the gate
    ``RolloutController`` enforces)."""

    manifest: object
    output_dir: str
    predict_fn: object
    scorer: object
    num_workers: int = 1
    #: extra :class:`~tensorflowonspark_tpu_torch.batch.job.BatchJob`
    #: constructor kwargs (``batch_size=``, ``model_builder=``, ...)
    job_kwargs: dict = dataclasses.field(default_factory=dict)
    #: extra ``BatchJob.run`` kwargs for the eval cluster boot
    #: (``worker_env=``, ``reservation_timeout=``, ...)
    run_kwargs: dict = dataclasses.field(default_factory=dict)


def candidate_trial_params(pub: Publication) -> dict:
    """The GridSearch trial-params dict handed to the eval
    ``predict_fn`` for one candidate."""
    return {"continual_candidate": {
        "model": pub.model, "version": pub.version, "flavor": pub.flavor,
        "payload": pub.payload, "serve_args": pub.serve_args}}


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in str(name))


class ContinualPipeline:
    """Drive received candidates through gate → rollout on one serving
    tier (module docstring).

    - ``serving``: a live ``ServingCluster`` booted with a
      ``ModelRegistry`` and (for durability) a journal.
    - ``model_id``: the model this loop owns; publications for other
      models are left for another pipeline.
    - ``base_builder``: the pristine base's picklable builder — required
      for adapter candidates (the delta's base) and full candidates
      (tree structure for :func:`build_published_full`).
    - ``eval_spec``: the :class:`OfflineEval` gate; ``None`` accepts a
      pre-recorded eval verdict only (``record_eval`` by other means) —
      candidates without one are REJECTED, never silently promoted.
    - ``policy``: the live gate's ``RolloutPolicy``.
    - ``store_dir``: payload store for failover re-hydration (defaults
      to ``<journal dir>/continual_store`` when the tier journals,
      else disabled).
    """

    def __init__(self, serving, model_id: str, *, base_builder=None,
                 eval_spec: OfflineEval | None = None, policy=None,
                 store_dir: str | None = None,
                 qname: str = PUBLISH_QUEUE):
        if serving.registry is None:
            raise ValueError("ContinualPipeline needs a serving tier with "
                             "a ModelRegistry (ServingCluster.run("
                             "registry=...))")
        self.serving = serving
        self.registry = serving.registry
        self.model_id = str(model_id)
        self.base_builder = base_builder
        self.eval_spec = eval_spec
        self.policy = policy
        self.qname = str(qname)
        if store_dir is None:
            jpath = getattr(serving.scheduler, "journal", None)
            jpath = getattr(jpath, "path", None)
            if jpath:
                store_dir = os.path.join(os.path.dirname(jpath),
                                         "continual_store")
        self.store_dir = store_dir
        reg = _metrics.get_registry()
        self._h_stage = reg.histogram(
            "tfos_continual_stage_seconds",
            "Continual-loop stage wall time by stage.",
            labelnames=("stage",))
        self._m_versions = reg.counter(
            "tfos_continual_versions_total",
            "Continual-loop candidates by terminal outcome.",
            labelnames=("outcome",))

    # -- journal helpers ---------------------------------------------------
    def _jrecord(self, kind: str, **fields) -> None:
        rec = getattr(self.serving.scheduler, "journal_record", None)
        if rec is not None:
            rec(kind, **fields)

    def _finish(self, version: str, outcome: str) -> str:
        self._jrecord("continual_done", model=self.model_id,
                      version=version, outcome=outcome)
        if outcome in OUTCOMES:
            self._m_versions.inc(outcome=outcome)
        logger.info("continual: %s@%s -> %s", self.model_id, version,
                    outcome)
        return outcome

    # -- payload store -----------------------------------------------------
    def _store_path(self, version: str) -> str | None:
        if not self.store_dir:
            return None
        return os.path.join(self.store_dir,
                            f"{_slug(self.model_id)}@{_slug(version)}.npz")

    def _store(self, pub: Publication) -> None:
        """Persist the payload for failover re-hydration — atomic
        (tmp + rename), so a crash mid-write leaves no readable partial
        and the candidate (journaled only AFTER the store) is simply
        re-publishable."""
        path = self._store_path(pub.version)
        if path is None:
            return
        os.makedirs(self.store_dir, exist_ok=True)
        meta = {"model": pub.model, "version": pub.version,
                "flavor": pub.flavor, "step": pub.step,
                "serve_args": pub.serve_args, "metadata": pub.metadata,
                "digest": pub.digest, "src": pub.src, "seq": pub.seq}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.array(json.dumps(meta)),
                     **{f"leaf:{k}": np.asarray(v)
                        for k, v in pub.payload.items()})
        os.replace(tmp, path)

    def load_publication(self, version: str) -> Publication | None:
        """Re-hydrate a stored candidate (digest re-verified)."""
        path = self._store_path(version)
        if path is None or not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            payload = {k[len("leaf:"):]: z[k] for k in z.files
                       if k.startswith("leaf:")}
        if payload_digest(payload) != meta.get("digest"):
            logger.warning("stored payload for %s@%s fails its digest; "
                           "discarding", self.model_id, version)
            return None
        return Publication(model=meta["model"], version=meta["version"],
                           flavor=meta["flavor"], step=int(meta["step"]),
                           payload=payload,
                           serve_args=dict(meta.get("serve_args") or {}),
                           metadata=dict(meta.get("metadata") or {}),
                           digest=meta["digest"], src=int(meta["src"]),
                           seq=int(meta["seq"]))

    # -- candidate lifecycle ----------------------------------------------
    def _register(self, pub: Publication) -> None:
        metadata = {**pub.metadata, "step": pub.step, "digest": pub.digest,
                    "flavor": pub.flavor, "src": pub.src}
        if pub.flavor == "adapter":
            if self.base_builder is None:
                raise ValueError(
                    "adapter candidates need ContinualPipeline("
                    "base_builder=...) — the delta's pristine base")
            self.registry.register(pub.model, pub.version,
                                   base=self.base_builder,
                                   adapter=pub.payload,
                                   serve_args=pub.serve_args,
                                   metadata=metadata)
        else:
            if self.base_builder is None:
                raise ValueError(
                    "full candidates need ContinualPipeline("
                    "base_builder=...) — the published leaves are applied "
                    "over its tree structure")
            serve_args = {**pub.serve_args,
                          "serve_base_builder": self.base_builder,
                          "serve_published_params": pub.payload}
            self.registry.register(pub.model, pub.version,
                                   builder=build_published_full,
                                   serve_args=serve_args,
                                   metadata=metadata)

    def process(self, pub: Publication) -> str | None:
        """Run ONE candidate through the full loop: register → offline
        gate → live rollout.  Returns the terminal outcome
        (``promoted`` / ``rejected_offline`` / ``rolled_back``), or
        None for a duplicate/foreign publication.  Synchronous — the
        loop is serial by design: one candidate's canary must finish
        before the next may shift traffic."""
        if pub.model != self.model_id:
            logger.info("continual: ignoring publication for foreign "
                        "model %s@%s", pub.model, pub.version)
            return None
        if pub.version in self.registry.versions(self.model_id):
            logger.info("continual: %s@%s already registered; duplicate "
                        "emission dropped", pub.model, pub.version)
            return None
        t0 = time.monotonic()
        self._store(pub)
        self._register(pub)
        # journal AFTER store+register: a candidate is only "emitted"
        # once it is re-hydratable — a crash before this line loses
        # nothing (the trainer's next publish of this version re-ingests)
        self._jrecord("continual_candidate", model=pub.model,
                      version=pub.version, flavor=pub.flavor,
                      step=pub.step, digest=pub.digest, src=pub.src)
        self._h_stage.record(time.monotonic() - t0, stage="ingest")
        if not self._offline_gate(pub.version, pub):
            return self._finish(pub.version, "rejected_offline")
        return self._rollout(pub.version)

    def _offline_gate(self, version: str, pub: Publication | None) -> bool:
        """The offline stage: score the candidate on the held-out
        manifest; True iff promotable."""
        self._jrecord("continual_stage", model=self.model_id,
                      version=version, stage="offline_eval")
        t0 = time.monotonic()
        try:
            entry = self.registry.version(self.model_id, version)
            if self.eval_spec is None:
                # no harness: accept only a verdict recorded out of band
                return bool(entry.eval_passed)
            if entry.eval_passed is not None:
                # already scored (a resume mid-eval re-enters here; the
                # recorded verdict stands)
                return bool(entry.eval_passed)
            if pub is None:
                pub = self.load_publication(version)
            if pub is None:
                logger.warning("continual: no payload for %s@%s — cannot "
                               "score; rejecting", self.model_id, version)
                self.registry.record_eval(self.model_id, version,
                                          {"error": "payload_lost"}, False)
                return False
            from tensorflowonspark_tpu_torch.batch.gridsearch import GridSearch

            spec = self.eval_spec
            out_dir = os.path.join(
                spec.output_dir, f"{_slug(self.model_id)}@{_slug(version)}")
            gs = GridSearch(spec.manifest, out_dir, spec.predict_fn,
                            [candidate_trial_params(pub)],
                            **spec.job_kwargs)
            gs.run(spec.num_workers, **spec.run_kwargs)
            return bool(self.registry.evaluate_grid(
                self.model_id, version, gs, "t0", spec.scorer))
        finally:
            self._h_stage.record(time.monotonic() - t0,
                                 stage="offline_eval")

    def _rollout(self, version: str) -> str:
        """The live stage: canary + windowed gates + auto-rollback."""
        self._jrecord("continual_stage", model=self.model_id,
                      version=version, stage="rollout")
        t0 = time.monotonic()
        try:
            ctl = self.serving.rollout(self.model_id, version,
                                       policy=self.policy, block=True)
        finally:
            self._h_stage.record(time.monotonic() - t0, stage="rollout")
        outcome = ("promoted" if ctl.state == "promoted"
                   else "rolled_back")
        return self._finish(version, outcome)

    # -- the standing loop -------------------------------------------------
    def run(self, trainer_fn, tf_args, num_workers: int, *, data=None,
            num_epochs: int = 1, queues=CONTINUAL_QUEUES,
            poll_interval: float = 0.5, max_restarts: int = 2,
            on_outcome=None, **run_kwargs) -> dict:
        """The full supervised loop: boot the training cluster under
        ``run_with_recovery`` (worker deaths heal by relaunch; already-
        processed candidates dedupe through the registry), drain
        publications as the trainer emits them, and drive each through
        :meth:`process` while the serving tier keeps taking traffic.
        Returns ``{(model, version): outcome}``.

        ``trainer_fn(args, ctx)`` is a normal map_fun that builds a
        :class:`~tensorflowonspark_tpu_torch.continual.publisher.
        CheckpointPublisher`; ``data`` (optional) is fed via
        ``cluster.train`` on a background thread.  The loop ends when
        every trainer worker exits."""
        from tensorflowonspark_tpu_torch.cluster import run_with_recovery

        outcomes: dict[tuple, str] = {}

        def _drive(cluster):
            collector = PublicationCollector(cluster, qname=self.qname)
            for ver in self.registry.versions(self.model_id):
                collector.mark_seen(self.model_id, ver)
            feeder = None
            if data is not None:
                feeder = threading.Thread(
                    target=cluster.train, args=(data, num_epochs),
                    name="continual-feed", daemon=True)
                feeder.start()
            try:
                while True:
                    for pub in collector.poll():
                        out = self.process(pub)
                        if out is not None:
                            outcomes[(pub.model, pub.version)] = out
                            if on_outcome is not None:
                                on_outcome(pub, out)
                    codes = cluster.backend.exitcodes()
                    if codes and all(c is not None for c in codes.values()):
                        for pub in collector.poll():  # final drain
                            out = self.process(pub)
                            if out is not None:
                                outcomes[(pub.model, pub.version)] = out
                                if on_outcome is not None:
                                    on_outcome(pub, out)
                        break
                    time.sleep(poll_interval)
            finally:
                collector.close()
            return set()

        run_with_recovery(trainer_fn, tf_args, num_workers,
                          max_restarts=max_restarts, queues=queues,
                          driver_fn=_drive, **run_kwargs)
        return outcomes

    # -- failover ----------------------------------------------------------
    def resume(self, state=None) -> dict:
        """Resume open candidates at their journaled stage after a
        driver failover: call on a pipeline rebuilt around
        ``resume_driver``'s ServingCluster (whose ``resume_state``
        carries the replayed journal).  A candidate mid-``offline_eval``
        re-scores (or adopts its already-recorded verdict); one
        mid-``rollout`` continues from its journaled canary position
        via ``resume_rollouts`` — never from scratch, and a candidate
        with a terminal ``continual_done`` is untouched (no double
        promotion).  Returns ``{(model, version): outcome}`` for the
        candidates this call settled."""
        if state is None:
            state = getattr(self.serving, "resume_state", None)
        if state is None:
            raise ValueError("resume needs a JournalState — resume the "
                             "driver first (resume_driver) or pass "
                             "state= explicitly")
        results: dict[tuple, str] = {}
        for (mid, ver), cand in sorted(state.open_candidates().items()):
            if mid != self.model_id:
                continue
            pub = None
            if ver not in self.registry.versions(mid):
                pub = self.load_publication(ver)
                if pub is None:
                    logger.warning(
                        "continual: open candidate %s@%s has no stored "
                        "payload — awaiting re-publication", mid, ver)
                    continue
                self._register(pub)
                jent = state.registry.get((mid, ver))
                if jent is not None \
                        and jent.get("eval_passed") is not None:
                    # the offline verdict was journaled before the crash,
                    # but the resumed registry's adopt() ran before this
                    # re-registration and had to skip it — restore it so
                    # a mid-rollout candidate is still vetted
                    self.registry.record_eval(
                        mid, ver, jent.get("eval_metrics") or {},
                        jent["eval_passed"])
            stage = cand.get("stage") or "received"
            logger.info("continual: resuming %s@%s from stage %r",
                        mid, ver, stage)
            if stage == "rollout":
                results[(mid, ver)] = self._resume_rollout(state, ver)
            else:
                if not self._offline_gate(ver, pub):
                    results[(mid, ver)] = self._finish(
                        ver, "rejected_offline")
                else:
                    results[(mid, ver)] = self._rollout(ver)
        return results

    def _resume_rollout(self, state, version: str) -> str:
        """Continue (or conclude) a candidate whose rollout stage was
        already entered when the driver died."""
        from tensorflowonspark_tpu_torch.serving.failover import resume_rollouts

        rolled = state.rollouts.get(self.model_id)
        if rolled is not None and rolled.get("version") == version \
                and rolled.get("outcome") is not None:
            # the rollout concluded but the driver died before the
            # continual_done record: just finalize
            outcome = ("promoted" if rolled["outcome"] == "promoted"
                       else "rolled_back")
            return self._finish(version, outcome)
        open_r = state.open_rollouts().get(self.model_id)
        if open_r is not None and open_r.get("version") == version:
            t0 = time.monotonic()
            try:
                ctls = resume_rollouts(self.serving, state,
                                       policy=self.policy, block=True)
            finally:
                self._h_stage.record(time.monotonic() - t0,
                                     stage="rollout")
            ctl = next((c for c in ctls
                        if c.model_id == self.model_id
                        and c.version == version), None)
            if ctl is None:
                raise RuntimeError(
                    f"journal says {self.model_id}@{version} is "
                    "mid-rollout but resume_rollouts did not continue it")
            outcome = ("promoted" if ctl.state == "promoted"
                       else "rolled_back")
            return self._finish(version, outcome)
        # stage journaled but rollout_started never committed: run fresh
        return self._rollout(version)
