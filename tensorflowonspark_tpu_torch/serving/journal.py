"""Write-ahead control-plane journal: the driver's durable memory.

Port of ``tensorflowonspark_tpu/serving/journal.py``: a copy.  The record
schema is the JAX package's byte for byte, so a journal written by either
package replays in the other.

Everything the serving driver knows that is not recoverable from the
workers themselves — which requests were *accepted* (the zero-loss
contract attaches at admission), where they were last routed, which
model versions exist and what state/eval verdict each carries, how far a
rollout got, and which replicas joined/died/retired — is appended here
as one fsync'd JSON line per transition, extending the
``batch/ledger.py::ProgressLedger`` idiom to the control plane.  The
advisory ``serving_events.jsonl`` stays (human/bench telemetry, lossy by
design); THIS file is the recovery source of truth: replaying it yields
the committed request set, per-model version states, and the in-flight
rollout position, so a driver death heals like a replica death does
(``serving/failover.py``).

Record grammar (all records carry ``t`` and ``kind``)::

    admit    {rid, prompt, max_new_tokens, temperature, top_p, seed,
              tenant, priority, model, trace}        # WRITE-AHEAD of accept
    route    {rid, replica}                          # last dispatch target
    commit   {rid, outcome, tokens}                  # terminal: done/failed/
                                                     #   expired/<abandon reason>
    requeue  {rid, as}                               # failover replay alias:
                                                     #   new rid `as` serves
                                                     #   original `rid`
    replica_added/replica_dead/replica_retired/replica_model   # membership
    registry_register/registry_eval/registry_state             # ModelRegistry
    registry_evict {model, version}                  # retention: payloads
                                                     #   dropped, lineage kept
    traffic_split {model, split|null}
    rollout_started {model, version, incumbent, steps}
    rollout_step {model, version, percent}           # step INTENT (pre-shift)
    rollout_step_done {model, version, percent}      # step survived its gate
    rollout_done {model, version, outcome}
    driver_resumed {requeued, replicas}              # a failover happened
    continual_candidate {model, version, flavor, step, digest, src}
                                                     # pipeline ingested a
                                                     #   published candidate
    continual_stage {model, version, stage}          # stage entered:
                                                     #   offline_eval|rollout
    continual_done {model, version, outcome}         # terminal: promoted|
                                                     #   rejected_offline|
                                                     #   rolled_back

Replay (:meth:`ControlPlaneJournal.replay`) is idempotent under
duplicate lines, tolerant of a torn tail (a crash mid-``write``), and
skips unknown kinds with ONE warning (forward compatibility: a newer
driver's journal must not wedge an older standby).  ``admit`` without a
matching ``commit`` — resolved through ``requeue`` aliases — is the
replayable obligation set.

Metrics: ``tfos_serving_journal_records_total{kind=}`` and
``tfos_serving_journal_bytes_total`` count what the journal absorbs;
the failover-duration histogram lives in ``serving/failover.py``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch import metrics as tpu_metrics

logger = logging.getLogger(__name__)

#: kinds this build folds during replay; anything else is forward-compat
#: noise (skipped, one warning per replay)
KNOWN_KINDS = frozenset({
    "admit", "route", "commit", "requeue",
    "replica_added", "replica_dead", "replica_retired", "replica_model",
    "registry_register", "registry_eval", "registry_state", "registry_evict",
    "traffic_split",
    "rollout_started", "rollout_step", "rollout_step_done", "rollout_done",
    "driver_resumed",
    "continual_candidate", "continual_stage", "continual_done",
})


class ControlPlaneJournal:
    """Append-only fsync'd JSONL journal of control-plane transitions.

    ``record`` never raises: after the first write failure the journal
    degrades to a no-op with one warning (same discipline as
    ``observability.EventLog.emit`` — losing durability must not take
    the serving path down with it), but unlike the event log every
    successful ``record`` is flushed AND fsync'd before returning, so a
    SIGKILL immediately after cannot lose it.
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._write_failed = False
        reg = tpu_metrics.get_registry()
        self._m_records = reg.counter(
            "tfos_serving_journal_records_total",
            "Control-plane journal records fsync'd, by record kind.",
            labelnames=("kind",))
        self._m_bytes = reg.counter(
            "tfos_serving_journal_bytes_total",
            "Bytes appended to the control-plane journal (incl. newlines).")

    # -- write side ------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        rec = {"t": time.time(), "kind": kind, **fields}
        try:
            line = json.dumps(rec, sort_keys=True)
        except (TypeError, ValueError):
            if not self._write_failed:
                self._write_failed = True
                logger.warning("journal record %r not JSON-serializable; "
                               "record dropped (warned once)", kind)
            return
        with self._lock:
            f = self._f
            if f is None:
                return
            try:
                f.write(line + "\n")
                f.flush()
                # the WAL contract IS fsync-before-ack under the append
                # lock: a record released before it is durable could be
                # acked, lost, and then missing from a failover replay
                os.fsync(f.fileno())  # tfos: ignore[blocking-under-lock]
            except (OSError, ValueError):
                if not self._write_failed:
                    self._write_failed = True
                    logger.warning("control-plane journal write failed; "
                                   "record lost (warned once)",
                                   exc_info=True)
                return
        self._m_records.inc(kind=str(kind))
        self._m_bytes.inc(len(line) + 1)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    # -- read side -------------------------------------------------------
    @staticmethod
    def read_records(path: str) -> list[dict]:
        """All intact records, in order.  Binary read + per-line decode:
        a torn tail (payload cut mid-JSON or mid-UTF-8 sequence, or a
        missing final newline) is skipped with a warning and never hides
        lines around it."""
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            data = f.read()
        out: list[dict] = []
        for lineno, raw in enumerate(data.split(b"\n"), 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                logger.warning("journal %s:%d: skipping torn/corrupt line",
                               path, lineno)
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @classmethod
    def replay(cls, path: str) -> "JournalState":
        return JournalState.from_records(cls.read_records(path))


class JournalState:
    """The folded journal: what a resuming driver needs to know.

    Built by :meth:`from_records`; folding is pure and idempotent —
    replaying the same record twice lands on the same state, so
    duplicated lines (retried appends, a journal copied mid-rotation)
    are harmless.
    """

    def __init__(self):
        #: original rid -> admit record (the accepted set)
        self.admitted: dict[int, dict] = {}
        #: original rid -> {"outcome", "tokens"} terminal record
        self.committed: dict[int, dict] = {}
        #: original rid -> last replica eid it was dispatched to
        self.routed: dict[int, int] = {}
        #: replay alias: new rid -> the original rid it serves
        self.aliases: dict[int, int] = {}
        #: eid -> {"alive","retired","role","model","version","members"}
        self.replicas: dict[int, dict] = {}
        #: (model_id, version) -> {"state","eval_passed","eval_metrics"}
        self.registry: dict[tuple, dict] = {}
        #: model_id -> {version: percent} split, or None (cleared)
        self.traffic: dict[str, dict | None] = {}
        #: model_id -> rollout position (see ``rollout_*`` fold below)
        self.rollouts: dict[str, dict] = {}
        #: (model_id, version) -> continual-loop candidate position
        #: {"flavor","step","digest","src","stage","outcome"}
        self.continual: dict[tuple, dict] = {}
        #: count of prior driver failovers recorded in this journal
        self.resumes = 0
        self.unknown_kinds = 0

    # -- folding ---------------------------------------------------------
    @classmethod
    def from_records(cls, records) -> "JournalState":
        st = cls()
        warned_unknown = False
        for rec in records:
            kind = rec.get("kind")
            if kind not in KNOWN_KINDS:
                st.unknown_kinds += 1
                if not warned_unknown:
                    warned_unknown = True
                    logger.warning(
                        "journal replay: skipping unknown record kind %r "
                        "(newer writer? further unknown kinds silent)", kind)
                continue
            st._fold(kind, rec)
        return st

    def _root(self, rid) -> int:
        """Resolve a (possibly re-aliased) rid to its original admission."""
        seen = set()
        while rid in self.aliases and rid not in seen:
            seen.add(rid)
            rid = self.aliases[rid]
        return rid

    def _fold(self, kind: str, rec: dict) -> None:
        if kind == "admit":
            self.admitted[int(rec["rid"])] = rec
        elif kind == "requeue":
            self.aliases[int(rec["as"])] = int(rec["rid"])
        elif kind == "route":
            self.routed[self._root(int(rec["rid"]))] = int(rec["replica"])
        elif kind == "commit":
            self.committed[self._root(int(rec["rid"]))] = {
                "outcome": rec.get("outcome"),
                "tokens": rec.get("tokens")}
        elif kind == "replica_added":
            self.replicas[int(rec["replica"])] = {
                "alive": True, "retired": False,
                "role": rec.get("role"), "model": rec.get("model"),
                "version": rec.get("version"),
                "members": rec.get("members")}
        elif kind == "replica_dead":
            ent = self.replicas.setdefault(
                int(rec["replica"]), {"retired": False})
            ent["alive"] = False
        elif kind == "replica_retired":
            ent = self.replicas.setdefault(int(rec["replica"]), {})
            ent["alive"] = False
            ent["retired"] = True
        elif kind == "replica_model":
            ent = self.replicas.setdefault(
                int(rec["replica"]), {"alive": True, "retired": False})
            ent["model"] = rec.get("model")
            ent["version"] = rec.get("version")
        elif kind == "registry_register":
            self.registry.setdefault(
                (rec["model"], rec["version"]),
                {"state": "registered", "eval_passed": None,
                 "eval_metrics": None, "evicted": False})
        elif kind == "registry_eval":
            ent = self.registry.setdefault(
                (rec["model"], rec["version"]),
                {"state": "registered", "eval_passed": None,
                 "eval_metrics": None, "evicted": False})
            ent["eval_passed"] = bool(rec.get("passed"))
            ent["eval_metrics"] = rec.get("metrics")
            if ent["eval_passed"] and ent["state"] == "registered":
                ent["state"] = "evaluated"
        elif kind == "registry_state":
            ent = self.registry.setdefault(
                (rec["model"], rec["version"]),
                {"state": "registered", "eval_passed": None,
                 "eval_metrics": None, "evicted": False})
            ent["state"] = rec.get("state")
        elif kind == "registry_evict":
            ent = self.registry.setdefault(
                (rec["model"], rec["version"]),
                {"state": "registered", "eval_passed": None,
                 "eval_metrics": None, "evicted": False})
            ent["evicted"] = True
        elif kind == "continual_candidate":
            self.continual.setdefault(
                (rec["model"], rec["version"]),
                {"flavor": rec.get("flavor"), "step": rec.get("step"),
                 "digest": rec.get("digest"), "src": rec.get("src"),
                 "stage": "received", "outcome": None})
        elif kind == "continual_stage":
            ent = self.continual.setdefault(
                (rec["model"], rec["version"]),
                {"flavor": None, "step": None, "digest": None, "src": None,
                 "stage": "received", "outcome": None})
            ent["stage"] = rec.get("stage")
        elif kind == "continual_done":
            ent = self.continual.setdefault(
                (rec["model"], rec["version"]),
                {"flavor": None, "step": None, "digest": None, "src": None,
                 "stage": "received", "outcome": None})
            ent["outcome"] = rec.get("outcome")
        elif kind == "traffic_split":
            self.traffic[rec["model"]] = rec.get("split")
        elif kind == "rollout_started":
            self.rollouts[rec["model"]] = {
                "version": rec.get("version"),
                "incumbent": rec.get("incumbent"),
                "steps": [int(s) for s in rec.get("steps") or ()],
                "done_steps": [], "intended": None, "outcome": None}
        elif kind == "rollout_step":
            r = self.rollouts.get(rec["model"])
            if r is not None and r.get("version") == rec.get("version"):
                r["intended"] = int(rec["percent"])
        elif kind == "rollout_step_done":
            r = self.rollouts.get(rec["model"])
            if r is not None and r.get("version") == rec.get("version"):
                pct = int(rec["percent"])
                if pct not in r["done_steps"]:
                    r["done_steps"].append(pct)
                if r.get("intended") == pct:
                    r["intended"] = None
        elif kind == "rollout_done":
            r = self.rollouts.get(rec["model"])
            if r is not None and r.get("version") == rec.get("version"):
                r["outcome"] = rec.get("outcome")
        elif kind == "driver_resumed":
            self.resumes += 1

    # -- derived views ---------------------------------------------------
    @property
    def unfinished(self) -> dict[int, dict]:
        """Accepted-but-uncommitted admissions: the replay obligation."""
        return {rid: rec for rid, rec in self.admitted.items()
                if rid not in self.committed}

    def open_candidates(self) -> dict[tuple, dict]:
        """Continual-loop candidates with no terminal outcome — what a
        resumed :class:`continual.ContinualPipeline` must pick back up
        (at their journaled stage, never from scratch)."""
        return {k: c for k, c in self.continual.items()
                if c.get("outcome") is None}

    def open_rollouts(self) -> dict[str, dict]:
        """Rollouts with no terminal outcome — the mid-flight ones a
        resumed driver must continue, not restart."""
        return {m: r for m, r in self.rollouts.items()
                if r.get("outcome") is None}

    def remaining_steps(self, model_id: str) -> tuple[int, ...]:
        """Canary percents still owed for ``model_id``'s open rollout:
        every planned step without a ``rollout_step_done`` — which
        re-executes a step whose intent was journaled but whose gate
        never committed (idempotent: re-setting a split is a no-op), and
        falls back to ``(100,)`` when all steps committed but the
        finishing promotion never did."""
        r = self.rollouts.get(model_id)
        if r is None:
            return ()
        done = set(r["done_steps"])
        rest = tuple(s for s in r["steps"] if s not in done)
        return rest if rest else (100,)
