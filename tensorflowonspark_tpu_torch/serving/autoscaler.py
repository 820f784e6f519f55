"""Metrics-driven autoscaling for the online serving tier.

Port of ``tensorflowonspark_tpu/serving/autoscaler.py``: a copy.

Closes the loop between the telemetry the tier already emits (scheduler
queue depth, per-replica outstanding, TTFT p95 — the PR-6 signals) and
the elastic membership primitives (``ServingCluster.add_replicas`` /
``retire_replica``).  The controller is deliberately boring: threshold
rules with **hysteresis** (a signal must persist for N consecutive
samples), **cooldowns** (independent up/down, so a scale-up's boot cost
can't immediately trigger a scale-down of the still-warming replica),
and hard **min/max bounds**.

Decision rules per sample (every ``interval`` seconds):

- **scale up** when ``queued > up_queue_per_replica x alive`` OR
  (``up_ttft_p95`` set and the scheduler's recent TTFT p95 exceeds it),
  sustained for ``up_consecutive`` samples, while
  ``alive < max_replicas`` and the up-cooldown has passed;
- **scale down** when ``queued == 0`` AND total outstanding would fit
  the survivors at ``down_outstanding_per_replica`` per replica,
  sustained for ``down_consecutive`` samples, while
  ``alive > min_replicas`` and the down-cooldown has passed.  The
  victim is the alive, non-draining replica with the fewest outstanding
  requests (highest executor id on ties — last in, first out), and the
  removal is DRAIN-BASED: no accepted request is lost.

Every action lands in ``serving_events.jsonl`` as a ``scale_up`` /
``scale_down`` event with a human-readable ``reason`` and the sampled
signals, so a trace reader can answer "why did the fleet grow at
14:03?" from the same log that carries the request lifecycle
(docs/serving.md has the scale-event taxonomy).

``decide(sample)`` is separated from the sampling/acting loop so tests
can drive the policy deterministically without threads or clusters.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoscalerConfig:
    """Knobs for :class:`Autoscaler` (docs/serving.md has the table)."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval: float = 1.0            # seconds between samples
    #: pool filter for a disaggregated tier (docs/serving.md): with
    #: ``role="prefill"`` the controller sees only prefill gangs and the
    #: PROMPT queue (plus the TTFT signal — prefill owns TTFT); with
    #: ``role="decode"`` only decode gangs and the HANDOFF queue.  The
    #: two pools therefore scale on independent signals with independent
    #: bounds/cooldowns.  None = the whole tier (unified behavior).
    role: str | None = None
    up_queue_per_replica: float = 4.0
    up_ttft_p95: float | None = None   # seconds; None = queue signal only
    up_consecutive: int = 2
    up_cooldown: float = 10.0
    up_step: int = 1
    down_outstanding_per_replica: float = 1.0
    down_consecutive: int = 5
    down_cooldown: float = 20.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            raise ValueError("hysteresis windows must be >= 1 sample")


class Autoscaler:
    """Drives ``serving`` (a :class:`~tensorflowonspark_tpu_torch.serving.
    frontend.ServingCluster`) from its scheduler's live signals.

    The sampling loop runs on a daemon thread; scale actions execute on
    that same thread (``add_replicas`` blocks on the newcomers'
    reservations, ``retire_replica`` on the drain) — sampling pauses
    while the membership change completes, which is exactly the
    hysteresis a mid-change controller needs anyway.
    """

    def __init__(self, serving, config: AutoscalerConfig | None = None,
                 **knobs):
        if config is None:
            config = AutoscalerConfig(**knobs)
        elif knobs:
            config = dataclasses.replace(config, **knobs)
        self.serving = serving
        self.cfg = config
        self.scale_ups = 0
        self.scale_downs = 0
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = 0.0      # monotonic stamps; 0 = never
        self._last_down = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        self.serving.scheduler.emit_event(
            "autoscaler_started", **{
                k: v for k, v in dataclasses.asdict(self.cfg).items()})
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    # -- policy ------------------------------------------------------------
    def sample(self) -> dict:
        """One reading of the signals the policy consumes.

        ``capacity`` / ``alive_capacity`` are DEVICE-WEIGHTED: a
        mesh-sharded tp=4 gang contributes 4 capacity units where a
        plain replica contributes 1, so the queue-pressure and
        idle-fit thresholds (configured per capacity unit) scale with
        the hardware behind each endpoint, not the endpoint count.
        ``victim_weight`` is the capacity the next scale-down would
        remove (0 when no victim is eligible)."""
        sched = self.serving.scheduler
        m = sched.metrics()
        pool = {eid: r for eid, r in m["replicas"].items()
                if self.cfg.role is None
                or r.get("role") == self.cfg.role}
        alive = [r for r in pool.values() if r["alive"]]
        routable = [r for r in alive if not r["draining"]]
        victim = self._victim(m)
        # the decode pool's backlog is the HANDOFF queue (sessions
        # awaiting adoption), the prefill pool's (and a unified tier's)
        # the prompt queue
        queued = (m.get("queued_handoffs", 0)
                  if self.cfg.role == "decode" else m["queued"])
        return {
            "alive": len(alive),
            "routable": len(routable),
            "capacity": sum(r.get("weight", 1) for r in routable),
            "alive_capacity": sum(r.get("weight", 1) for r in alive),
            "victim_weight": 0 if victim is None else victim[1],
            "queued": queued,
            "outstanding": sum(r["outstanding"] for r in pool.values()),
            "ttft_p95": m["ttft"]["p95_secs"],
        }

    def decide(self, s: dict, now: float | None = None) -> tuple[str, str]:
        """Pure policy step: ``("up"|"down"|"hold", reason)``.  Mutates
        only the hysteresis streaks and cooldown bookkeeping — the
        caller performs the action (and must call :meth:`acted`)."""
        cfg = self.cfg
        now = time.monotonic() if now is None else now
        # device-weighted capacity when the sample carries it (sharded
        # gangs); plain replica counts otherwise — identical numbers at
        # weight 1, so single-process tiers keep the historical policy
        capacity = max(1, s.get("capacity", s["routable"]))
        survivors = s.get("alive_capacity", s["alive"]) \
            - s.get("victim_weight", 1)
        up_signal = None
        if s["queued"] > cfg.up_queue_per_replica * capacity:
            up_signal = (f"queued {s['queued']} > "
                         f"{cfg.up_queue_per_replica:g}/unit x "
                         f"{capacity} capacity")
        elif (cfg.up_ttft_p95 is not None and s["ttft_p95"] is not None
                and s["ttft_p95"] > cfg.up_ttft_p95):
            up_signal = (f"ttft p95 {s['ttft_p95']:.3f}s > "
                         f"{cfg.up_ttft_p95:g}s")
        down_signal = None
        if (s["queued"] == 0 and s["alive"] > cfg.min_replicas
                and s["outstanding"] <= cfg.down_outstanding_per_replica
                * survivors):
            down_signal = (f"idle: queue empty, {s['outstanding']} "
                           f"outstanding fits {survivors} capacity units "
                           f"at {cfg.down_outstanding_per_replica:g} each")
        self._up_streak = self._up_streak + 1 if up_signal else 0
        self._down_streak = self._down_streak + 1 if down_signal else 0
        if (up_signal and self._up_streak >= cfg.up_consecutive
                and s["alive"] < cfg.max_replicas
                and now - self._last_up >= cfg.up_cooldown):
            return "up", (f"{up_signal} for {self._up_streak} samples")
        if (down_signal and self._down_streak >= cfg.down_consecutive
                and now - self._last_down >= cfg.down_cooldown):
            return "down", (f"{down_signal} for {self._down_streak} samples")
        return "hold", up_signal or down_signal or "in band"

    def acted(self, direction: str, now: float | None = None) -> None:
        """Reset hysteresis + start the cooldown after an action."""
        now = time.monotonic() if now is None else now
        self._up_streak = self._down_streak = 0
        if direction == "up":
            self._last_up = now
        else:
            self._last_down = now

    # -- acting loop -------------------------------------------------------
    def _loop(self) -> None:
        # cooldowns start armed at boot: a tier that comes up already
        # overloaded may scale immediately, but never scale DOWN before
        # one full down-cooldown of evidence
        self._last_down = time.monotonic()
        while not self._stop.wait(self.cfg.interval):
            try:
                s = self.sample()
                direction, reason = self.decide(s)
                if direction == "up":
                    self._scale_up(s, reason)
                elif direction == "down":
                    self._scale_down(s, reason)
            except Exception:   # the controller must outlive a bad sample
                logger.exception("autoscaler step failed")

    def _scale_up(self, s: dict, reason: str) -> None:
        cfg = self.cfg
        n = min(cfg.up_step, cfg.max_replicas - s["alive"])
        logger.warning("autoscaler%s: scaling UP by %d (%s)",
                       f" [{cfg.role}]" if cfg.role else "", n, reason)
        self.serving.scheduler.emit_event(
            "scale_up", replicas=n, reason=reason, role=cfg.role,
            **_signals(s))
        try:
            # prefer the tier's warm path (ServingCluster.scale_up:
            # standby promotion first, cold spawn for the remainder);
            # plain facades without it keep the historical add_replicas
            grow = getattr(self.serving, "scale_up", None)
            if grow is None:
                self.serving.add_replicas(n)
            elif cfg.role is not None:
                grow(n, role=cfg.role)
            else:
                grow(n)
            self.scale_ups += 1
        except Exception:
            logger.exception("autoscaler: scale-up failed")
            self.serving.scheduler.emit_event(
                "scale_failed", direction="up", reason=reason)
        self.acted("up")

    def _scale_down(self, s: dict, reason: str) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        logger.warning("autoscaler: scaling DOWN replica %d (%s)",
                       victim, reason)
        self.serving.scheduler.emit_event(
            "scale_down", replica=victim, reason=reason,
            role=self.cfg.role, **_signals(s))
        try:
            self.serving.retire_replica(victim)
            self.scale_downs += 1
        except Exception:
            logger.exception("autoscaler: scale-down failed")
            self.serving.scheduler.emit_event(
                "scale_failed", direction="down", reason=reason)
        self.acted("down")

    def _victim(self, m: dict) -> tuple[int, int] | None:
        """THE scale-down victim rule, shared by ``sample`` (its weight
        feeds the survivor-capacity math) and ``_scale_down`` (the
        actual retire): least-loaded alive non-draining replica, highest
        id on ties (newest goes first, keeping the founding members
        warm); None while at/below the floor.  Returns ``(eid,
        capacity_weight)``."""
        candidates = [(r["outstanding"], -eid, eid, r.get("weight", 1))
                      for eid, r in m["replicas"].items()
                      if r["alive"] and not r["draining"]
                      and (self.cfg.role is None
                           or r.get("role") == self.cfg.role)]
        if len(candidates) <= self.cfg.min_replicas:
            return None
        _, _, eid, weight = min(candidates)
        return eid, weight

    def _pick_victim(self) -> int | None:
        victim = self._victim(self.serving.scheduler.metrics())
        return None if victim is None else victim[0]


def _signals(s: dict) -> dict:
    return {"queued": s["queued"], "outstanding": s["outstanding"],
            "alive": s["alive"],
            "ttft_p95_secs": None if s["ttft_p95"] is None
            else round(s["ttft_p95"], 6)}
