"""The port's online serving tier (``tensorflowonspark_tpu_torch/serving``).

- **unit** — the JAX package's ``tests/test_serving_cluster.py`` unit
  cases (``ReplicaScheduler`` + ``ServeFrontend``/``ServeClient`` and the
  warm-standby races against deterministic in-process fake replicas),
  run against the port's copies (the autoscaler, journal, rollout and
  disagg cases are in ``test_torch_rollout.py``, ``test_torch_journal.py``
  and ``test_torch_disagg.py``, the gang cases in
  ``test_torch_sharded_serving.py``);
- **cross-package** — one seeded fake-world scenario (routing, shedding,
  a deadline, a replica death with requeue) through the JAX package's
  scheduler and the port's: the same outcomes and event kinds;
- **end to end** — a real tier on the CPU (2 layers, hidden 32): two
  replicas and a warm standby, replica 1 SIGKILLed by ``TFOS_CHAOS``, the
  standby promoted; every stream equal to the JAX package's
  ``greedy_generate`` on the flax weights the workers get as numpy;
- the mesh-sharded gang options of ``ServingCluster.run`` together with
  warm standbys, not ported yet, raise ``NotImplementedError``.
"""

import threading
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.serving import (DeadlineExceeded, RequestRejected,
                                                 ServeClient, ServeFrontend)
from tests.torch_serving_world import _collect, _fake_tokens, _FakeWorld, _scheduler



# ------------------------------------------------------- scheduler units

def test_scheduler_routes_and_completes():
    world = _FakeWorld(2)
    s = _scheduler(world).start()
    try:
        prompts = [np.arange(1, 4 + i, dtype=np.int32) for i in range(6)]
        reqs = [s.submit(p, 5) for p in prompts]
        for req, p in zip(reqs, prompts):
            toks, err = _collect(req)
            assert err is None and toks == _fake_tokens(p, 5)
        m = s.metrics()
        assert m["accepted"] == m["completed"] == 6
        assert m["shed"] == m["failed"] == m["requeued"] == 0
        assert m["ttft"]["count"] == 6 and m["e2e"]["p99_secs"] is not None
        # least-outstanding routing spread work over both replicas
        assert all(r["served"] > 0 for r in m["replicas"].values())
    finally:
        s.stop()


def test_routing_tie_breaks_on_kv_page_pressure():
    """Equal outstanding + equal reported load: the replica reporting
    MORE free KV pages wins the route (memory pressure tie-break); both
    primary keys still outrank it."""
    from types import SimpleNamespace

    world = _FakeWorld(2)
    s = _scheduler(world)            # policy unit: never started
    try:
        a, b = s.replicas[0], s.replicas[1]
        # replicas report page capacity on the response wire
        s._handle_response(a, {"rid": None, "event": "",
                               "load": 0, "free_pages": 2})
        s._handle_response(b, {"rid": None, "event": "",
                               "load": 0, "free_pages": 9})
        assert s.metrics()["replicas"][1]["free_pages"] == 9
        with s._lock:
            assert s._pick_replica() is b
        # fewer outstanding outranks page pressure...
        b.outstanding[99] = SimpleNamespace(finished=True)
        with s._lock:
            assert s._pick_replica() is a
        b.outstanding.clear()
        # ...and so does lower self-reported load
        a.reported_load, b.reported_load = 0, 3
        with s._lock:
            assert s._pick_replica() is a
    finally:
        s.stop()


def test_scheduler_sheds_at_bounded_depth():
    world = _FakeWorld(1, token_delay=0.2)   # slow: backlog builds
    s = _scheduler(world, slots_per_replica=1, overcommit=1,
                   max_queue_depth=2).start()
    try:
        a = s.submit(np.asarray([1], np.int32), 3)
        b = s.submit(np.asarray([2], np.int32), 3)
        with pytest.raises(RequestRejected) as ei:
            s.submit(np.asarray([3], np.int32), 3)
        assert ei.value.reason == "queue_full"
        assert s.metrics()["shed"] == 1
        for req in (a, b):                   # accepted work still completes
            _, err = _collect(req)
            assert err is None
    finally:
        s.stop()


def test_scheduler_expires_queued_request_past_deadline():
    world = _FakeWorld(1, token_delay=0.2)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    try:
        blocker = s.submit(np.asarray([1], np.int32), 4)  # owns the slot
        late = s.submit(np.asarray([2], np.int32), 4, timeout=0.05)
        toks, err = _collect(late)
        assert err is not None and err[1] == "deadline" and toks == []
        assert s.metrics()["expired"] == 1
        _, err = _collect(blocker)
        assert err is None
    finally:
        s.stop()


def test_replica_death_requeues_once_with_exact_stream():
    """Kill the replica serving a request mid-stream: the request replays
    on the survivor and the client-visible stream is the exact oracle
    sequence with no duplicates or gaps (skip-dedup across failover)."""
    world = _FakeWorld(2, token_delay=0.05)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    try:
        p = np.asarray([3, 5], np.int32)
        req = s.submit(p, 8)
        # wait until some tokens flowed, then kill the serving replica
        while not req.tokens:
            time.sleep(0.01)
        victim = req.replica
        world.kill(victim)
        toks, err = _collect(req, timeout=15)
        assert err is None
        assert toks == _fake_tokens(p, 8), "failover stream not exact"
        m = s.metrics()
        assert m["requeued"] == 1 and m["completed"] == 1
        assert not m["replicas"][victim]["alive"]
        assert s.dead_replicas() == {victim}
    finally:
        s.stop()


def test_trace_id_survives_requeue_failover(tmp_path):
    """End-to-end tracing across the failover path: the trace id stamped
    at admission survives the requeue-once hop to the surviving replica,
    and ``tracing.stitch_trace`` reconstructs the full
    admission → route → first-token → requeue → re-route → done timeline
    (with the untraced ``replica_dead`` folded in as context)."""
    from tensorflowonspark_tpu_torch import tracing
    from tensorflowonspark_tpu_torch.observability import EventLog

    world = _FakeWorld(2, token_delay=0.05)
    log = EventLog(str(tmp_path / "serving_events.jsonl"))
    s = _scheduler(world, slots_per_replica=1, overcommit=1,
                   event_log=log).start()
    try:
        p = np.asarray([3, 5], np.int32)
        trace = tracing.new_trace_id()
        req = s.submit(p, 8, trace=trace)
        assert req.trace == trace
        assert req.message()["trace"] == trace   # rides the wire message
        while not req.tokens:
            time.sleep(0.01)
        victim = req.replica
        world.kill(victim)
        toks, err = _collect(req, timeout=15)
        assert err is None and toks == _fake_tokens(p, 8)
    finally:
        s.stop()
        log.close()

    timeline = tracing.stitch_trace(str(tmp_path), trace)
    kinds = [r["kind"] for r in timeline if not r.get("_context")]
    assert kinds[0] == "request_admitted" and kinds[-1] == "request_done"
    routed = [r for r in timeline if r["kind"] == "request_routed"]
    assert len(routed) == 2, "expected a route before and after failover"
    assert routed[0]["replica"] == victim != routed[1]["replica"]
    assert [r["attempt"] for r in routed] == [1, 2]
    (requeued,) = [r for r in timeline if r["kind"] == "request_requeued"]
    assert requeued["from_replica"] == victim and requeued["trace"] == trace
    assert all(r["trace"] == trace for r in timeline
               if not r.get("_context"))
    # the replica kill that explains the hop appears as a context row
    assert any(r["kind"] == "replica_dead" and r.get("_context")
               for r in timeline)
    # and the CLI-facing formatter renders it
    text = tracing.format_timeline(timeline)
    assert "request_requeued" in text and "[context]" in text


def test_scheduler_registry_series_update(tmp_path):
    """The scheduler's registry instruments: outcome counters tick and
    the collect hook mirrors queue depth / per-replica gauges into a
    snapshot."""
    from tensorflowonspark_tpu_torch import metrics as tpu_metrics

    world = _FakeWorld(2)
    s = _scheduler(world).start()
    reg = tpu_metrics.get_registry()
    c = reg.counter("tfos_serving_requests_total",
                    labelnames=("outcome", "model"))
    accepted0 = c.value(outcome="accepted", model="default")
    completed0 = c.value(outcome="completed", model="default")
    try:
        req = s.submit(np.asarray([1, 2], np.int32), 4)
        _, err = _collect(req)
        assert err is None
        # single-model tiers collapse to the model="default" series
        assert c.value(outcome="accepted", model="default") == accepted0 + 1
        assert c.value(outcome="completed",
                       model="default") == completed0 + 1
        snap = reg.snapshot()    # runs the collect hook
        outst = {tuple(sorted(lbl.items())): v for lbl, v in
                 snap["tfos_serving_replica_outstanding_count"]["samples"]}
        assert (("replica", "0"),) in outst and (("replica", "1"),) in outst
        assert snap["tfos_serving_replicas_alive_count"]["samples"] \
            == [[{}, 2.0]]
        ((_, ttft),) = snap["tfos_serving_ttft_seconds"]["samples"]
        assert ttft["count"] >= 1
        # a dead replica's series are removed, not frozen at last value
        world.kill(1)
        deadline = time.monotonic() + 5
        while 1 not in s.dead_replicas() and time.monotonic() < deadline:
            time.sleep(0.02)
        snap = reg.snapshot()
        labels = [lbl for lbl, _ in
                  snap["tfos_serving_replica_outstanding_count"]["samples"]]
        assert {"replica": "0"} in labels and {"replica": "1"} not in labels
        assert snap["tfos_serving_replicas_alive_count"]["samples"] \
            == [[{}, 1.0]]
    finally:
        s.stop()


def test_replica_death_beyond_requeue_limit_fails_typed():
    world = _FakeWorld(2, token_delay=0.05)
    s = _scheduler(world, slots_per_replica=1, overcommit=1,
                   requeue_limit=0).start()
    try:
        req = s.submit(np.asarray([4], np.int32), 8)
        while not req.tokens:
            time.sleep(0.01)
        world.kill(req.replica)
        _, err = _collect(req, timeout=15)
        assert err is not None and err[1] == "replica_failed"
        assert s.metrics()["failed"] == 1
    finally:
        s.stop()


def test_last_replica_death_fails_no_replica_and_rejects_submits():
    world = _FakeWorld(1, token_delay=0.05)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    try:
        req = s.submit(np.asarray([5], np.int32), 8)
        while not req.tokens:
            time.sleep(0.01)
        world.kill(0)
        _, err = _collect(req, timeout=15)
        assert err is not None and err[1] == "no_replica"
        with pytest.raises(RequestRejected) as ei:
            s.submit(np.asarray([6], np.int32), 2)
        assert ei.value.reason == "no_replica"
    finally:
        s.stop()


def test_monitor_failure_subscription_marks_dead():
    """on_cluster_failure (the ClusterMonitor hook) retires the implicated
    replica even when its process looks alive (the hang shape)."""
    from tensorflowonspark_tpu_torch.health import HANG, ClusterFailure

    world = _FakeWorld(2)
    s = _scheduler(world).start()
    try:
        s.on_cluster_failure(ClusterFailure(HANG, "wedged", (1,)))
        assert s.dead_replicas() == {1}
        # traffic keeps flowing on the survivor
        req = s.submit(np.asarray([9], np.int32), 3)
        toks, err = _collect(req)
        assert err is None and toks == _fake_tokens([9], 3)
    finally:
        s.stop()


def test_scheduler_stop_rejects_and_errors_leftovers():
    world = _FakeWorld(1, token_delay=0.3)
    s = _scheduler(world).start()
    req = s.submit(np.asarray([1, 2], np.int32), 5)
    s.stop()
    _, err = _collect(req)
    assert err is not None and err[1] == "shutdown"
    with pytest.raises(RequestRejected) as ei:
        s.submit(np.asarray([1], np.int32), 1)
    assert ei.value.reason == "shutdown"


# --------------------------------------------- tenant admission units

def test_token_bucket_rate_and_burst():
    from tensorflowonspark_tpu_torch.serving import TokenBucket

    b = TokenBucket(rate=2.0, burst=3)
    t = 100.0
    assert [b.try_take(t) for _ in range(4)] == [True, True, True, False]
    assert b.try_take(t + 0.5)            # 0.5s x 2/s = 1 token back
    assert not b.try_take(t + 0.5)
    # refill caps at burst, no matter how long idle
    assert [b.try_take(t + 100.0) for _ in range(4)] \
        == [True, True, True, False]


def test_tenant_throttle_sheds_only_the_noisy_tenant():
    """Acceptance: per-tenant shed hits ONLY the over-budget tenant —
    the noisy tenant's burst exhausts its bucket and gets typed
    ``tenant_throttled`` rejections while the quiet tenant's requests,
    submitted between the noisy ones, all sail through."""
    world = _FakeWorld(2)
    s = _scheduler(world, max_queue_depth=256,
                   tenants={"noisy": {"rate": 0.001, "burst": 3},
                            "quiet": {"rate": None}}).start()
    try:
        accepted, shed = [], []
        for k in range(8):
            try:
                accepted.append(
                    s.submit(np.asarray([k + 1], np.int32), 2,
                             tenant="noisy"))
            except RequestRejected as e:
                assert e.reason == "tenant_throttled"
                assert "noisy" in str(e)
                shed.append(k)
            # interleaved quiet traffic is never shed
            accepted.append(s.submit(np.asarray([50 + k], np.int32), 2,
                                     tenant="quiet"))
        assert len(shed) == 5            # burst of 3 admitted, rest shed
        for req in accepted:
            _, err = _collect(req)
            assert err is None
        m = s.metrics()
        assert m["tenants"]["noisy"]["shed"] == 5
        assert m["tenants"]["noisy"]["accepted"] == 3
        assert m["tenants"]["quiet"]["shed"] == 0
        assert m["tenants"]["quiet"]["accepted"] == 8
        assert m["shed"] == 5 and m["failed"] == 0
    finally:
        s.stop()


def test_priority_classes_order_the_pending_queue():
    """With one busy slot, later-admitted high-priority work dispatches
    ahead of earlier low-priority work (FIFO within a class)."""
    world = _FakeWorld(1, token_delay=0.1)
    s = _scheduler(world, slots_per_replica=1, overcommit=1,
                   max_queue_depth=16,
                   tenants={"batch": {"priority": "low"},
                            "inter": {"priority": "high"}}).start()
    try:
        blocker = s.submit(np.asarray([1], np.int32), 3)   # owns the slot
        low = [s.submit(np.asarray([10 + k], np.int32), 2, tenant="batch")
               for k in range(2)]
        high = s.submit(np.asarray([30], np.int32), 2, tenant="inter")
        for req in (blocker, high, *low):
            _, err = _collect(req)
            assert err is None
        assert high.priority == "high" and low[0].priority == "low"
        # the replica is strictly serial, so first-token times reflect
        # dispatch order: high (admitted LAST) ran before both lows
        assert high.first_token_at < low[0].first_token_at \
            < low[1].first_token_at
        assert s.metrics()["completed"] == 4
    finally:
        s.stop()


def test_priority_override_can_only_demote():
    world = _FakeWorld(1)
    s = _scheduler(world, tenants={"t": {"priority": "normal"}}).start()
    try:
        up = s.submit(np.asarray([1], np.int32), 1, tenant="t",
                      priority="high")
        down = s.submit(np.asarray([2], np.int32), 1, tenant="t",
                        priority="low")
        assert up.priority == "normal"      # promotion denied
        assert down.priority == "low"       # demotion honored
        with pytest.raises(ValueError):
            s.submit(np.asarray([3], np.int32), 1, priority="urgent")
        for req in (up, down):
            _, err = _collect(req)
            assert err is None
    finally:
        s.stop()


# --------------------------------------------- elastic membership units

def test_live_add_replica_takes_traffic():
    world = _FakeWorld(1)
    s = _scheduler(world).start()
    try:
        _, err = _collect(s.submit(np.asarray([1], np.int32), 3))
        assert err is None
        s.add_replica(world.add_replica())
        assert s.alive_replicas() == {0, 1}
        # saturate: enough parallel work that least-outstanding routing
        # must spill onto the newcomer
        reqs = [s.submit(np.asarray([k + 2], np.int32), 3)
                for k in range(8)]
        for req in reqs:
            _, err = _collect(req)
            assert err is None
        m = s.metrics()
        assert m["replicas"][1]["served"] > 0, "newcomer got no traffic"
        with pytest.raises(ValueError):
            s.add_replica(world.cluster_info[1])   # double registration
    finally:
        s.stop()


def test_drain_based_retire_is_clean_and_loses_nothing():
    """Mark-drain → drain → retire mid-stream: the in-flight request
    finishes on the draining replica (exact), no new work routes to it,
    and the departure never counts as a death."""
    world = _FakeWorld(2, token_delay=0.05)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    try:
        p = np.asarray([3, 5], np.int32)
        req = s.submit(p, 6)
        while not req.tokens:
            time.sleep(0.01)
        victim = req.replica
        assert s.mark_draining(victim)
        assert not s.mark_draining(victim)     # idempotent
        assert s.draining_replicas() == {victim}
        # new work only lands on the survivor
        other = [s.submit(np.asarray([9 + k], np.int32), 2)
                 for k in range(3)]
        toks, err = _collect(req)
        assert err is None and toks == _fake_tokens(p, 6)
        assert s.drain_replica(victim, timeout=10)
        s.retire_replica(victim)
        world.exit_clean(victim)
        for r in other:
            assert r.replica != victim
            _, err = _collect(r)
            assert err is None
        m = s.metrics()
        assert s.dead_replicas() == set()       # retired, NOT dead
        assert m["replicas"][victim]["retired"]
        assert m["requeued"] == 0 and m["failed"] == 0
        # traffic continues on the survivor
        _, err = _collect(s.submit(np.asarray([40], np.int32), 2))
        assert err is None
    finally:
        s.stop()


def test_forced_retire_requeues_in_flight_exactly():
    """Retiring WITHOUT waiting for the drain re-queues the in-flight
    request to the survivor — stream stays exact and the planned move
    does not burn the request's failover attempt."""
    world = _FakeWorld(2, token_delay=0.05)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    try:
        p = np.asarray([4, 7], np.int32)
        req = s.submit(p, 8)
        while not req.tokens:
            time.sleep(0.01)
        victim = req.replica
        s.retire_replica(victim, reason="forced")   # no drain first
        world.exit_clean(victim)
        toks, err = _collect(req, timeout=15)
        assert err is None and toks == _fake_tokens(p, 8)
        m = s.metrics()
        assert m["requeued"] == 1 and m["completed"] == 1
        assert s.dead_replicas() == set()
        # the replay kept its one real-failure requeue budget: retire the
        # serving replica mid-flight AGAIN (replacement registered
        # first) and the request must still complete via a second
        # planned re-queue — only real deaths charge the failover limit
        s.add_replica(world.add_replica())
        req2 = s.submit(p, 8)
        while not req2.tokens:
            time.sleep(0.01)
        s.retire_replica(req2.replica, reason="forced")
        toks, err = _collect(req2, timeout=15)
        assert err is None and toks == _fake_tokens(p, 8)
    finally:
        s.stop()


# ------------------------------------------------- warm-standby units

class _PoolWorld(_FakeWorld):
    """_FakeWorld + the cluster surface StandbyPool/ServingCluster need:
    ``add_workers`` spawns fake replicas,
    ``_client_for`` swallows driver control messages (promote etc.)."""

    def add_workers(self, n, map_fun=None, tf_args=None, timeout=None):
        return [self.add_replica() for _ in range(n)]

    def _client_for(self, eid):
        class _Null:
            def put(self, qname, item, timeout=None):
                pass
        return _Null()

    def retire_worker(self, eid):
        pass


def _standby_tier(world, scheduler, pool_size):
    """A driver-side ServingCluster over fakes (no frontend/monitor),
    with a filled warm-standby pool — the unit harness for promotion
    race-safety."""
    from tensorflowonspark_tpu_torch.serving import ServingCluster, StandbyPool

    tier = ServingCluster(world, scheduler, monitor=None, frontend=None,
                          address=("127.0.0.1", 0))
    scheduler.on_replica_ready = tier._on_standby_ready
    tier.standbys = StandbyPool(tier, pool_size)
    tier.standbys.fill()
    return tier


def test_standby_promotion_race_promotes_two_different_standbys():
    """Acceptance (race-safety): a concurrent replica failure and an
    autoscaler scale-up each acquire a standby — with two pooled, they
    promote two DIFFERENT ones (acquire pops atomically; a double
    promotion would blow up scheduler.add_replica's double-registration
    guard)."""
    world = _PoolWorld(2)
    s = _scheduler(world).start()
    tier = _standby_tier(world, s, pool_size=2)
    try:
        assert tier.standbys.stats()["standbys"] == 2    # eids 2 and 3
        got = []
        threads = [threading.Thread(
            target=lambda src=src: got.append(tier.promote_standby(src)))
            for src in ("failure", "scale_up")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert sorted(got) == [2, 3], got
        assert {2, 3} <= s.alive_replicas()
        # both promoted gangs serve traffic
        for k in range(4):
            _, err = _collect(s.submit(np.asarray([k + 1], np.int32), 2))
            assert err is None
        # the standby_ready acks close the heal measurements AND release
        # the deferred backfills (restock waits for restored capacity)
        for eid in got:
            s._handle_response(s.replicas[eid],
                               {"rid": None, "event": "standby_ready"})
        deadline = time.monotonic() + 5
        while tier.standbys.stats()["standbys"] < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert tier.standbys.stats()["standbys"] == 2
        m = tier.metrics()
        assert m["standby"]["promotions"] == {"failure": 1, "scale_up": 1}
        assert m["standby"]["heal"]["count"] == 2
    finally:
        tier.standbys.stop()
        s.stop()


def test_standby_promotion_race_with_one_standby_falls_back_cold():
    """With ONE pooled standby, a concurrent failure-heal + scale-up
    yield one promotion + one COLD spawn — never the same standby twice,
    and the tier still grows by two distinct replicas."""
    world = _PoolWorld(2)
    s = _scheduler(world).start()
    tier = _standby_tier(world, s, pool_size=1)
    try:
        standby_eid = tier.standbys.stats()["ready"][0]
        world.kill(1)
        s.on_cluster_failure(__import__(
            "tensorflowonspark_tpu_torch.health", fromlist=["ClusterFailure"]
        ).ClusterFailure("crash", "crash: worker 1", (1,)))
        threads = [
            threading.Thread(target=tier._spawn_replacement,
                             kwargs=dict(eid=1, source="failure",
                                         promote_source="failure")),
            threading.Thread(target=lambda: tier.scale_up(1)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        deadline = time.monotonic() + 10
        while len(s.alive_replicas()) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        alive = s.alive_replicas()
        assert standby_eid in alive, "the standby was never promoted"
        assert len(alive) == 3, alive    # 0 + promoted + one cold spawn
        for k in range(4):
            _, err = _collect(s.submit(np.asarray([k + 1], np.int32), 2))
            assert err is None
    finally:
        tier.standbys.stop()
        s.stop()


def test_standby_death_shrinks_pool_backfills_never_registers():
    """Acceptance (standby churn): a DEAD standby leaves the pool and is
    backfilled by a fresh one — and at no point does an unpromoted
    standby register with the scheduler."""
    from tensorflowonspark_tpu_torch.health import ClusterFailure

    world = _PoolWorld(1)
    s = _scheduler(world).start()
    tier = _standby_tier(world, s, pool_size=1)
    try:
        standby_eid = tier.standbys.stats()["ready"][0]
        assert standby_eid == 1 and s.alive_replicas() == {0}
        world.kill(standby_eid)
        tier._on_cluster_failure(ClusterFailure(
            "crash", f"crash: worker {standby_eid}",
            (standby_eid,)))
        assert not tier.standbys.holds(standby_eid)
        assert standby_eid in tier.standbys.dead
        deadline = time.monotonic() + 5
        while tier.standbys.stats()["standbys"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        fresh = tier.standbys.stats()["ready"]
        assert fresh and fresh[0] != standby_eid, fresh
        # the scheduler never saw either standby: no registration, no
        # death, no capacity change
        assert s.alive_replicas() == {0}
        assert s.dead_replicas() == set()
        assert standby_eid not in s.replicas
        _, err = _collect(s.submit(np.asarray([5], np.int32), 3))
        assert err is None
    finally:
        tier.standbys.stop()
        s.stop()


# ------------------------------------------------- frontend/client units

def test_frontend_client_roundtrip_and_typed_shed():
    """The TCP edge over fake replicas: generate, generate_stream (delta
    concat == generate), stats, and a typed queue_full rejection."""
    world = _FakeWorld(2)
    s = _scheduler(world, max_queue_depth=64).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe.start()
    try:
        with ServeClient(addr, b"s" * 16) as c:
            assert c.ping()
            p = np.asarray([2, 3, 4], np.int32)
            got = c.generate(p, 6)
            assert got.tolist() == _fake_tokens(p, 6)
            deltas = list(c.generate_stream(p, 6))
            assert [t for d in deltas for t in d] == _fake_tokens(p, 6)
            stats = c.stats()
            assert stats["completed"] == 2
            assert stats["ttft"]["count"] == 2
        with pytest.raises(ConnectionError):
            ServeClient(addr, b"wrong-key-------")
        # shed: shrink the bound under the scheduler lock-free counters
        s.max_queue_depth = 0
        with ServeClient(addr, b"s" * 16) as c, \
                pytest.raises(RequestRejected) as ei:
            c.generate(p, 2)
        assert ei.value.reason == "queue_full"
    finally:
        fe.stop()
        s.stop()


def test_frontend_answers_a_resume_unknown_so_the_client_resubmits():
    """A ``resume`` naming a trace the frontend has no replayed request
    for (here: no driver failover happened) gets ``unknown_request``, the
    answer on which a ``failover_wait`` client re-submits."""
    world = _FakeWorld(1)
    s = _scheduler(world).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe.start()
    try:
        with ServeClient(addr, b"s" * 16) as c:
            c.send(c._sock, {"op": "resume", "trace": "t", "received": 0,
                             "stream": False, "timeout": 5.0})
            assert c.receive(c._sock)[:2] == ("ERR", "unknown_request")
            assert c.ping()
    finally:
        fe.stop()
        s.stop()


def test_frontend_deadline_mid_request_is_typed():
    world = _FakeWorld(1, token_delay=0.15)
    s = _scheduler(world, slots_per_replica=1, overcommit=1).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe.start()
    try:
        with ServeClient(addr, b"s" * 16) as c, \
                pytest.raises(DeadlineExceeded):
            c.generate(np.asarray([1], np.int32), 50, timeout=0.3)
    finally:
        fe.stop()
        s.stop()


def test_frontend_carries_tenant_and_priority():
    """Tenant/priority ride the wire: a client bound to the noisy tenant
    sees typed tenant_throttled shed; the quiet client's traffic (and
    the default tenant) sails through."""
    world = _FakeWorld(1)
    s = _scheduler(world, max_queue_depth=64,
                   tenants={"noisy": {"rate": 0.001, "burst": 1},
                            "quiet": {"rate": None,
                                      "priority": "high"}}).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe.start()
    try:
        p = np.asarray([5], np.int32)
        with ServeClient(addr, b"s" * 16, tenant="noisy") as c:
            c.generate(p, 2)                       # burst of 1
            with pytest.raises(RequestRejected) as ei:
                c.generate(p, 2)
            assert ei.value.reason == "tenant_throttled"
            # per-call override outruns the client default
            c.generate(p, 2, tenant="quiet")
        with ServeClient(addr, b"s" * 16) as c:    # default tenant
            c.generate(p, 2)
            stats = c.stats()
        assert stats["tenants"]["noisy"]["shed"] == 1
        assert stats["tenants"]["noisy"]["accepted"] == 1
        assert stats["tenants"]["quiet"]["accepted"] == 1
        assert stats["tenants"]["default"]["accepted"] == 1
    finally:
        fe.stop()
        s.stop()


def test_client_reconnects_once_on_idle_socket_error():
    """Satellite: a transient socket failure on an IDLE connection (the
    frontend closed the keep-alive between requests) is healed by one
    reconnect-and-retry; a genuinely dead frontend still raises after
    the single retry — typed, not swallowed."""
    world = _FakeWorld(1)
    s = _scheduler(world).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe.start()
    c = ServeClient(addr, b"s" * 16, timeout=5.0)
    try:
        p = np.asarray([2, 3], np.int32)
        got = c.generate(p, 3)
        # sever the established connection out from under the client —
        # the next send/receive fails like a reset idle keep-alive
        c._sock.shutdown(__import__("socket").SHUT_RDWR)
        c._sock.close()
        assert c.ping(), "reconnect-and-retry did not heal the connection"
        assert c.generate(p, 3).tolist() == got.tolist()
        # stream path heals the same way
        c._sock.close()
        deltas = list(c.generate_stream(p, 3))
        assert [t for d in deltas for t in d] == got.tolist()
    finally:
        c.close()
        fe.stop()
    # frontend really gone: the single retry must fail loudly
    c2_error = None
    try:
        c2 = ServeClient(addr, b"s" * 16, timeout=1.0)
    except (ConnectionError, OSError):
        c2 = None      # listener already down: constructor refuses
    if c2 is not None:
        try:
            c2.ping()
        except (ConnectionError, OSError, EOFError) as e:
            c2_error = e
        finally:
            c2.close()
        assert c2_error is not None, "dead frontend went unnoticed"
    s.stop()


# ------------------------------------------------------ integration


# ---------------------------------------------------- cross-package parity

def _parity_run(pkg, tmp_path):
    """One seeded fake-world scenario through ``pkg``'s scheduler: two
    replicas of one slot and a queue of two — A and B route, C expires
    waiting, D waits, E is shed, then A's replica dies mid-stream and A
    replays on the survivor.  Returns each request's outcome and the
    multiset of event kinds the scheduler logged."""
    import collections
    import importlib
    import json

    serving = importlib.import_module(f"{pkg}.serving")
    observability = importlib.import_module(f"{pkg}.observability")
    path = tmp_path / f"{pkg}_events.jsonl"
    log = observability.EventLog(str(path))
    world = _FakeWorld(2, token_delay=0.05)
    s = serving.ReplicaScheduler(world, client_factory=world.client, slots_per_replica=1,
                                 overcommit=1, max_queue_depth=4, poll_interval=0.05,
                                 event_log=log).start()
    prompts = {k: np.asarray(p, np.int32) for k, p in
               (("A", [1, 2]), ("B", [3]), ("C", [4]), ("D", [5]), ("E", [6]))}
    out = {}
    try:
        reqs = {"A": s.submit(prompts["A"], 8), "B": s.submit(prompts["B"], 6),
                "C": s.submit(prompts["C"], 4, timeout=0.05), "D": s.submit(prompts["D"], 3)}
        try:
            s.submit(prompts["E"], 3)
        except serving.RequestRejected as e:
            out["E"] = ("shed", e.reason)
        while not reqs["A"].tokens:
            time.sleep(0.01)
        world.kill(reqs["A"].replica)
        for k, req in reqs.items():
            toks, err = _collect(req, timeout=15)
            out[k] = ("ok", toks == _fake_tokens(prompts[k], req.max_new_tokens)) \
                if err is None else ("error", err[1])
        m = s.metrics()
        out["counts"] = {k: m[k] for k in ("accepted", "completed", "shed", "expired",
                                           "failed", "requeued")}
    finally:
        s.stop()
        log.close()
    kinds = collections.Counter(json.loads(line)["kind"] for line in path.read_text().splitlines())
    return out, dict(kinds)


def test_scheduler_outcomes_and_events_match_the_jax_package(tmp_path):
    ref = _parity_run("tensorflowonspark_tpu", tmp_path)
    port = _parity_run("tensorflowonspark_tpu_torch", tmp_path)
    assert port == ref
    outcomes, kinds = port
    assert outcomes["A"] == outcomes["B"] == outcomes["D"] == ("ok", True)
    assert outcomes["C"] == ("error", "deadline") and outcomes["E"] == ("shed", "queue_full")
    assert outcomes["counts"]["requeued"] == 1
    assert kinds["request_requeued"] == 1 and "replica_dead" in kinds


# ------------------------------------------------------- end to end, CPU

E2E_CFG = dict(vocab_size=83, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
               max_position_embeddings=64)


def test_tier_with_a_killed_replica_and_a_promoted_standby_equals_jax_greedy(tmp_path):
    """A real tier on the CPU: two replicas and a warm standby serve 8
    streamed requests from 3 clients; ``TFOS_CHAOS`` SIGKILLs replica 1 at
    its 4th decode step, the scheduler requeues its streams once and the
    standby is promoted (it clones replica 0's weights) and serves the
    second half.  Every stream equals the JAX package's
    ``greedy_generate`` on the flax weights, which reach the workers as a
    numpy state dict (the workers import no JAX)."""
    import jax
    import jax.numpy as jnp
    import torch

    from tensorflowonspark_tpu.models import GPT, GPTConfig, greedy_generate
    from tensorflowonspark_tpu_torch.examples.gpt import online_serving
    from tensorflowonspark_tpu_torch.models.gpt import params_from_flax

    jcfg = GPTConfig(**E2E_CFG, dtype=jnp.float32, pos_encoding="rope")
    flax_params = GPT(jcfg).init(jax.random.key(3), jnp.ones((1, 4), jnp.int32))["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, flax_params), jcfg)
    torch.save(sd, tmp_path / "weights.pt")
    args = {"vocab": 83, "hidden": 32, "num_layers": 2, "num_heads": 4,
            "max_position_embeddings": 64, "weights": str(tmp_path / "weights.pt")}
    rng = np.random.default_rng(5)
    # two prompt lengths, one budget: two JAX compiles for the oracle
    shapes = [(5, 10), (9, 10)] * 4
    reqs = [(rng.integers(0, 83, (t,)).tolist(), n) for t, n in shapes]
    out = online_serving.run(args, reqs, replicas=2, slots=2, clients=3, warm_standbys=1,
                             kill_at_step=4, device="cpu", working_dir=str(tmp_path / "tier"),
                             worker_env={"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""},
                             timeout=120)
    greedy = jax.jit(greedy_generate, static_argnums=(0, 3))
    for (t, n) in sorted(set(shapes)):
        idx = [i for i, s in enumerate(shapes) if s == (t, n)]
        want = np.asarray(greedy(jcfg, flax_params,
                                 jnp.asarray([reqs[i][0] for i in idx], jnp.int32), n))[:, t:]
        for i, w in zip(idx, want):
            assert out["results"][i] == w.tolist(), f"request {i} diverged"
    m = out["metrics"]
    assert m["completed"] == len(reqs) and m["failed"] == 0 and m["requeued"] >= 1
    assert m["standby"]["promotions"] == {"failure": 1}
    assert m["replicas"][2]["served"] > 0, "the promoted standby served nothing"
    assert not m["replicas"][1]["alive"]


# ----------------------------------------------------- unported options

@pytest.mark.parametrize("option, value", [
    ("mesh", {"pp": 2}), ("gang_size", 2), ("shard_params", lambda cfg, p, mesh: p)])
def test_unported_options_raise_not_implemented(option, value):
    """Each gang option on a tier with warm standbys, over a mesh the
    port's gangs do not serve yet (``pp``: standby gangs over ``tp`` are
    ported, gangs over ``pp`` or ``ep`` are ROADMAP A6 part 2, item 8c),
    raises before any worker boots."""
    from tensorflowonspark_tpu_torch.examples.gpt.online_serving import model_builder
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    kwargs = {"mesh": {"pp": 2}, option: value}
    with pytest.raises(NotImplementedError, match="ROADMAP A6 part 2, item 8c"):
        ServingCluster.run(model_builder, 1, warm_standbys=1, **kwargs)


def test_compile_cache_has_no_counterpart():
    from tensorflowonspark_tpu_torch.examples.gpt.online_serving import model_builder
    from tensorflowonspark_tpu_torch.serving import ServingCluster

    with pytest.raises(ValueError, match="compiles"):
        ServingCluster.run(model_builder, 1, compile_cache="/tmp/x")
