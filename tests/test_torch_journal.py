"""The port's control-plane journal and driver failover
(``tensorflowonspark_tpu_torch/serving/journal.py``, ``failover.py``).

- **journal parity** — the JAX package's ``tests/test_failover.py``
  journal cases (round trip, a record that cannot be written, duplicates,
  alias chains, torn tails cut inside the JSON and inside a UTF-8
  sequence, unknown kinds, ``remaining_steps``), each run through both
  packages' ``ControlPlaneJournal``/``JournalState``: the same records
  give the same ``unfinished``, ``open_candidates``, ``open_rollouts`` and
  ``remaining_steps``;
- **byte compatibility** — a journal written by either package replays
  in the other to the same state;
- **adopt** — ``ReplicaScheduler.adopt`` on the JAX package's fake
  replicas: fresh rids, ``requeue`` aliases, dead replicas never routed,
  the requeued work completes exactly (both packages, same outcome);
- **ride-through** — a ``ServeClient(failover_wait=)`` stream survives a
  frontend restart on the same port and ends exact; a resume of a stream
  that committed just before the crash gets ``DONE``.
"""

import importlib
import json
import logging
import threading
import time

import numpy as np
import pytest

from tests.test_serving_cluster import _FakeWorld, _fake_tokens

PACKAGES = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")


def _journal(pkg):
    return importlib.import_module(f"{pkg}.serving.journal")


def _views(st) -> dict:
    """Every derived view of a folded journal, JSON-comparable."""
    return {"unfinished": {int(k): v for k, v in st.unfinished.items()},
            "committed": st.committed, "routed": st.routed, "aliases": st.aliases,
            "replicas": st.replicas, "traffic": st.traffic,
            "registry": sorted((list(k), v) for k, v in st.registry.items()),
            "open_candidates": sorted((list(k), v) for k, v in st.open_candidates().items()),
            "open_rollouts": st.open_rollouts(),
            "remaining_steps": {m: st.remaining_steps(m) for m in ("m", "x")},
            "resumes": st.resumes, "unknown_kinds": st.unknown_kinds}


def _admit(rid, trace=None, n=4, **kw):
    rec = dict(kind="admit", t=1.0, rid=rid, prompt=[1, 2, 3], max_new_tokens=n,
               temperature=0.0, top_p=1.0, seed=0, tenant="default", priority="normal",
               model=None, trace=trace)
    rec.update(kw)
    return rec


#: one record stream covering every kind the fold knows
STREAM = [
    _admit(0, trace="a"), _admit(1, trace="b"), _admit(2, trace="c", model="m"),
    dict(kind="route", rid=0, replica=2),
    dict(kind="requeue", rid=1, **{"as": 7}),
    dict(kind="requeue", rid=7, **{"as": 9}),
    dict(kind="commit", rid=9, outcome="done", tokens=4),
    dict(kind="replica_added", replica=2, members=[], role="decode", model="m", version="v1"),
    dict(kind="replica_added", replica=3, members=[], role=None, model="m", version="v1"),
    dict(kind="replica_dead", replica=2),
    dict(kind="replica_retired", replica=4),
    dict(kind="replica_model", replica=3, model="m", version="v2"),
    dict(kind="registry_register", model="m", version="v2", flavor="adapter"),
    dict(kind="registry_eval", model="m", version="v2", passed=True, metrics={"exact": 1.0}),
    dict(kind="registry_state", model="m", version="v1", state="serving"),
    dict(kind="registry_evict", model="m", version="v0"),
    dict(kind="traffic_split", model="m", split={"v2": 25.0, "v1": 75.0}),
    dict(kind="rollout_started", model="m", version="v2", incumbent="v1", steps=[5, 25, 100]),
    dict(kind="rollout_step", model="m", version="v2", percent=5),
    dict(kind="rollout_step_done", model="m", version="v2", percent=5),
    dict(kind="rollout_step", model="m", version="v2", percent=25),
    dict(kind="continual_candidate", model="m", version="v3", flavor="full", step=10,
         digest="d", src="s"),
    dict(kind="continual_stage", model="m", version="v3", stage="offline_eval"),
    dict(kind="continual_candidate", model="m", version="v4", flavor="full", step=20,
         digest="e", src="s"),
    dict(kind="continual_done", model="m", version="v4", outcome="rejected_offline"),
    dict(kind="driver_resumed", requeued=1, replicas=[3]),
    dict(kind="from_a_newer_writer", x=1),
]


@pytest.mark.parametrize("cut", ["none", "duplicated", "reversed_tail"])
def test_the_same_records_fold_to_the_same_views_in_both_packages(cut):
    """Every derived view is equal across the packages, for the stream as
    written, with every record duplicated, and with its tail reordered."""
    recs = {"none": STREAM, "duplicated": [r for r in STREAM for _ in (0, 1)],
            "reversed_tail": STREAM[:10] + STREAM[10:][::-1]}[cut]
    ref, port = (_views(_journal(p).JournalState.from_records(recs)) for p in PACKAGES)
    assert port == ref
    if cut == "none":
        assert set(port["unfinished"]) == {0, 2} and port["remaining_steps"]["m"] == (25, 100)
        assert port["open_rollouts"]["m"]["intended"] == 25 and port["unknown_kinds"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_journal_roundtrip(pkg, tmp_path):
    J = _journal(pkg).ControlPlaneJournal
    path = str(tmp_path / "cp.jsonl")
    j = J(path)
    j.record("admit", rid=0, prompt=[1, 2], max_new_tokens=3, trace="t0")
    j.record("route", rid=0, replica=1)
    j.record("commit", rid=0, outcome="done", tokens=3)
    j.record("replica_added", replica=1, role=None, model="m", version="v1")
    j.close()
    st = J.replay(path)
    assert list(st.admitted) == [0] and st.routed[0] == 1
    assert st.committed[0] == {"outcome": "done", "tokens": 3}
    assert not st.unfinished
    assert st.replicas[1]["alive"] and st.replicas[1]["model"] == "m"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_journal_record_survives_close_and_bad_payload(pkg, tmp_path, caplog):
    J = _journal(pkg).ControlPlaneJournal
    j = J(str(tmp_path / "cp.jsonl"))
    with caplog.at_level(logging.WARNING):
        j.record("admit", rid=0, prompt=object())     # not serializable
        j.record("admit", rid=1, prompt=object())
    assert sum("not JSON-serializable" in r.message for r in caplog.records) == 1
    j.close()
    j.record("admit", rid=2, prompt=[1])              # no raise after close
    assert J.replay(j.path).admitted == {}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_journal_requeue_alias_chain_resolves_to_root(pkg):
    st = _journal(pkg).JournalState.from_records([
        _admit(0, trace="a"),
        dict(kind="requeue", rid=0, **{"as": 5}),      # failover 1
        dict(kind="requeue", rid=5, **{"as": 9}),      # failover 2
        dict(kind="route", rid=9, replica=3),
        dict(kind="commit", rid=9, outcome="done", tokens=4),
    ])
    assert st._root(9) == 0 and st.routed == {0: 3}
    assert set(st.committed) == {0} and not st.unfinished


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("tear", ["payload", "utf8"])
def test_journal_torn_tail(pkg, tear, tmp_path, caplog):
    """A crash mid-``write`` leaves a last line cut inside the JSON, or
    inside a multi-byte UTF-8 sequence: replay skips exactly that line."""
    J = _journal(pkg).ControlPlaneJournal
    path = str(tmp_path / "cp.jsonl")
    j = J(path)
    j.record("admit", rid=0, prompt=[1], max_new_tokens=2)
    j.record("admit", rid=1, prompt=[2], max_new_tokens=2)
    j.close()
    whole = json.dumps({"t": 3.0, "kind": "commit", "rid": 1, "outcome": "café"},
                       ensure_ascii=False).encode("utf-8")
    cut = whole[:whole.index(b"\xc3") + 1] if tear == "utf8" else whole[:40]
    with open(path, "ab") as f:
        f.write(cut)
    with caplog.at_level(logging.WARNING):
        st = J.replay(path)
    assert set(st.admitted) == {0, 1} and not st.committed
    assert any("torn/corrupt" in r.message for r in caplog.records)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_journal_unknown_kinds_skip_with_one_warning(pkg, tmp_path, caplog):
    path = str(tmp_path / "cp.jsonl")
    with open(path, "w") as f:
        for rec in (_admit(0), {"t": 2.0, "kind": "quantum_entangle"},
                    {"t": 2.1, "kind": "quantum_entangle"},
                    dict(kind="commit", t=2.2, rid=0, outcome="done", tokens=1)):
            f.write(json.dumps(rec) + "\n")
    with caplog.at_level(logging.WARNING):
        st = _journal(pkg).ControlPlaneJournal.replay(path)
    assert st.unknown_kinds == 2
    assert sum("unknown record kind" in r.message for r in caplog.records) == 1
    assert set(st.committed) == {0}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_remaining_steps_resume_arithmetic(pkg):
    S = _journal(pkg).JournalState
    base = [dict(kind="rollout_started", model="m", version="v2", incumbent="v1",
                 steps=[5, 25, 100]),
            dict(kind="rollout_step", model="m", version="v2", percent=5),
            dict(kind="rollout_step_done", model="m", version="v2", percent=5)]
    st = S.from_records(base + [dict(kind="rollout_step", model="m", version="v2", percent=25)])
    assert st.remaining_steps("m") == (25, 100)
    st = S.from_records(base + [dict(kind="rollout_step_done", model="m", version="v2",
                                     percent=p) for p in (25, 100)])
    assert st.remaining_steps("m") == (100,)
    st = S.from_records(base + [dict(kind="rollout_done", model="m", version="v2",
                                     outcome="promoted")])
    assert st.open_rollouts() == {} and st.remaining_steps("x") == ()


@pytest.mark.parametrize("writer, reader", [PACKAGES, PACKAGES[::-1]])
def test_a_journal_written_by_one_package_replays_in_the_other(writer, reader, tmp_path):
    """Byte compatibility: the same ``record`` calls write the same lines
    (up to the timestamps), and the other package folds them to the same
    views."""
    paths = {}
    for pkg in PACKAGES:
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        j = _journal(pkg).ControlPlaneJournal(paths[pkg])
        for rec in STREAM:
            j.record(rec["kind"], **{k: v for k, v in rec.items() if k not in ("kind", "t")})
        j.close()

    def lines(path):
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in open(path, encoding="utf-8")]

    assert lines(paths[writer]) == lines(paths[reader])
    own = _views(_journal(writer).ControlPlaneJournal.replay(paths[writer]))
    other = _views(_journal(reader).ControlPlaneJournal.replay(paths[writer]))
    assert other == own


# ----------------------------------------------------------- adopt units

def _scheduler(pkg, world, **kw):
    sched = importlib.import_module(f"{pkg}.serving.scheduler")
    kw.setdefault("slots_per_replica", 2)
    kw.setdefault("poll_interval", 0.05)
    return sched.ReplicaScheduler(world, client_factory=world.client, **kw)


def _adopt_run(pkg, path):
    """The JAX package's adopt case on its fake replicas: what adopt
    returns, what the journal then folds to, and the streams the
    requeued work completes with."""
    jn = _journal(pkg)
    state = jn.JournalState.from_records([
        _admit(0, trace="tr0", n=3, prompt=[2, 3]),
        _admit(1, trace="tr1", n=3, prompt=[4]),
        _admit(2, trace="tr2", n=3, prompt=[5, 6]),
        dict(kind="route", rid=0, replica=0),
        dict(kind="commit", rid=1, outcome="done", tokens=3),
        dict(kind="replica_added", replica=0),
        dict(kind="replica_added", replica=1),
        dict(kind="replica_dead", replica=1),
    ])
    world = _FakeWorld(2)
    s = _scheduler(pkg, world, journal=jn.ControlPlaneJournal(path))
    try:
        adopted = s.adopt(state)
        out = {"done": adopted["done"],
               "rids": {t: r.rid for t, r in adopted["requeued"].items()},
               "requeued": s.requeued, "alive1": s.replicas[1].alive}
        st2 = jn.ControlPlaneJournal.replay(path)
        out["roots"] = sorted(st2._root(r.rid) for r in adopted["requeued"].values())
        s.start()
        for trace, req in sorted(adopted["requeued"].items()):
            toks = []
            while True:
                ev = req.events.get(timeout=10)
                if ev[0] != "tok":
                    assert ev[0] == "done", ev
                    break
                toks.extend(ev[1])
            out[trace] = toks
        out["unfinished"] = sorted(jn.ControlPlaneJournal.replay(path).unfinished)
    finally:
        s.stop()
    return out


def test_scheduler_adopt_requeues_fresh_rids_and_completes(tmp_path):
    ref, port = (_adopt_run(p, str(tmp_path / f"{p}.jsonl")) for p in PACKAGES)
    assert port == ref
    assert port["done"] == {"tr1": 3} and set(port["rids"]) == {"tr0", "tr2"}
    assert all(r > 2 for r in port["rids"].values()) and port["requeued"] == 2
    assert not port["alive1"] and port["roots"] == [0, 2]
    assert port["tr0"] == _fake_tokens([2, 3], 3) and port["tr2"] == _fake_tokens([5, 6], 3)
    assert port["unfinished"] == []      # the requeued commits discharge the originals


def test_registry_journal_snapshot_and_adopt(tmp_path, caplog):
    """bind_journal snapshots the pre-bind catalog; adopt restores eval
    verdicts and states onto re-registered builders and skips versions
    nobody re-registered, with a warning."""
    from tensorflowonspark_tpu_torch.serving import ControlPlaneJournal, ModelRegistry

    path = str(tmp_path / "cp.jsonl")
    reg = ModelRegistry()
    reg.register("m", "v1", builder=lambda a: None)
    reg.register("m", "v2", builder=lambda a: None)
    v2 = reg.version("m", "v2")
    v2.eval_passed, v2.eval_metrics = True, {"exact": 1.0}
    v2.state = "canary"
    j = ControlPlaneJournal(path)
    reg.bind_journal(j)
    reg.mark("m", "v1", "serving")
    j.close()
    st = ControlPlaneJournal.replay(path)
    assert st.registry[("m", "v2")]["state"] == "canary"
    assert st.registry[("m", "v2")]["eval_passed"] is True
    assert st.registry[("m", "v1")]["state"] == "serving"
    reg2 = ModelRegistry()
    reg2.register("m", "v2", builder=lambda a: None)
    with caplog.at_level(logging.WARNING):
        reg2.adopt(st)
    got = reg2.version("m", "v2")
    assert got.state == "canary" and got.eval_passed is True
    assert got.eval_metrics == {"exact": 1.0}
    assert any("not re-registered" in r.message for r in caplog.records)


# ------------------------------------------------- ride-through units

def test_client_stream_rides_through_frontend_restart():
    """A frontend dies mid-stream; a new one stands on the SAME port with
    the replayed request wired into ``resumed``.  The client's
    ``failover_wait`` reconnects and resumes at its token cursor: the
    concatenated stream is exact, no gap and no repeat."""
    from tensorflowonspark_tpu_torch.serving import ServeClient, ServeFrontend

    world = _FakeWorld(1, token_delay=0.1)
    s = _scheduler(PACKAGES[1], world, slots_per_replica=2).start()
    fe1 = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe1.start()
    prompt, n, trace = np.asarray([3, 4], np.int32), 8, "tr-restart"
    got, errs = [], []

    def consume():
        try:
            with ServeClient(addr, b"s" * 16, failover_wait=15.0) as c:
                for delta in c.generate_stream(prompt, n, trace=trace, timeout=30.0):
                    got.extend(delta)
        except Exception as e:       # surfaces in the main thread
            errs.append(e)

    t = threading.Thread(target=consume)
    t.start()
    while not got and t.is_alive():
        time.sleep(0.01)
    fe1.stop()                       # the driver's edge dies
    seen_at_kill = len(got)
    req2 = s.submit(prompt, n, trace=trace)      # the replay, as adopt mints it
    fe2 = ServeFrontend(s, authkey=b"s" * 16, port=addr[1])
    fe2.resumed = {trace: req2}
    try:
        assert fe2.start()[1] == addr[1]
        t.join(30)
        assert not t.is_alive() and not errs, errs
        assert got == _fake_tokens([3, 4], n)
        assert len(got) > seen_at_kill, "stream never resumed"
    finally:
        fe2.stop()
        s.stop()


def test_a_stopped_frontend_frees_its_port_with_no_client_connected():
    """A driver crash with no client connected: the resumed frontend
    rebinds the crashed one's port at once (the JAX package's frontend
    keeps LISTENing until a client connects: its accept thread is not
    woken by the close)."""
    from tensorflowonspark_tpu_torch.serving import ServeFrontend

    s = _scheduler(PACKAGES[1], _FakeWorld(1)).start()
    fe1 = ServeFrontend(s, authkey=b"s" * 16)
    addr = fe1.start()
    time.sleep(0.05)                 # the accept thread is blocked in accept()
    fe1.stop()
    fe2 = ServeFrontend(s, authkey=b"s" * 16, port=addr[1])
    try:
        t0 = time.monotonic()
        assert fe2.start()[1] == addr[1]
        assert time.monotonic() - t0 < 1.0
    finally:
        fe2.stop()
        s.stop()


def test_client_resume_of_committed_stream_returns_done():
    from tensorflowonspark_tpu_torch.serving import ServeClient, ServeFrontend

    world = _FakeWorld(1)
    s = _scheduler(PACKAGES[1], world).start()
    fe = ServeFrontend(s, authkey=b"s" * 16)
    fe.resumed_done = {"tr-done": 5}
    addr = fe.start()
    try:
        for trace, received, want in (("tr-done", 5, ("DONE", 5)),
                                      ("tr-done", 3, "unknown_request"),
                                      ("tr-nobody", 0, "unknown_request")):
            with ServeClient(addr, b"s" * 16, failover_wait=5.0) as c:
                c.send(c._sock, {"op": "resume", "trace": trace, "received": received,
                                 "stream": True, "timeout": 5})
                frame = c.receive(c._sock)
                assert frame == want if isinstance(want, tuple) else frame[:2] == ("ERR", want)
    finally:
        fe.stop()
        s.stop()
