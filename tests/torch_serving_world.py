"""In-process fake serving replicas for the port's scheduler units
(``tests/test_torch_serving_tier.py``, ``tests/test_torch_sharded_serving.py``):
the JAX package's ``tests/test_serving_cluster.py`` fake world."""

import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch.serving import ReplicaScheduler


class _FakeBackend:
    def __init__(self, n):
        self.codes = {i: None for i in range(n)}

    def exitcodes(self):
        return dict(self.codes)

    def failed(self):
        return [i for i, c in self.codes.items() if c not in (0, None)]


def _fake_tokens(prompt, n):
    """The fake replica's deterministic 'decode': a pure function of the
    request, like the real batcher's contract — so a failover replay
    regenerates the identical sequence."""
    base = int(np.sum(np.asarray(prompt, np.int64)))
    return [(base + 7 * k) % 101 for k in range(n)]


class _FakeWorld:
    """N serial fake replicas speaking the serve queue protocol over
    in-process queues; ``kill(i)`` emulates a SIGKILL (exit code -9,
    connections start raising)."""

    def __init__(self, n, token_delay=0.0):
        self.backend = _FakeBackend(n)
        self.cluster_info = [
            {"executor_id": i, "job_name": "worker",
             "addr": ("127.0.0.1", 0), "authkey": b"x"} for i in range(n)]
        self.cluster_meta = {"queue_shm": False}
        self.working_dir = None
        self.token_delay = token_delay
        self.inq = {i: _queue.Queue() for i in range(n)}
        self.outq = {i: _queue.Queue() for i in range(n)}
        self._dead: set[int] = set()
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True) for i in range(n)]
        for t in self.threads:
            t.start()

    def _run(self, i):
        while i not in self._dead:
            try:
                item = self.inq[i].get(timeout=0.02)
            except _queue.Empty:
                continue
            rid, p = item["rid"], item["prompt"]
            for k, tok in enumerate(_fake_tokens(p, item["max_new_tokens"])):
                if i in self._dead:
                    return               # died mid-stream
                if self.token_delay:
                    time.sleep(self.token_delay)
                self.outq[i].put({"rid": rid, "event": "tok",
                                  "tokens": [tok], "load": 1})
            self.outq[i].put({"rid": rid, "event": "done", "load": 0})

    def kill(self, i):
        self._dead.add(i)
        self.backend.codes[i] = -9

    def add_replica(self):
        """Bring up one more fake replica (live scale-up); returns its
        info dict, shaped like a reservation."""
        i = len(self.cluster_info)
        info = {"executor_id": i, "job_name": "worker",
                "addr": ("127.0.0.1", 0), "authkey": b"x"}
        self.cluster_info.append(info)
        self.backend.codes[i] = None
        self.inq[i] = _queue.Queue()
        self.outq[i] = _queue.Queue()
        t = threading.Thread(target=self._run, args=(i,), daemon=True)
        self.threads.append(t)
        t.start()
        return info

    def exit_clean(self, i):
        """Emulate a clean worker exit (drained retire / preemption)."""
        self._dead.add(i)
        self.backend.codes[i] = 0

    def client(self, info):
        eid, world = info["executor_id"], self

        class _C:
            def put(self, qname, item, timeout=None):
                if eid in world._dead:
                    raise ConnectionError("replica dead")
                world.inq[eid].put(item)

            def get(self, qname, timeout=0.5):
                if eid in world._dead:
                    raise ConnectionError("replica dead")
                try:
                    return world.outq[eid].get(timeout=timeout)
                except _queue.Empty:
                    raise TimeoutError

            def close(self):
                pass

        return _C()


def _scheduler(world, **kw):
    kw.setdefault("slots_per_replica", 2)
    kw.setdefault("poll_interval", 0.05)
    return ReplicaScheduler(world, client_factory=world.client, **kw)


def _collect(req, timeout=10.0):
    """Drain one request's event stream; returns (tokens, error_or_None)."""
    toks, deadline = [], time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(0.01, deadline - time.monotonic()))
        if ev[0] == "tok":
            toks.extend(ev[1])
        elif ev[0] == "done":
            return toks, None
        else:
            return toks, ev
