"""Multi-host worker backend: one host agent per host.

Port of ``tensorflowonspark_tpu/agent.py``.  The wire protocol, the
authentication and the driver-side backend are the JAX package's; the
agent launches its workers as the port's ``LocalProcessBackend`` does,
forked from ``multiprocessing``'s fork server, which has imported torch
once (``cluster.FORKSERVER_PRELOAD``), and each worker takes the agent's
environment plus the driver's ``worker_env``.  The agent process itself
never initialises CUDA.

The reference gets its multi-host muscle from Spark: YARN/Standalone place
one executor JVM per machine and ``sc.parallelize(...).foreachPartition``
fans the node bootstrap out to them (``TFCluster.py::run``).  Without Spark,
this module is that muscle: the port's own driver/host-agent runtime,
mapping executors 1:1 to hosts:

- :class:`HostAgent` — a daemon started once per host (``python -m
  tensorflowonspark_tpu_torch.agent --port 9999 --authkey-hex ...``).  It accepts
  authenticated driver connections and launches/monitors/terminates worker
  processes on its host.  Each worker runs the same node harness
  (``cluster._worker_entry`` → ``node.run``) a local worker would.
- :class:`AgentBackend` — the driver-side counterpart, a drop-in for
  ``LocalProcessBackend``:

      backend = AgentBackend([("host-a", 9999), ("host-b", 9999)],
                             authkey=key)
      cluster = TPUCluster.run(map_fun, args, num_workers=2, backend=backend)

Executor ids are assigned round-robin over agents, so ``num_workers ==
len(agents)`` gives the reference's one-executor-per-host shape, and
``num_workers == n * len(agents)`` oversubscribes evenly (multiple Spark
executors per machine).

Wire protocol: the rendezvous framing (``reservation.MessageSocket``,
4-byte length + pickle) with the same raw-frame authkey hello before any
unpickling, then ``LAUNCH`` / ``STATUS`` / ``TERMINATE`` / ``PING`` /
``STOP`` request-response messages.  The user ``map_fun`` travels pickled
inside ``LAUNCH`` — like the reference, functions must be importable
top-level callables on the worker side.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import select
import socket
import tempfile
import threading
import time

from tensorflowonspark_tpu_torch.reservation import (FrameFormatError,
                                                     MessageSocket, _peer_name,
                                                     get_ip_address)

logger = logging.getLogger(__name__)

AUTHKEY_ENV = "TFOS_AGENT_AUTHKEY"  # hex-encoded pre-shared key


class HostAgent(MessageSocket):
    """Per-host worker launcher (the Spark-executor stand-in)."""

    def __init__(self, port: int = 0, authkey: bytes | None = None,
                 max_workers: int = 64, bind_host: str | None = None,
                 log_dir: str | None = None):
        self.port = port
        self.authkey = authkey
        self.max_workers = max_workers
        # Per-executor stdout/stderr capture on the AGENT's host: Spark gave
        # the reference executor logs/UI for free; without it a remote
        # failure beyond the crash-file traceback is invisible from the
        # driver (SURVEY.md §7 hard part 3).  Served back via LOGS.
        self.log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"tfos_agent_logs_{os.getuid()}_{os.getpid()}")
        self._log_paths: dict[int, str] = {}
        # A keyless agent is an arbitrary-code-execution endpoint; it must
        # never be reachable off-host.  Default bind: loopback without a
        # key, all interfaces with one.  An explicit bind_host overrides
        # (the CLI gates the keyless+non-local combination on --insecure).
        if bind_host is None:
            bind_host = "0.0.0.0" if authkey is not None else "127.0.0.1"
        self.bind_host = bind_host
        self.done = threading.Event()
        self._listener: socket.socket | None = None
        self._procs: dict[int, mp.Process] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> tuple[str, int]:
        """Bind and serve in a background thread; returns ``(host, port)``."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.bind_host, self.port))
        self._listener.listen(16)
        port = self._listener.getsockname()[1]
        host = self.bind_host if self.bind_host not in ("0.0.0.0", "") \
            else get_ip_address()
        self.addr = (host, port)
        t = threading.Thread(target=self._serve, name="host-agent", daemon=True)
        t.start()
        logger.info("host agent listening at %s", self.addr)
        return self.addr

    def serve_forever(self) -> None:
        """Foreground variant for the CLI entry point."""
        if self._listener is None:
            self.start()
        self.done.wait()

    def stop(self) -> None:
        self.done.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._terminate_workers()

    # -------------------------------------------------------------- server
    def _serve(self) -> None:
        conns = [self._listener]
        pending: dict = {}  # unauthenticated sock -> challenge nonce
        while not self.done.is_set():
            try:
                readable, _, _ = select.select(conns, [], [], 0.5)
            except (OSError, ValueError):
                break
            for sock in readable:
                if sock is self._listener:
                    try:
                        client, _ = self._listener.accept()
                        conns.append(client)
                        if self.authkey is not None:
                            # HMAC challenge-response (reservation.py): the
                            # key never crosses the wire, and nothing from
                            # an unauthenticated peer is ever unpickled.
                            try:
                                pending[client] = self.auth_challenge(client)
                            except OSError:
                                client.close()
                                conns.remove(client)
                    except OSError:
                        break
                elif sock in pending:
                    try:
                        if not self.auth_verify(sock, self.authkey,
                                                pending.pop(sock)):
                            raise PermissionError("bad authkey")
                    except (EOFError, OSError, ValueError, PermissionError):
                        pending.pop(sock, None)
                        sock.close()
                        conns.remove(sock)
                else:
                    try:
                        msg = self.receive(sock)
                        self._handle(sock, msg)
                    except FrameFormatError as e:
                        logger.error("dropping peer %s: %s",
                                     _peer_name(sock), e)
                        sock.close()
                        conns.remove(sock)
                    except (EOFError, OSError, pickle.PickleError):
                        sock.close()
                        conns.remove(sock)
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass

    def _handle(self, sock: socket.socket, msg: dict) -> None:
        kind = msg.get("type")
        try:
            if kind == "PING":
                self.send(sock, {"ok": True, "host": self.addr[0],
                                 "workers": sorted(self._procs)})
            elif kind == "LAUNCH":
                self._launch(msg)
                self.send(sock, "OK")
            elif kind == "STATUS":
                self.send(sock, self._status())
            elif kind == "LOGS":
                self.send(sock, self._logs(msg.get("executor_ids"),
                                           int(msg.get("tail", 16384))))
            elif kind == "TERMINATE":
                self._terminate_workers()
                self.send(sock, "OK")
            elif kind == "STOP":
                self.send(sock, "OK")
                self.done.set()
            else:
                self.send(sock, ("ERR", f"unknown message type {kind!r}"))
        except Exception as e:  # reply instead of killing the serve loop
            logger.exception("agent: %s failed", kind)
            try:
                self.send(sock, ("ERR", f"{type(e).__name__}: {e}"))
            except OSError:
                pass

    # ------------------------------------------------------------- workers
    def _launch(self, msg: dict) -> None:
        from tensorflowonspark_tpu_torch.cluster import (FORKSERVER_PRELOAD,
                                                         _worker_entry)

        executor_id = int(msg["executor_id"])
        with self._lock:
            old = self._procs.get(executor_id)
            if old is not None and old.is_alive():
                raise RuntimeError(f"executor {executor_id} already running")
            if len(self._procs) >= self.max_workers:
                raise RuntimeError(f"agent at max_workers={self.max_workers}")
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"executor-{executor_id}.log")
            with open(log_path, "wb"):  # truncate any previous run's log
                pass
            env = dict(msg.get("env") or {})
            env["TFOS_WORKER_LOG"] = log_path  # fd-level capture, see _worker_entry
            # host-level transport opt-outs propagate to workers AND
            # override a driver-supplied value: the agent's operator knows
            # this host's /dev/shm situation (size, tenancy) and NIC/memory
            # budget better than the remote driver does
            from tensorflowonspark_tpu_torch import shm as _shm
            from tensorflowonspark_tpu_torch import transport as _transport

            for disable_env in (_shm.DISABLE_ENV, _transport.DISABLE_ENV):
                if disable_env in os.environ:
                    env[disable_env] = os.environ[disable_env]
            # forked from a fork server that has imported torch and never
            # touches CUDA (cluster.LocalProcessBackend does the same)
            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(FORKSERVER_PRELOAD)
            p = ctx.Process(
                target=_worker_entry,
                args=(executor_id, dict(os.environ), env, msg["fn"],
                      msg["tf_args"], msg["cluster_meta"], msg["queues"]),
                name=f"tfos-node-{executor_id}", daemon=False)
            p.start()
            self._procs[executor_id] = p
            self._log_paths[executor_id] = log_path
        logger.info("agent: launched executor %d (pid %d)", executor_id, p.pid)

    def _status(self) -> dict[int, dict]:
        # under the lock: a forked worker's exit code is read once from the
        # fork server's pipe, and a second concurrent reader would see 255
        with self._lock:
            return {eid: {"alive": code is None, "exitcode": code}
                    for eid, code in ((e, p.exitcode) for e, p in self._procs.items())}

    def _logs(self, executor_ids=None, tail: int = 16384) -> dict[int, str]:
        """Last ``tail`` bytes of each requested executor's captured log."""
        with self._lock:
            paths = dict(self._log_paths)
        ids = sorted(paths) if executor_ids is None else \
            [int(i) for i in executor_ids]
        out: dict[int, str] = {}
        for eid in ids:
            path = paths.get(eid)
            if not path or not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail))
                out[eid] = f.read().decode("utf-8", "replace")
        return out

    def _terminate_workers(self) -> None:
        with self._lock:
            procs = list(self._procs.values())
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
        for p in procs:
            mp.connection.wait([p.sentinel], 5)   # waits, reads nothing


class _AgentConn(MessageSocket):
    """One authenticated driver→agent connection (request-response).

    A transient socket failure (timeout, reset, half-closed peer) must not
    poison the cached connection for the rest of the job — the driver's
    ``alive()``/``join()`` polls and the steady-state health monitor reuse
    this object for hours.  ``request`` therefore reconnects and retries
    ONCE (short backoff) on ``OSError``/``socket.timeout``/``EOFError``
    before propagating.  Note the retry re-sends the message: LAUNCH is
    guarded agent-side ("already running"), the other verbs are idempotent.
    """

    RETRY_BACKOFF_SECS = 0.2

    def __init__(self, addr: tuple[str, int], authkey: bytes | None,
                 timeout: float = 30.0):
        self.addr = tuple(addr)
        self.authkey = authkey
        self.timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(self.addr, timeout=self.timeout)
        self._sock.settimeout(self.timeout)
        if self.authkey is not None:
            self.auth_respond(self._sock, self.authkey)

    def _roundtrip(self, msg: dict):
        self.send(self._sock, msg)
        return self.receive(self._sock)

    def request(self, msg: dict):
        with self._lock:
            try:
                resp = self._roundtrip(msg)
            except (OSError, EOFError) as e:  # socket.timeout is an OSError
                logger.warning("agent %s: %s during %r; reconnecting once",
                               self.addr, type(e).__name__, msg.get("type"))
                try:
                    self._sock.close()
                except OSError:
                    pass
                # the lock serializes request/response framing on ONE
                # socket; a waiter could not use the half-reconnected
                # socket anyway, so backing off under it is the point
                time.sleep(self.RETRY_BACKOFF_SECS)  # tfos: ignore[blocking-under-lock]
                self._connect()  # propagates if the agent is really gone
                resp = self._roundtrip(msg)
        if isinstance(resp, tuple) and resp and resp[0] == "ERR":
            raise RuntimeError(f"agent {self.addr}: {resp[1]}")
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class AgentBackend:
    """Driver-side backend running workers on remote :class:`HostAgent` s.

    Drop-in for ``LocalProcessBackend`` (same ``start/alive/failed/join/
    terminate`` surface consumed by ``TPUCluster``); executor ids are
    assigned round-robin over ``agents``.
    """

    def __init__(self, agents: list[tuple[str, int]],
                 authkey: bytes | None = None,
                 worker_env: dict | None = None, connect_timeout: float = 30.0):
        assert agents, "need at least one agent address"
        self.agent_addrs = [tuple(a) for a in agents]
        self.authkey = authkey
        self.worker_env = worker_env or {}
        self.connect_timeout = connect_timeout
        self._conns: list[_AgentConn] = []
        self._assignment: dict[int, _AgentConn] = {}

    def start(self, num_workers: int, fn, tf_args, cluster_meta: dict,
              queues) -> None:
        for conn in self._conns:  # restartable: don't leak prior attempts
            conn.close()
        self._assignment = {}
        self._conns = [_AgentConn(a, self.authkey, self.connect_timeout)
                       for a in self.agent_addrs]
        for i in range(num_workers):
            conn = self._conns[i % len(self._conns)]
            conn.request({
                "type": "LAUNCH", "executor_id": i, "env": self.worker_env,
                "fn": fn, "tf_args": tf_args, "cluster_meta": cluster_meta,
                "queues": queues,
            })
            self._assignment[i] = conn

    def _statuses(self) -> dict[int, dict]:
        merged: dict[int, dict] = {}
        for conn in self._conns:
            try:
                merged.update(conn.request({"type": "STATUS"}))
            except (OSError, EOFError, RuntimeError):
                # an unreachable agent counts its workers as failed
                for eid, c in self._assignment.items():
                    if c is conn:
                        merged[eid] = {"alive": False, "exitcode": -1}
        return merged

    def alive(self) -> list[bool]:
        st = self._statuses()
        return [st.get(i, {}).get("alive", False)
                for i in sorted(self._assignment)]

    def failed(self) -> list[int]:
        st = self._statuses()
        return [i for i in sorted(self._assignment)
                if not st.get(i, {}).get("alive", False)
                and st.get(i, {}).get("exitcode") not in (0, None)]

    def exitcodes(self) -> dict[int, int | None]:
        """Exit codes by executor id (None while alive / unknown) — feeds
        the health monitor's crash-vs-preemption classification."""
        st = self._statuses()
        return {i: st.get(i, {}).get("exitcode")
                for i in sorted(self._assignment)}

    def join(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if not any(self.alive()):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.5)

    def fetch_logs(self, executor_ids=None, tail: int = 16384) -> dict[int, str]:
        """Tail of each executor's captured stdout/stderr, fetched over the
        agent protocol — works without a shared filesystem (the crash-file
        path does not).  ``TPUCluster.shutdown`` uses this to surface failed
        remote workers' logs in the raised error."""
        ids = None if executor_ids is None else {int(i) for i in executor_ids}
        merged: dict[int, str] = {}
        for conn in self._conns:
            want = None
            if ids is not None:
                want = [i for i in ids if self._assignment.get(i) is conn]
                if not want:
                    continue
            try:
                got = conn.request({"type": "LOGS", "executor_ids": want,
                                    "tail": tail})
            except (OSError, EOFError, RuntimeError):
                continue
            merged.update({int(k): v for k, v in got.items()
                           if ids is None or int(k) in ids})
        return merged

    def terminate(self) -> None:
        for conn in self._conns:
            try:
                conn.request({"type": "TERMINATE"})
            except (OSError, EOFError, RuntimeError):
                pass

    def close(self, stop_agents: bool = False) -> None:
        """Drop connections; with ``stop_agents`` also shut the daemons down
        (tests / single-job fleets — production agents outlive jobs)."""
        for conn in self._conns:
            if stop_agents:
                try:
                    conn.request({"type": "STOP"})
                except (OSError, EOFError, RuntimeError):
                    pass
            conn.close()
        self._conns = []


# ------------------------------------------------------------------- CLI

def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="tensorflowonspark_tpu_torch host agent (one per host)")
    p.add_argument("--port", type=int, default=9999,
                   help="listen port (0 = ephemeral, printed on stdout)")
    p.add_argument("--authkey-hex", default=None,
                   help=f"pre-shared key (hex); default ${AUTHKEY_ENV}")
    p.add_argument("--bind", default=None,
                   help="bind address (default: 0.0.0.0 with an authkey, "
                        "127.0.0.1 without one)")
    p.add_argument("--insecure", action="store_true",
                   help="allow a KEYLESS agent to bind a non-loopback "
                        "address (anyone reaching the port can then run "
                        "arbitrary code as this user)")
    p.add_argument("--max-workers", type=int, default=64)
    args = p.parse_args(argv)

    key_hex = args.authkey_hex or os.environ.get(AUTHKEY_ENV)
    authkey = bytes.fromhex(key_hex) if key_hex else None
    if authkey is None:
        if args.bind not in (None, "127.0.0.1", "localhost", "::1") \
                and not args.insecure:
            p.error(
                "refusing to expose a KEYLESS agent on a non-loopback "
                f"address ({args.bind}): a peer that reaches the port can "
                "execute arbitrary code.  Pass --authkey-hex / set "
                f"${AUTHKEY_ENV}, or accept the risk with --insecure.")
        exposed = args.bind not in (None, "127.0.0.1", "localhost", "::1")
        logger.warning("host agent running WITHOUT an authkey (%s) — pass "
                       "--authkey-hex or set $%s for multi-host use",
                       f"EXPOSED on {args.bind} via --insecure" if exposed
                       else "loopback only", AUTHKEY_ENV)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [agent] %(message)s")
    agent = HostAgent(port=args.port, authkey=authkey,
                      max_workers=args.max_workers, bind_host=args.bind)
    host, port = agent.start()
    # machine-readable line for launchers that scrape the address
    print(f"AGENT {host}:{port}", flush=True)
    try:
        agent.serve_forever()
    except KeyboardInterrupt:
        agent.stop()


if __name__ == "__main__":
    main()
