"""Host-local data-plane queues served over TCP.

Equivalent of the reference's ``tensorflowonspark/TFManager.py`` — the bridge
between the feeding side (Spark tasks in the reference; the driver's feeder
threads here) and the training process.  The reference uses a
``multiprocessing.managers.BaseManager`` whose queue proxies pickle **every
sample** across a TCP hop (``TFManager.py::start/connect`` — its documented
throughput bottleneck, SURVEY.md §3.2).  This rebuild keeps the same surface
(named queues ``input``/``output``/``error`` plus a kv-store holding
``state``) but moves the wire granularity to **chunks of samples**: one
pickled message per few hundred samples, so the Python/TCP boundary is off the
per-sample hot path and the training process can slice chunks straight into
device batches.

Protocol (pickle-5 frames with out-of-band buffers for large arrays,
shared with ``reservation.MessageSocket`` — see its module docstring for
the wire format):

    {"op": "put",   "q": name, "data": obj, "timeout": t} -> "OK" | ("FULL",)
    {"op": "get",   "q": name, "timeout": t}              -> ("OK", obj) | ("EMPTY",)
    {"op": "qsize", "q": name}                            -> int
    {"op": "set",   "k": key, "v": val}                   -> "OK"
    {"op": "getk",  "k": key}                             -> value | None
    {"op": "stop"}                                        -> "OK"

Auth: an ``authkey`` hello on connect, mirroring the reference's
``multiprocessing`` authkey handshake.

Transport negotiation (the three-tier hello, preference order
**shm > bulk > per-message pickle**): right after the authkey hello the
client offers a shared-memory probe; if the server proves it can read it
(the two processes genuinely share ``/dev/shm``), the connection switches
to :class:`~tensorflowonspark_tpu_torch.shm.ShmChannel` framing — large ndarray
payloads are written once into a shm segment ring and received as
zero-copy numpy views, with the socket retained as the control channel.
A peer the probe does NOT reach (the cross-host case) next offers the
chunked **bulk transport** (``transport.py``): scatter/gather chunk
frames into pooled receive slabs, with negotiated chunk size and CRC
mode (:class:`~tensorflowonspark_tpu_torch.transport.BulkChannel`).  Probe
failures + ``TFOS_TPU_NO_SHM=1`` skip tier one, a refused/failed
``bulk_hello`` + ``TFOS_TPU_NO_BULK=1`` skip tier two, and either way
the op surface below is unchanged — fallback is transparent.
"""

from __future__ import annotations

import logging
import queue as _queue
import socket
import threading

from tensorflowonspark_tpu_torch import shm as _shm
from tensorflowonspark_tpu_torch import transport as _transport
from tensorflowonspark_tpu_torch.reservation import (FrameFormatError,
                                               MessageSocket, _peer_name)

logger = logging.getLogger(__name__)

DEFAULT_QUEUES = ("input", "output", "error")


class QueueServer(MessageSocket):
    """Serves named in-memory queues + a kv store over TCP.

    Reference: ``TFManager.py::start`` (mode ``'local'`` binds loopback only,
    ``'remote'`` binds all interfaces so other hosts' feed tasks can connect).
    """

    def __init__(self, authkey: bytes, qnames=DEFAULT_QUEUES, mode: str = "local",
                 maxsize: int = 64, shm: bool | None = None,
                 bulk: bool | None = None):
        self.authkey = bytes(authkey)
        self.mode = mode
        self.queues = {name: _queue.Queue(maxsize=maxsize) for name in qnames}
        self.kv: dict = {"state": "running"}
        self._kv_lock = threading.Lock()
        self.done = threading.Event()
        self._listener: socket.socket | None = None
        # None = auto (accept shm when the env allows it); False = refuse
        self.shm = _shm.shm_resolve(shm)
        self.shm_conns = 0  # connections that negotiated the shm transport
        # same tri-state for the cross-host bulk tier (transport.py)
        self.bulk = _transport.bulk_resolve(bulk)
        self.bulk_conns = 0  # connections that negotiated bulk framing

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> tuple[str, int]:
        host = "127.0.0.1" if self.mode == "local" else "0.0.0.0"
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, name="queue-server", daemon=True).start()
        from tensorflowonspark_tpu_torch.reservation import get_ip_address

        self.addr = ("127.0.0.1" if self.mode == "local" else get_ip_address(), self.port)
        return self.addr

    def stop(self) -> None:
        self.done.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover
                pass

    # -- serving -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self.done.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break
            # the data plane writes header+payload as separate sendalls;
            # without NODELAY, Nagle holds the small header back a full
            # delayed-ACK period on some stacks
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        chan = None   # ShmChannel | BulkChannel once negotiated
        try:
            # Mutual HMAC challenge-response (reservation.MessageSocket):
            # the key never crosses the wire and an unauthenticated peer
            # never reaches pickle.loads.
            nonce = self.auth_challenge(conn)
            if not self.auth_verify(conn, self.authkey, nonce):
                return
            while not self.done.is_set():
                msg = chan.receive() if chan is not None else self.receive(conn)
                if isinstance(msg, dict) and msg.get("op") == "shm_hello":
                    # same-host negotiation: the client proves shared memory
                    # by a probe segment we must read back (shm.verify_probe)
                    ok = (chan is None and self.shm
                          and _shm.verify_probe(msg.get("seg"), msg.get("tok")))
                    if ok:
                        # count BEFORE the reply: once the client sees
                        # ("SHM", True) the negotiation is observable,
                        # so the counter must already reflect it
                        chan = _shm.ShmChannel(self, conn)
                        self.shm_conns += 1
                    self.send(conn, ("SHM", bool(ok)))
                    continue
                if isinstance(msg, dict) and msg.get("op") == "bulk_hello":
                    # cross-host tier two: chunked bulk framing.  shm won
                    # already (chan set) or the server refuses bulk ->
                    # the client stays on the per-message pickle path.
                    params = (_transport.accept_payload(msg)
                              if chan is None and self.bulk else None)
                    if params is not None:
                        # count before the reply (see shm_hello above)
                        chan = _transport.BulkChannel(
                            self, conn, chunk_bytes=params["chunk"],
                            peer_max=params.pop("peer_max"),
                            crc_mode=params["crc"])
                        self.bulk_conns += 1
                    self.send(conn, ("BULK", params is not None, params))
                    continue
                reply = chan.send if chan is not None else \
                    (lambda obj: self.send(conn, obj))
                try:
                    self._handle(reply, msg)
                except KeyError as e:
                    reply(("ERR", f"unknown queue {e}"))
        except FrameFormatError as e:
            logger.error("dropping peer %s: %s", _peer_name(conn), e)
        except _transport.BulkIntegrityError as e:
            # transport.py's contract: a failed bulk stream is connection
            # death, but it must be LOGGED — corruption on the wire is
            # not a normal disconnect
            logger.error("dropping peer %s: %s", _peer_name(conn), e)
        except (EOFError, OSError, ValueError):
            pass
        finally:
            if chan is not None:
                chan.close()
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, reply, msg: dict) -> None:
        op = msg.get("op")
        if op == "put":
            try:
                self.queues[msg["q"]].put(msg["data"], block=True,
                                          timeout=msg.get("timeout", 600))
                reply("OK")
            except _queue.Full:
                reply(("FULL",))
        elif op == "get":
            try:
                item = self.queues[msg["q"]].get(block=True, timeout=msg.get("timeout", 600))
                self.queues[msg["q"]].task_done()
                reply(("OK", item))
            except _queue.Empty:
                reply(("EMPTY",))
        elif op == "qsize":
            reply(self.queues[msg["q"]].qsize())
        elif op == "set":
            with self._kv_lock:
                self.kv[msg["k"]] = msg["v"]
            reply("OK")
        elif op == "getk":
            with self._kv_lock:
                reply(self.kv.get(msg["k"]))
        elif op == "stop":
            reply("OK")
            self.done.set()
        else:
            reply(("ERR", f"unknown op {op!r}"))

    # -- in-process access (training side, no TCP hop) ---------------------
    def get_queue(self, qname: str) -> _queue.Queue:
        """Direct queue handle for same-process consumers.

        The reference's training process reads through manager proxies even
        when co-located (``TFNode.py::DataFeed``); here the node runtime runs
        ``map_fun`` in the *same* process as the queue server, so the hot
        consumer path is a plain in-memory ``queue.Queue``.
        """
        return self.queues[qname]

    def get(self, key: str):
        with self._kv_lock:
            return self.kv.get(key)

    def set(self, key: str, value) -> None:
        with self._kv_lock:
            self.kv[key] = value

    # Uniform interface shared with QueueClient so DataFeed works against
    # either an in-process server (training side) or a TCP client (remote).
    def queue_put(self, qname: str, item, timeout: float = 600.0) -> None:
        self.queues[qname].put(item, block=True, timeout=timeout)

    def queue_get(self, qname: str, timeout: float = 600.0):
        item = self.queues[qname].get(block=True, timeout=timeout)
        self.queues[qname].task_done()
        return item

    def queue_size(self, qname: str) -> int:
        return self.queues[qname].qsize()

    kv_get = get
    kv_set = set


class QueueClient(MessageSocket):
    """TCP client used by feeders (driver side) and remote readers.

    Reference: ``TFManager.py::connect`` + the queue proxies used inside
    ``TFSparkNode.py::_train/_inference``.
    """

    def __init__(self, addr: tuple[str, int], authkey: bytes, timeout: float = 600.0,
                 shm: bool | None = None, bulk: bool | None = None):
        self.addr = tuple(addr)
        self.authkey = bytes(authkey)
        self._default_timeout = timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(timeout)
        self._sock.connect(self.addr)
        self._lock = threading.Lock()
        try:
            self.auth_respond(self._sock, self.authkey)
        except (PermissionError, EOFError, OSError) as e:
            # a bad key shows up as the server silently closing on us
            raise ConnectionError(f"queue server rejected connection: {e!r}")
        # ShmChannel | BulkChannel | None — the three-tier hello, best
        # transport first: shm when the probe proves a shared host, the
        # chunked bulk framing otherwise, per-message pickle as the floor
        self._chan = None
        if _shm.shm_resolve(shm):
            self._negotiate_shm()
        if self._chan is None and _transport.bulk_resolve(bulk):
            self._negotiate_bulk()

    def _negotiate_shm(self) -> None:
        """Offer the zero-copy transport as part of the connect hello; any
        failure (cross-host server, full /dev/shm, old peer) is a silent
        downgrade to the socket protocol."""
        try:
            probe = _shm.Probe()
        except (OSError, ValueError) as e:
            logger.debug("shm probe creation failed (%s); using socket", e)
            return
        try:
            self.send(self._sock,
                      {"op": "shm_hello", "seg": probe.name, "tok": probe.token})
            resp = self.receive(self._sock)
        finally:
            probe.close()
        if resp == ("SHM", True):
            self._chan = _shm.ShmChannel(self, self._sock)

    def _negotiate_bulk(self) -> None:
        """Offer the chunked bulk transport.  A clean REFUSAL — server
        with the tier disabled (``BULK False``), old peer replying ERR
        to the unknown op — is a silent downgrade to the per-message
        pickle protocol: both sides answered the hello, the stream stays
        in sync.  An I/O error or malformed acceptance mid-exchange is
        NOT safe to downgrade on: the server may already have switched
        this connection to bulk framing (or its reply may still be in
        flight), so continuing on the socket would desync every later
        frame — the error propagates and kills the connection loudly,
        mirroring ``_negotiate_shm``."""
        self.send(self._sock, _transport.hello_payload())
        resp = self.receive(self._sock)
        if (isinstance(resp, tuple) and len(resp) == 3
                and resp[0] == "BULK" and resp[1]):
            try:
                self._chan = _transport.BulkChannel(
                    self, self._sock, chunk_bytes=resp[2]["chunk"],
                    peer_max=resp[2]["max"], crc_mode=resp[2]["crc"])
            except (KeyError, TypeError) as e:
                raise ConnectionError(
                    f"queue server sent a malformed bulk acceptance "
                    f"{resp[2]!r}: {e!r}")

    @property
    def shm_active(self) -> bool:
        """True when this connection negotiated the zero-copy shm tier."""
        return isinstance(self._chan, _shm.ShmChannel)

    @property
    def bulk_active(self) -> bool:
        """True when this connection negotiated the bulk transport tier."""
        return isinstance(self._chan, _transport.BulkChannel)

    def _request(self, msg, op_timeout: float | None = None):
        with self._lock:
            if op_timeout is not None:
                # the server may legitimately block up to the op's timeout
                # before replying; keep the socket deadline past it so a slow
                # (but correct) reply never desynchronizes the connection.
                self._sock.settimeout(op_timeout + 30.0)
            try:
                if self._chan is not None:
                    self._chan.send(msg)
                    return self._chan.receive()
                self.send(self._sock, msg)
                return self.receive(self._sock)
            finally:
                if op_timeout is not None:
                    self._sock.settimeout(self._default_timeout)

    @staticmethod
    def _check_err(resp, qname: str):
        if isinstance(resp, tuple) and resp and resp[0] == "ERR":
            raise ValueError(f"queue server error for '{qname}': {resp[1]}")
        return resp

    def put(self, qname: str, data, timeout: float = 600.0) -> None:
        resp = self._check_err(
            self._request({"op": "put", "q": qname, "data": data, "timeout": timeout},
                          op_timeout=timeout),
            qname)
        if resp != "OK":
            raise TimeoutError(f"queue '{qname}' full after {timeout}s (feed_timeout)")

    def get(self, qname: str, timeout: float = 600.0):
        resp = self._check_err(
            self._request({"op": "get", "q": qname, "timeout": timeout},
                          op_timeout=timeout), qname)
        if resp[0] != "OK":
            raise TimeoutError(f"queue '{qname}' empty after {timeout}s")
        return resp[1]

    def try_get(self, qname: str, timeout: float = 0.1):
        resp = self._check_err(
            self._request({"op": "get", "q": qname, "timeout": timeout},
                          op_timeout=timeout), qname)
        return resp[1] if resp[0] == "OK" else None

    def qsize(self, qname: str) -> int:
        return self._request({"op": "qsize", "q": qname})

    def set(self, key: str, value) -> None:
        self._request({"op": "set", "k": key, "v": value})

    def get_key(self, key: str):
        return self._request({"op": "getk", "k": key})

    def stop_server(self) -> None:
        try:
            self._request({"op": "stop"})
        except (EOFError, OSError):
            pass

    # Uniform interface (see QueueServer.queue_put/queue_get).
    queue_put = put
    queue_get = get
    queue_size = qsize
    kv_set = set
    kv_get = get_key

    def close(self) -> None:
        if self._chan is not None:
            self._chan.close()  # closes + unlinks this side's segment ring
            self._chan = None
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
