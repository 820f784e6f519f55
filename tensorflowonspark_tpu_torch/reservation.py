"""Cluster bootstrap: a dependency-free TCP rendezvous.

Equivalent of the reference's ``tensorflowonspark/reservation.py``
(``Reservations``, ``MessageSocket``, ``Server``, ``Client``).  The driver
starts a :class:`Server` expecting ``count`` registrations; every node runtime
registers its ``{executor_id, host, job_name, task_index, port, addr,
authkey}`` dict through a :class:`Client`, then polls until the full cluster
spec is assembled.  This rendezvous additionally carries the
coordinator address used for ``torch.distributed.init_process_group`` (the reference's
analogue is building ``TF_CONFIG`` in ``TFSparkNode.py::run``).

Wire format (:class:`MessageSocket`): a 10-byte header
``[1B magic 0xA5][1B version][4B pickle_len][4B nbuf]``, then ``nbuf``
8-byte out-of-band buffer lengths, the pickle-protocol-5 stream, and the
raw buffers — large contiguous payloads (numpy batches) skip the pickle
stream entirely.  ``nbuf`` is 0 for plain control messages.  A
magic/version mismatch raises :class:`FrameFormatError` (logged by every
receive loop) so a mixed-version peer is diagnosed on its first frame.
Pre-auth hellos use the separate 4-byte-length raw framing
(``send_raw``/``receive_raw``).
"""

from __future__ import annotations

import hmac as _hmac
import logging
import os
import pickle
import select
import socket
import struct
import threading
import time

logger = logging.getLogger(__name__)

BUFSIZE = 64 * 1024


def _peer_name(sock: "socket.socket") -> str:
    try:
        return "%s:%s" % sock.getpeername()[:2]
    except OSError:
        return "<unknown peer>"

# Challenge-frame magic for the mutual HMAC authkey handshake (below).
AUTH_MAGIC = b"TFOSAUTH1"
_NONCE_LEN = 32


class FrameFormatError(EOFError):
    """A peer's frame failed the magic/version check — it speaks a
    different wire format (mixed-version cluster).  Subclasses
    ``EOFError`` so every receive loop still treats it as a dead
    connection, but loops log it explicitly first: without the log the
    mismatch would look like a routine disconnect and the old peer
    would silently hang re-polling."""


class Reservations:
    """Thread-safe registry of node reservations.

    Reference: ``reservation.py::Reservations`` (add/done/remaining).
    """

    def __init__(self, required: int):
        self.required = required
        self._lock = threading.RLock()
        self._reservations: list[dict] = []

    def add(self, meta: dict) -> None:
        with self._lock:
            self._reservations.append(meta)

    def expect(self, n: int) -> int:
        """Re-open the rendezvous for ``n`` more registrations (live
        membership expansion: ``TPUCluster.add_workers``).  ``done()``
        turns False again until the newcomers register; existing members
        are unaffected — they only polled during their own bootstrap.
        Returns the new required total."""
        with self._lock:
            self.required += int(n)
            return self.required

    def done(self) -> bool:
        with self._lock:
            return len(self._reservations) >= self.required

    def get(self) -> list[dict]:
        with self._lock:
            return list(self._reservations)

    def remaining(self) -> int:
        with self._lock:
            return self.required - len(self._reservations)


class MessageSocket:
    """Pickled messages over a TCP socket, with large binary payloads
    (numpy batches in the queue data plane) carried OUT-OF-BAND.

    Frame: ``[1B magic 0xA5][1B version][4B pickle_len][4B nbuf]
    [nbuf x 8B buf_len][pickle][bufs...]``.  ``nbuf`` is 0 for plain
    control messages (the common case everywhere but the data queues).
    The magic/version prefix exists so a mixed-version peer (e.g. one
    still speaking an older framing) fails with an explicit diagnostic
    on the first frame instead of a silent desync where its length
    bytes get parsed as ours.  Pickle protocol 5's ``buffer_callback`` splits
    each array's bytes out of the pickle stream, so a chunk of samples
    crosses the wire with NO Python-side serialize/concat/join copies:
    the sender writes each array buffer straight to the socket, the
    receiver ``recv_into``s it straight into its final backing store and
    reconstructs the arrays zero-copy (``pickle.loads(buffers=...)``).
    This is the per-sample→chunk divergence's second half (SURVEY.md
    §3.2): chunking took pickling off the per-sample path; out-of-band
    framing takes the per-BYTE copies off the per-chunk path.

    Reference: ``reservation.py::MessageSocket`` (framing strategy).
    """

    #: out-of-band only pays when a buffer is big enough that the saved
    #: pickle-stream copy beats its extra sendall/recv_into syscall pair;
    #: below this, in-band (one contiguous stream) is faster — measured:
    #: ungated OOB on a chunk of ~3 KB samples was 5x SLOWER than in-band
    OOB_MIN_BYTES = 64 * 1024
    #: hard cap on per-message OOB buffers (syscall-count bound)
    MAX_OOB_BUFFERS = 256

    #: per-OOB-buffer allocation cap — matches the old format's implicit
    #: 4 GiB frame bound, so a desynced stream (payload bytes parsed as a
    #: header) fails like a framing error, not an exabyte MemoryError
    MAX_OOB_BUF_BYTES = 1 << 32

    #: frame magic + wire version; bump the version on any framing change
    FRAME_MAGIC = 0xA5
    FRAME_VERSION = 2

    def receive(self, sock: socket.socket):
        magic, ver, plen, nbuf = struct.unpack(
            ">BBII", self._recv_exact(sock, 10))
        if magic != self.FRAME_MAGIC or ver != self.FRAME_VERSION:
            raise FrameFormatError(
                f"frame magic/version mismatch: got (0x{magic:02x}, v{ver}),"
                f" expected (0x{self.FRAME_MAGIC:02x}, "
                f"v{self.FRAME_VERSION}) — peer speaks a different wire "
                "format (mixed-version cluster?)")
        if not nbuf:
            return pickle.loads(self._recv_exact(sock, plen))
        if nbuf > self.MAX_OOB_BUFFERS:
            raise EOFError(f"frame desync: nbuf={nbuf} exceeds "
                           f"MAX_OOB_BUFFERS={self.MAX_OOB_BUFFERS}")
        lens = struct.unpack(f">{nbuf}Q",
                             self._recv_exact(sock, 8 * nbuf))
        if any(n > self.MAX_OOB_BUF_BYTES for n in lens):
            raise EOFError(f"frame desync: oversized OOB buffer in {lens}")
        pdata = self._recv_exact(sock, plen)
        bufs = []
        for n in lens:
            ba = bytearray(n)  # writable: reconstructed arrays stay mutable
            self._recv_exact_into(sock, memoryview(ba))
            bufs.append(ba)
        return pickle.loads(pdata, buffers=bufs)

    @staticmethod
    def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
        got = 0
        n = len(view)
        while got < n:
            r = sock.recv_into(view[got:])
            if not r:
                raise EOFError("socket closed while receiving message")
            got += r

    @classmethod
    def _recv_exact(cls, sock: socket.socket, n: int) -> bytes:
        ba = bytearray(n)
        cls._recv_exact_into(sock, memoryview(ba))
        return bytes(ba) if n < BUFSIZE else ba  # small frames: hashable

    def split_oob(self, msg, oob_min: int | None = None,
                  max_buffers: int | None = None) -> tuple[bytes, list]:
        """Pickle ``msg`` with the large-contiguous-buffer split applied:
        returns ``(pickle5_stream, oob_buffers)``.  Shared by the socket
        framing below, the shm transport (``shm.ShmChannel``), which
        routes the same buffers into shared memory, and the bulk
        transport (``transport.BulkChannel``), which lowers ``oob_min``
        because its scatter/gather chunk frames amortize the per-buffer
        syscall cost that sets this class's 64 KB default."""
        bufs: list = []
        floor = self.OOB_MIN_BYTES if oob_min is None else int(oob_min)
        cap = self.MAX_OOB_BUFFERS if max_buffers is None else int(max_buffers)

        def keep_large(pb):
            # pickle semantics: a TRUE return serializes the buffer
            # in-band; a false return means out-of-band (we captured it)
            try:
                v = pb.raw()
            except BufferError:          # non-contiguous
                return True
            if v.nbytes < floor or len(bufs) >= cap:
                return True
            bufs.append(v)
            return False

        return pickle.dumps(msg, protocol=5, buffer_callback=keep_large), bufs

    def frame_bytes(self, msg) -> list:
        """The exact byte segments :meth:`send` would write for ``msg``,
        returned instead of sent — the bulk transport routes whole frames
        through its single-writer path so envelope frames can never
        interleave with a pipelined chunk stream."""
        data, bufs = self.split_oob(msg)
        header = struct.pack(">BBII", self.FRAME_MAGIC, self.FRAME_VERSION,
                             len(data), len(bufs))
        if bufs:
            header += struct.pack(f">{len(bufs)}Q",
                                  *(v.nbytes for v in bufs))
        return [header, data, *bufs]

    def send(self, sock: socket.socket, msg) -> None:
        header, data, *bufs = self.frame_bytes(msg)
        if len(data) < BUFSIZE:
            sock.sendall(header + data)
        else:
            sock.sendall(header)
            sock.sendall(data)
        for v in bufs:
            sock.sendall(v)

    # Raw (non-pickle) frames, used for the pre-auth hello so that no
    # attacker-controlled bytes are ever unpickled before authentication.
    def receive_raw(self, sock: socket.socket, max_len: int = 1 << 16) -> bytes:
        header = self._recv_exact(sock, 4)
        (length,) = struct.unpack(">I", header)
        if length > max_len:
            raise ValueError(f"oversized pre-auth frame ({length} bytes)")
        return self._recv_exact(sock, length)

    def send_raw(self, sock: socket.socket, data: bytes) -> None:
        sock.sendall(struct.pack(">I", len(data)) + data)

    # -- authkey handshake (mutual HMAC-SHA256 challenge-response) --------
    # The pre-shared key itself never crosses the wire (a raw-key hello is
    # sniffable and replayable); each side proves possession by MACing a
    # fresh server nonce, so captured traffic authenticates nothing.

    def auth_challenge(self, sock: socket.socket) -> bytes:
        """Server, step 1: send a fresh nonce; returns it for later verify."""
        nonce = os.urandom(_NONCE_LEN)
        self.send_raw(sock, AUTH_MAGIC + nonce)
        return nonce

    def auth_verify(self, sock: socket.socket, authkey: bytes,
                    nonce: bytes) -> bool:
        """Server, step 2: check the client's MAC over ``nonce``; on success
        send back our own MAC so the client can authenticate us too."""
        digest = self.receive_raw(sock, max_len=64)
        ok = _hmac.compare_digest(
            digest, _hmac.new(authkey, b"client" + nonce, "sha256").digest())
        if ok:
            self.send_raw(
                sock, _hmac.new(authkey, b"server" + nonce, "sha256").digest())
        return ok

    def auth_respond(self, sock: socket.socket, authkey: bytes) -> None:
        """Client: answer the server's challenge, then verify its proof."""
        frame = self.receive_raw(sock, max_len=64)
        if not frame.startswith(AUTH_MAGIC) or \
                len(frame) != len(AUTH_MAGIC) + _NONCE_LEN:
            raise PermissionError("bad auth challenge from server")
        nonce = frame[len(AUTH_MAGIC):]
        self.send_raw(
            sock, _hmac.new(authkey, b"client" + nonce, "sha256").digest())
        proof = self.receive_raw(sock, max_len=64)
        if not _hmac.compare_digest(
                proof, _hmac.new(authkey, b"server" + nonce, "sha256").digest()):
            raise PermissionError("server failed to prove authkey possession")


class Server(MessageSocket):
    """Driver-side rendezvous listener.

    Handles ``REG`` (register a node), ``QINFO`` (query done + cluster info),
    ``QNUM`` (remaining count), and ``STOP`` messages — the reference's
    register / query / get-cluster-info / stop protocol
    (``reservation.py::Server``).
    """

    def __init__(self, count: int, authkey: bytes | None = None):
        assert count > 0
        self.reservations = Reservations(count)
        self.authkey = authkey
        self.done = threading.Event()
        self._listener: socket.socket | None = None

    def start(self) -> tuple[str, int]:
        """Bind, spawn the accept loop thread, return ``(host, port)``."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(64)
        port = self._listener.getsockname()[1]
        addr = (get_ip_address(), port)

        t = threading.Thread(target=self._serve, name="reservation-server", daemon=True)
        t.start()
        logger.info("reservation server listening at %s", addr)
        self.addr = addr
        return addr

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
                            # challenge immediately; nothing is unpickled
                            # from a peer that has not answered it.
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
        if kind == "REG":
            self.reservations.add(msg["data"])
            self.send(sock, "OK")
        elif kind == "QINFO":
            done = self.reservations.done()
            self.send(sock, (done, self.reservations.get() if done else None))
        elif kind == "QNUM":
            self.send(sock, self.reservations.remaining())
        elif kind == "STOP":
            self.send(sock, "OK")
            self.done.set()
        else:
            self.send(sock, ("ERR", f"unknown message type {kind!r}"))

    def await_reservations(self, timeout: float = 600.0, status: dict | None = None):
        """Block until all nodes registered; raise on timeout.

        Reference: ``reservation.py::Server.await_reservations`` — also
        re-raises node failures surfaced through the ``status`` dict the way
        the reference re-raises via the Spark job status.
        """
        deadline = time.monotonic() + timeout
        while not self.reservations.done():
            if status and status.get("error"):
                raise RuntimeError(f"node failed during bootstrap: {status['error']}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out waiting for reservations: {self.reservations.remaining()}"
                    f" of {self.reservations.required} still missing"
                )
            logger.debug("waiting for %d reservations", self.reservations.remaining())
            time.sleep(0.1)
        return self.reservations.get()

    def open_for(self, n: int) -> int:
        """Re-open the (still listening) rendezvous for ``n`` more
        registrations — the accept loop runs for the cluster's whole
        life, so late joiners register through the same path the
        original members did.  Returns the new required total."""
        if self.done.is_set():
            raise RuntimeError("reservation server already stopped; "
                               "cannot admit new members")
        return self.reservations.expect(n)

    def stop(self) -> None:
        self.done.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover
                pass


class Client(MessageSocket):
    """Node-side rendezvous client.  Reference: ``reservation.py::Client``."""

    def __init__(self, server_addr: tuple[str, int], timeout: float = 600.0,
                 authkey: bytes | None = None):
        self.server_addr = tuple(server_addr)
        self.timeout = timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._sock.connect(self.server_addr)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._lock = threading.Lock()
        if authkey is not None:
            self.auth_respond(self._sock, authkey)

    def _request(self, msg):
        with self._lock:
            self.send(self._sock, msg)
            return self.receive(self._sock)

    def register(self, info: dict) -> None:
        resp = self._request({"type": "REG", "data": info})
        if resp != "OK":
            raise RuntimeError(f"registration rejected: {resp!r}")

    def get_reservations(self) -> list[dict] | None:
        done, info = self._request({"type": "QINFO"})
        return info if done else None

    def await_reservations(self, timeout: float | None = None) -> list[dict]:
        """Poll until every node has registered (reference: 1 s poll loop)."""
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            info = self.get_reservations()
            if info is not None:
                return info
            if time.monotonic() > deadline:
                raise TimeoutError("timed out awaiting cluster reservations")
            time.sleep(0.1)

    def request_stop(self) -> None:
        try:
            self._request({"type": "STOP"})
        except (EOFError, OSError):  # server may already be gone
            pass

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass


def get_ip_address() -> str:
    """Best-effort routable IP of this host (loopback fallback for tests)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
