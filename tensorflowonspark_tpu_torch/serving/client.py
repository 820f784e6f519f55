"""`ServeClient`: the user-facing handle on a serving frontend.

Port of ``tensorflowonspark_tpu/serving/client.py``: a copy.

One client = one authenticated TCP connection = one request at a time
(frames of concurrent requests would interleave on the socket; run N
concurrent streams with N clients — they are cheap).  Errors are typed:

- :class:`~tensorflowonspark_tpu_torch.serving.scheduler.RequestRejected` —
  load shed at admission (``.reason`` says why: ``queue_full`` /
  ``shutdown`` / ``no_replica``);
- :class:`~tensorflowonspark_tpu_torch.serving.scheduler.DeadlineExceeded` —
  the per-request deadline passed;
- :class:`~tensorflowonspark_tpu_torch.serving.scheduler.ReplicaFailed` — the
  request was lost to replica failure beyond the one re-queue;
- ``ValueError`` — the request itself is invalid (e.g. prompt + budget
  exceed the model's positions), reported by the replica's validator.

Transient transport robustness (mirrors ``agent._AgentConn.request``):
a socket failure on an IDLE connection — the send of a new request, or
the wait for its FIRST response frame — reconnects and retries ONCE
(short backoff, fresh authkey handshake).  Once any frame of a request
has been consumed the retry window is over: a replayed ``generate``
would interleave with the half-delivered stream, so mid-stream errors
propagate.  The second failure propagates the original typed error
untouched.

``tenant``/``priority`` ride every request (client-level defaults,
per-call override) into the scheduler's per-tenant token-bucket
admission — an over-budget tenant sees
``RequestRejected(reason="tenant_throttled")``.

Driver failover ride-through (docs/robustness.md "Control-plane
failover"): ``failover_wait=N`` arms the client to survive a DRIVER
death mid-request.  The client then mints its own trace id (the journal
records it at admission), and when the connection dies mid-stream it
reconnects to the same address — with backoff, for up to ``N`` seconds
while the standby driver replays the journal and rebinds the port —
and sends a ``resume`` op naming the trace and how many tokens it
already holds; the resumed frontend replays exactly the missing tail.
:class:`FrontendUnavailable` is the typed exhaustion error (no frontend
came back within the window).  The resumed driver is
:func:`~tensorflowonspark_tpu_torch.serving.failover.resume_driver`'s: it
requeues every request the journal holds accepted and uncommitted, and
answers a ``resume`` for any other trace with ``unknown_request`` — on
which a client that holds no token yet re-submits its request, and one
that holds some raises ``ReplicaFailed`` (a replay would repeat them).
"""

from __future__ import annotations

import contextlib
import logging
import socket
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch.reservation import MessageSocket
from tensorflowonspark_tpu_torch.serving.scheduler import (DeadlineExceeded,
                                                     ReplicaFailed,
                                                     RequestRejected,
                                                     ServingError)

logger = logging.getLogger(__name__)

_REJECT_REASONS = ("queue_full", "tenant_throttled", "shutdown",
                   "no_replica", "role_mismatch", "unknown_model")


class FrontendUnavailable(ServingError):
    """No serving frontend answered at the tier's address within the
    client's ``failover_wait`` reconnect window — the driver is gone
    and no standby resumed in time."""


def _raise_typed(reason: str, message: str):
    if reason in _REJECT_REASONS:
        raise RequestRejected(reason, message)
    if reason == "deadline":
        raise DeadlineExceeded(message)
    if reason == "replica_failed":
        raise ReplicaFailed(message)
    if reason == "bad_request":
        raise ValueError(message)
    raise ServingError(f"{reason}: {message}")


class ServeClient(MessageSocket):
    """Blocking client for :class:`~tensorflowonspark_tpu_torch.serving.
    frontend.ServeFrontend` (module docstring has the error contract)."""

    #: backoff before the single reconnect attempt (mirrors _AgentConn)
    RETRY_BACKOFF_SECS = 0.2

    def __init__(self, addr: tuple[str, int], authkey: bytes,
                 timeout: float = 600.0, tenant: str | None = None,
                 priority: str | None = None, model: str | None = None,
                 failover_wait: float = 0.0):
        self.addr = tuple(addr)
        self._authkey = bytes(authkey)
        self._timeout = float(timeout)
        self.tenant = tenant
        self.priority = priority
        #: seconds to ride through a driver failover (module docstring);
        #: 0 = off, connection loss mid-request propagates as before
        self.failover_wait = float(failover_wait)
        #: default ``model`` for every request (multi-model tiers;
        #: per-call override) — None = the tier's default model
        self.model = model
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(self._timeout)
        self._sock.connect(self.addr)
        if self._sock.getsockname() == self._sock.getpeername():
            # loopback SELF-CONNECT: with no listener bound (a driver
            # mid-failover) and the target port inside the ephemeral
            # range, the kernel can give this socket the target as its
            # OWN local port and TCP simultaneous-open "succeeds" against
            # itself — the handshake would then hang AND the held port
            # would block the resumed frontend's rebind
            self.close()
            raise ConnectionError(
                f"self-connect to {self.addr} (no listener bound)")
        try:
            self.auth_respond(self._sock, self._authkey)
        except (PermissionError, EOFError, OSError) as e:
            self.close()   # don't leak the connected fd on a bad key
            raise ConnectionError(
                f"serving frontend rejected connection: {e!r}")

    # -- requests ----------------------------------------------------------
    def _gen_msg(self, prompt, max_new_tokens, temperature, top_p, seed,
                 stream, timeout, trace, tenant, priority, model=None):
        return {"op": "generate",
                "prompt": np.asarray(prompt, np.int32).reshape(-1),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature), "top_p": float(top_p),
                "seed": int(seed), "stream": bool(stream),
                "timeout": timeout, "trace": trace,
                "tenant": tenant if tenant is not None else self.tenant,
                "priority": (priority if priority is not None
                             else self.priority),
                "model": model if model is not None else self.model}

    def _request_first(self, msg):
        """Send ``msg`` and return its FIRST response frame, reconnecting
        and retrying ONCE on a transient socket failure (the idle-
        connection shape: a frontend that closed the keep-alive, a reset
        between requests).  Nothing of the request was delivered to us
        yet, so the replay is safe; a second failure propagates.  Callers
        hold ``self._lock``."""
        try:
            self.send(self._sock, msg)
            return self.receive(self._sock)
        except (OSError, EOFError) as e:
            if isinstance(e, TimeoutError):
                # a SLOW response is not a dead connection: the request
                # was admitted and is decoding — a replay would double-
                # charge the tenant bucket and decode two copies
                raise
            logger.warning("serve frontend %s: %s before any response "
                           "frame; reconnecting once", self.addr,
                           type(e).__name__)
            with contextlib.suppress(OSError):
                self._sock.close()
            time.sleep(self.RETRY_BACKOFF_SECS)
            self._connect()   # propagates if the frontend is really gone
            self.send(self._sock, msg)
            return self.receive(self._sock)

    # -- driver-failover ride-through --------------------------------------
    def _reconnect_failover(self) -> None:
        """Reconnect to the tier address for up to ``failover_wait``
        seconds (backoff doubling from RETRY_BACKOFF_SECS, capped at
        2s) while a standby driver replays the journal and rebinds the
        port.  Typed :class:`FrontendUnavailable` on exhaustion."""
        deadline = time.monotonic() + self.failover_wait
        backoff = self.RETRY_BACKOFF_SECS
        with contextlib.suppress(OSError):
            self._sock.close()
        while True:
            try:
                self._connect()
                return
            except (OSError, ConnectionError) as e:
                if time.monotonic() + backoff > deadline:
                    raise FrontendUnavailable(
                        f"serving frontend {self.addr} did not come back "
                        f"within failover_wait={self.failover_wait:.0f}s: "
                        f"{e!r}") from e
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    def _resume_frame(self, trace, received: int, stream: bool, timeout):
        """Reconnect and send the ``resume`` op; returns its first
        response frame.  The resume exchange itself retries too — a
        reconnect can land on a frontend that is still going down (or a
        standby mid-boot), and that race must look like one more
        connect failure, not a raw socket error."""
        logger.warning(
            "serve frontend %s: connection lost mid-request; riding "
            "through driver failover (trace %s, %d token(s) held, "
            "window %.0fs)", self.addr, trace, received,
            self.failover_wait)
        deadline = time.monotonic() + self.failover_wait
        while True:
            self._reconnect_failover()
            try:
                self.send(self._sock, {"op": "resume", "trace": trace,
                                       "received": int(received),
                                       "stream": bool(stream),
                                       "timeout": timeout})
                return self.receive(self._sock)
            except (OSError, EOFError) as e:
                if isinstance(e, TimeoutError):
                    raise   # a slow resumed tier, not an absent one
                if time.monotonic() > deadline:
                    raise FrontendUnavailable(
                        f"serving frontend {self.addr} kept dropping the "
                        f"resume exchange past failover_wait="
                        f"{self.failover_wait:.0f}s: {e!r}") from e

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
                 timeout: float | None = None, trace: str | None = None,
                 tenant: str | None = None,
                 priority: str | None = None,
                 model: str | None = None) -> np.ndarray:
        """Generate to completion; returns the token array (prompt
        excluded).  ``timeout`` is the end-to-end deadline (queue wait
        included); greedy (default) output is exact vs a solo
        ``greedy_generate`` run.  ``trace`` propagates a caller-chosen
        trace id through the tier's telemetry (``tracing.new_trace_id()``;
        the frontend mints one otherwise).  ``tenant``/``priority``/
        ``model`` override the client-level defaults for this request
        (``model`` selects the hosted model on a multi-model tier —
        an unhosted name raises typed
        ``RequestRejected(reason="unknown_model")``)."""
        failover = self.failover_wait > 0
        if failover and trace is None:
            from tensorflowonspark_tpu_torch.tracing import new_trace_id

            trace = new_trace_id()   # the resume op's lookup key
        with self._lock:
            msg = self._gen_msg(
                prompt, max_new_tokens, temperature, top_p, seed,
                stream=False, timeout=timeout, trace=trace,
                tenant=tenant, priority=priority, model=model)
            frame = None
            while True:
                try:
                    if frame is None:
                        frame = self._request_first(msg)
                    kind = frame[0]
                    if kind == "DONE":
                        return np.asarray(frame[1], np.int32)
                    if kind == "ERR":
                        if frame[1] == "unknown_request" and failover:
                            # the resumed driver's journal never saw (or
                            # already committed) this admission; nothing
                            # was delivered to us, so replaying the
                            # original generate is exact
                            frame = None
                            continue
                        _raise_typed(frame[1], frame[2])
                    # tolerate stray TOK frames (stream flag mismatch)
                    frame = self.receive(self._sock)
                except (OSError, EOFError) as e:
                    # a TIMEOUT is a slow response, not a dead driver —
                    # same rule as _request_first
                    if not failover or isinstance(e, TimeoutError):
                        raise
                    frame = self._resume_frame(trace, 0, False, timeout)

    def generate_stream(self, prompt, max_new_tokens: int, *,
                        temperature: float = 0.0, top_p: float = 1.0,
                        seed: int = 0, timeout: float | None = None,
                        trace: str | None = None, tenant: str | None = None,
                        priority: str | None = None,
                        model: str | None = None):
        """Yield token deltas (lists of ints) as the replica commits them;
        exact concatenation == :meth:`generate`'s output.  Consume the
        iterator fully (or ``close()`` the client): abandoning it
        mid-stream closes the connection to avoid frame desync.

        With ``failover_wait`` armed, a connection death mid-stream
        rides through a driver failover: the client reconnects and
        resumes AT the token it stopped at — the concatenated yield is
        exactly :meth:`generate`'s output, no token lost or repeated."""
        failover = self.failover_wait > 0
        if failover and trace is None:
            from tensorflowonspark_tpu_torch.tracing import new_trace_id

            trace = new_trace_id()   # the resume op's lookup key
        with self._lock:
            msg = self._gen_msg(
                prompt, max_new_tokens, temperature, top_p, seed,
                stream=True, timeout=timeout, trace=trace,
                tenant=tenant, priority=priority, model=model)
            received = 0    # tokens already yielded = the resume cursor
            frame = None
            try:
                while True:
                    try:
                        if frame is None:
                            frame = self._request_first(msg)
                        kind = frame[0]
                        if kind == "TOK":
                            toks = list(frame[1])
                            received += len(toks)
                            yield toks
                        elif kind == "DONE":
                            return
                        else:
                            if frame[1] == "unknown_request" and failover:
                                if received == 0:
                                    # nothing delivered yet: replaying
                                    # the original generate is exact
                                    # (see generate())
                                    frame = None
                                    continue
                                # a half-delivered stream the resumed
                                # driver cannot finish (journal commit
                                # raced the crash): replay would repeat
                                # tokens — typed loss instead
                                raise ReplicaFailed(
                                    f"stream lost to driver failover "
                                    f"after {received} token(s): "
                                    f"{frame[2]}")
                            _raise_typed(frame[1], frame[2])
                        frame = self.receive(self._sock)
                    except (OSError, EOFError) as e:
                        if not failover or isinstance(e, TimeoutError):
                            raise
                        frame = self._resume_frame(trace, received,
                                                   True, timeout)
            except GeneratorExit:
                # abandoned mid-stream: unread frames would desync the
                # next request — retire the connection instead
                self.close()
                raise

    # -- control -----------------------------------------------------------
    def stats(self) -> dict:
        """The scheduler's metrics snapshot (counters + ttft/e2e
        percentile summaries + per-replica/per-tenant state)."""
        with self._lock:
            frame = self._request_first({"op": "stats"})
        if frame[0] != "OK":
            _raise_typed(frame[1], frame[2])
        return frame[1]

    def ping(self) -> bool:
        with self._lock:
            return self._request_first({"op": "ping"}) == "OK"

    def close(self) -> None:
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
