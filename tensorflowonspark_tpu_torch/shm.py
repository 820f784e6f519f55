"""Zero-copy shared-memory transport for the same-host feed hop.

SURVEY.md §3.2 names the per-sample Python/TCP boundary as the reference's
documented data-plane bottleneck; the chunked pickle-5 socket protocol
(``queues.py`` + ``reservation.MessageSocket``) took the per-sample and
per-byte copies off that path and measured 903 MB/s loopback — enough for
today's 2550 img/s ResNet headline but thin against the ~1.2 GB/s a
0.4-MFU chip implies (VERDICT r5 Weak #7).  This module removes the
remaining copies for the **same-host** hop: large ndarray chunk payloads
are written **once** into a ``multiprocessing.shared_memory`` segment and
the consumer reconstructs them as **zero-copy numpy views** over that
segment — no socket writes, no kernel copies, no receive-side allocation.

Design (one :class:`ShmChannel` per authenticated queue connection side):

- **Sender-owned segment ring.**  Each direction's sender lazily creates a
  ring of named shm segments (:class:`SegmentRing`).  A message's
  out-of-band pickle-5 buffers (the same ``buffer_callback`` split
  ``MessageSocket.send`` uses) are packed into ONE free segment; the
  pickle stream plus ``(segment, offsets)`` descriptors travel over the
  existing TCP socket as a small control frame.
- **Zero-copy receive with GC-tracked leases.**  The receiver maps the
  segment (cached per name) and hands ``pickle.loads(buffers=...)`` one
  ``memoryview`` per buffer, each anchored to a weakref-able per-message
  lease array.  numpy's view-base collapse lands every derived view on
  that memoryview, so the lease dies exactly when the LAST live view of
  the message's data dies — only then is the segment scheduled for reuse.
- **Piggybacked release channel.**  Released segment names ride in the
  ``rel`` field of the next frame the receiver sends on the same
  connection (the queue protocol is strict request-response, so every put
  gets a response to carry them).  No extra sockets, no polling.
- **Transparent fallback.**  Ring exhausted (consumer still holds every
  slot), payload larger than a slot, segment creation failure, cross-host
  peer, or ``TFOS_TPU_NO_SHM=1`` — the message simply travels the socket
  path instead.  Fallback is per-message: backpressure degrades throughput,
  never correctness.

Same-host negotiation happens during the queue authkey hello: the client
creates a tiny probe segment with a random token and the server proves it
can read it back (:class:`Probe` / :func:`verify_probe`) — a positive
proof that the two processes really share memory, immune to hostname or
boot-id aliasing between containers.

Cleanup: segments are closed AND unlinked by their owning ring
(``SegmentRing.close``) when the connection closes, even while a
same-process consumer still holds views (Linux keeps the memory alive
until the last map dies; only the name is removed).  A crashed owner is
covered by ``multiprocessing``'s resource tracker, which unlinks leaked
segments when the owning process dies.
"""

from __future__ import annotations

import logging
import os
import pickle
import secrets
import threading
import weakref
from multiprocessing import shared_memory

import numpy as np

logger = logging.getLogger(__name__)

#: kill switch: set to "1" to force every connection onto the socket path
DISABLE_ENV = "TFOS_TPU_NO_SHM"
#: ring size (segments per sender); each in-flight unreleased message
#: holds one — beyond this, messages fall back to the socket path
SLOTS_ENV = "TFOS_SHM_SLOTS"
#: per-segment size in MiB; a message whose out-of-band bytes exceed this
#: falls back to the socket path
SLOT_MB_ENV = "TFOS_SHM_SLOT_MB"

DEFAULT_SLOTS = 8
DEFAULT_SLOT_BYTES = 32 << 20

#: buffer offsets inside a segment are padded to this (cache-line) boundary
_ALIGN = 64

#: /dev/shm name prefix for every segment this module creates
SEG_PREFIX = "tfos-shm-"


def shm_enabled() -> bool:
    """False when the operator disabled the shm path via ``TFOS_TPU_NO_SHM``."""
    return os.environ.get(DISABLE_ENV, "").strip() not in ("1", "true", "yes")


def shm_resolve(param: bool | None) -> bool:
    """The tri-state shm policy shared by QueueServer and QueueClient:
    ``None`` = auto (negotiate when the env allows), ``False`` = pin the
    socket protocol, ``True`` = want shm but the env kill switch still
    vetoes."""
    return shm_enabled() if param is None else bool(param) and shm_enabled()


def default_slots() -> int:
    return int(os.environ.get(SLOTS_ENV, DEFAULT_SLOTS))


def default_slot_bytes() -> int:
    return int(float(os.environ.get(SLOT_MB_ENV, DEFAULT_SLOT_BYTES >> 20))
               * (1 << 20))


def _new_name(kind: str) -> str:
    # pid in the name: a human inspecting /dev/shm can map a leak to its
    # owner, and stale-segment sweeps can check liveness via /proc/<pid>
    return f"{SEG_PREFIX}{kind}-{os.getpid()}-{secrets.token_hex(6)}"


# --------------------------------------------------------------------------
# same-host probe (negotiated during the queue authkey hello)

class Probe:
    """Client side of the same-host proof: a tiny throwaway segment holding
    a random token the server must read back."""

    TOKEN_LEN = 16

    def __init__(self):
        self.token = secrets.token_bytes(self.TOKEN_LEN)
        self._seg = shared_memory.SharedMemory(
            name=_new_name("probe"), create=True, size=self.TOKEN_LEN)
        self._seg.buf[: self.TOKEN_LEN] = self.token
        self.name = self._seg.name

    def close(self) -> None:
        try:
            self._seg.close()
            self._seg.unlink()
        except (OSError, BufferError):  # pragma: no cover
            pass


def verify_probe(name: str, token: bytes) -> bool:
    """Server side: attach ``name`` and compare its content with ``token``.
    True means the peer's memory is genuinely shared with this process."""
    if not isinstance(token, bytes) or not token:
        return False  # malformed hello must downgrade, not kill the thread
    if not isinstance(name, str) or not name.startswith(SEG_PREFIX):
        return False  # never attach arbitrary segment names
    try:
        seg = shared_memory.SharedMemory(name=name, create=False)
    except (OSError, ValueError):
        return False
    try:
        return bytes(seg.buf[: len(token)]) == bytes(token)
    finally:
        seg.close()


# --------------------------------------------------------------------------
# sender side: the segment ring

class SegmentRing:
    """Sender-owned pool of shm segments, one message per segment.

    Segments are created lazily up to ``slots``; ``alloc`` returns None
    (→ socket fallback) when every segment is leased by the peer or the
    payload doesn't fit.  The owner closes AND unlinks everything on
    ``close`` — on Linux, unlink only removes the /dev/shm name, so a
    consumer still holding views keeps the memory alive until they die.
    """

    def __init__(self, slots: int | None = None,
                 slot_bytes: int | None = None):
        self.slots = slots if slots is not None else default_slots()
        self.slot_bytes = slot_bytes if slot_bytes is not None \
            else default_slot_bytes()
        self._free: list[shared_memory.SharedMemory] = []
        self._leased: dict[str, shared_memory.SharedMemory] = {}
        self._created = 0
        self._lock = threading.Lock()
        self._closed = False
        # observability (bench + tests): messages sent via shm vs fallback
        self.shm_msgs = 0
        self.fallbacks = 0

    def alloc(self, nbytes: int) -> shared_memory.SharedMemory | None:
        """Lease a segment with room for ``nbytes``, or None (fallback)."""
        if nbytes > self.slot_bytes:
            return None
        with self._lock:
            if self._closed:
                return None
            if not self._free and self._created < self.slots:
                try:
                    seg = shared_memory.SharedMemory(
                        name=_new_name("ring"), create=True,
                        size=self.slot_bytes)
                except (OSError, ValueError) as e:
                    logger.warning("shm segment creation failed (%s); "
                                   "falling back to socket", e)
                    self.slots = self._created  # don't retry every message
                    return None
                self._created += 1
                self._free.append(seg)
            if not self._free:
                return None
            seg = self._free.pop()
            self._leased[seg.name] = seg
            return seg

    def release(self, name: str) -> None:
        """Return a peer-released segment to the free list (idempotent;
        unknown names — e.g. releases racing a close — are ignored)."""
        with self._lock:
            seg = self._leased.pop(name, None)
            if seg is not None and not self._closed:
                self._free.append(seg)
            elif seg is not None:  # released after close: finish cleanup
                _close_unlink(seg)

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free) + (self.slots - self._created)

    def segment_names(self) -> list[str]:
        with self._lock:
            return [s.name for s in self._free] + list(self._leased)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            segs = self._free + list(self._leased.values())
            self._free = []
            self._leased = {}
        for seg in segs:
            _close_unlink(seg)


def _close_unlink(seg: shared_memory.SharedMemory) -> None:
    try:
        seg.unlink()  # unlink FIRST: must happen even if close() raises
    except (OSError, FileNotFoundError):
        pass
    _quiet_close(seg)


def _quiet_close(seg: shared_memory.SharedMemory) -> None:
    """``seg.close()`` that tolerates live zero-copy views.

    A same-process consumer may still hold views over the mapping, which
    makes ``mmap.close`` raise BufferError (and raise AGAIN from
    ``SharedMemory.__del__`` at GC, as an un-silenceable "Exception
    ignored" message).  In that case drop our handles instead: the
    mapping stays alive exactly until the last view dies, the fd is
    released now, and ``__del__`` finds nothing left to close."""
    try:
        seg.close()
        return
    except BufferError:
        pass
    except OSError:  # pragma: no cover
        return
    try:
        fd = getattr(seg, "_fd", -1)
        if fd >= 0:
            os.close(fd)
            seg._fd = -1
    except OSError:  # pragma: no cover
        pass
    seg._buf = None
    seg._mmap = None


# NOTE on the resource tracker: pre-3.13 ``SharedMemory`` registers
# ATTACHES as well as creates (bpo-39959).  Within one spawn family the
# tracker process is shared, so the registry holds ONE entry per name and
# the owner's ``unlink`` balances it exactly — manually unregistering the
# attach side here would double-unregister and crash the tracker.  The
# attach-side registration is also what cleans up after an owner that
# died without running ``SegmentRing.close``.


# --------------------------------------------------------------------------
# receiver side: attach cache + GC-tracked leases

class _Lease:
    """Countdown shared by all buffer views of one message: when the last
    view dies, the segment name is queued for release to the sender."""

    __slots__ = ("count", "name", "on_release", "lock")

    def __init__(self, count: int, name: str, on_release):
        self.count = count
        self.name = name
        self.on_release = on_release
        self.lock = threading.Lock()

    def drop(self) -> None:
        with self.lock:
            self.count -= 1
            done = self.count == 0
        if done:
            try:
                self.on_release(self.name)
            # tfos: ignore[broad-except] — GC-lease callback can fire during
            # interpreter shutdown when modules are already torn down
            except Exception:  # pragma: no cover
                pass


class SegmentMap:
    """Receiver-side cache of attached peer segments."""

    def __init__(self):
        self._segs: dict[str, tuple[shared_memory.SharedMemory, np.ndarray]] = {}
        self._lock = threading.Lock()

    def _attach(self, name: str) -> np.ndarray:
        with self._lock:
            hit = self._segs.get(name)
            if hit is None:
                seg = shared_memory.SharedMemory(name=name, create=False)
                hit = (seg, np.frombuffer(seg.buf, np.uint8))
                self._segs[name] = hit
            return hit[1]

    def views(self, name: str, offs: list[int], lens: list[int],
              on_release) -> list[memoryview]:
        """One zero-copy ``memoryview`` per buffer, lease-anchored.

        Each view wraps a fresh per-message ndarray slice; the memoryview
        C-anchors that slice, and numpy's base collapse makes EVERY array
        derived from the reconstructed data reference the memoryview — so
        the ``weakref.finalize`` on the slice fires only once no view of
        this message's data (user-derived slices included) is alive.
        """
        seg_arr = self._attach(name)
        lease = _Lease(len(offs), name, on_release)
        out = []
        for off, ln in zip(offs, lens):
            anchor = seg_arr[off:off + ln]
            weakref.finalize(anchor, lease.drop)
            out.append(memoryview(anchor))
        return out

    def close(self) -> None:
        with self._lock:
            segs = [s for s, _ in self._segs.values()]
            self._segs = {}
        for seg in segs:
            _quiet_close(seg)  # attach side never unlinks — not the owner


# --------------------------------------------------------------------------
# the channel: shm framing over an authenticated MessageSocket connection

class ShmChannel:
    """Bidirectional shm-aware framing for one queue connection side.

    Wraps an authenticated socket + :class:`~tensorflowonspark_tpu_torch.
    reservation.MessageSocket` owner.  Every frame in shm mode is an
    envelope dict around the message's ONE ``split_oob`` pickle pass:

        {"rel": [seg, ...], "shm": {"seg": name, "offs": [...],
                                    "lens": [...], "p": pickle5-bytes}}
        {"rel": [seg, ...], "p": pickle5-stream, "b": [buf, ...]}  # socket
                                                                   # path

    On the socket path the stream and buffers are re-wrapped as uint8
    arrays so MessageSocket's own out-of-band framing carries them with
    no re-pickle and no extra copies.  ``rel`` carries this side's
    pending lease releases (segments owned by the PEER whose last view
    died here) on every outbound frame.
    """

    def __init__(self, ms, sock, ring_slots: int | None = None,
                 slot_bytes: int | None = None):
        self._ms = ms
        self._sock = sock
        self._ring_slots = ring_slots
        self._slot_bytes = slot_bytes
        self._ring: SegmentRing | None = None   # lazy: outbound only
        self._map = SegmentMap()
        self._pending_rel: list[str] = []
        self._rel_lock = threading.Lock()
        # telemetry (metrics.py): shm-vs-fallback message counts and bytes
        # across every channel in this process (per-channel stats stay on
        # the ring for bench/tests)
        from tensorflowonspark_tpu_torch import metrics as _metrics

        reg = _metrics.get_registry()
        self._m_msgs = reg.counter(
            "tfos_shm_messages_total",
            "Data-plane messages with out-of-band buffers, by transport "
            "path.", labelnames=("path",))
        self._m_bytes = reg.counter(
            "tfos_shm_payload_bytes_total",
            "Out-of-band payload bytes moved, by transport path.",
            labelnames=("path",))

    # -- release plumbing --------------------------------------------------
    def _queue_release(self, name: str) -> None:
        # called from weakref finalizers on arbitrary (consumer) threads
        with self._rel_lock:
            self._pending_rel.append(name)

    def _drain_releases(self) -> list[str]:
        with self._rel_lock:
            rel, self._pending_rel = self._pending_rel, []
        return rel

    # -- send --------------------------------------------------------------
    def send(self, msg) -> None:
        rel = self._drain_releases()
        data, bufs = self._ms.split_oob(msg)  # the ONE pickle pass
        if bufs:
            offs, total = aligned_layout(bufs)
            if self._ring is None:
                self._ring = SegmentRing(self._ring_slots, self._slot_bytes)
            seg = self._ring.alloc(total)
            if seg is not None:
                sv = seg.buf
                for off, v in zip(offs, bufs):
                    sv[off:off + v.nbytes] = v.cast("B")  # the ONE copy
                self._ring.shm_msgs += 1
                self._m_msgs.inc(path="shm")
                self._m_bytes.inc(sum(v.nbytes for v in bufs), path="shm")
                self._ms.send(self._sock, {
                    "rel": rel,
                    "shm": {"seg": seg.name, "offs": offs,
                            "lens": [v.nbytes for v in bufs], "p": data}})
                return
            self._ring.fallbacks += 1
            self._m_msgs.inc(path="fallback")
            self._m_bytes.inc(sum(v.nbytes for v in bufs), path="fallback")
        # socket path: ship the ALREADY-pickled stream + buffers wrapped
        # as uint8 arrays — MessageSocket's out-of-band framing moves the
        # buffers (and a large stream) with no re-pickle and no copies
        p = np.frombuffer(data, np.uint8) \
            if len(data) >= self._ms.OOB_MIN_BYTES else data
        self._ms.send(self._sock, {
            "rel": rel, "p": p,
            "b": [np.frombuffer(v, np.uint8) for v in bufs]})

    # -- receive -----------------------------------------------------------
    def receive(self):
        env = self._ms.receive(self._sock)
        if self._ring is not None:
            for name in env.get("rel", ()):
                self._ring.release(name)
        sh = env.get("shm")
        if sh is not None:
            views = self._map.views(sh["seg"], sh["offs"], sh["lens"],
                                    self._queue_release)
            return pickle.loads(sh["p"], buffers=views)
        p = env["p"]
        if not isinstance(p, (bytes, bytearray)):  # uint8-array-wrapped
            p = memoryview(p)
        return pickle.loads(p, buffers=env["b"])

    # -- stats / lifecycle -------------------------------------------------
    @property
    def stats(self) -> dict:
        ring = self._ring
        return {"shm_msgs": ring.shm_msgs if ring else 0,
                "fallbacks": ring.fallbacks if ring else 0,
                "free_slots": ring.free_slots if ring else None}

    def ring_segment_names(self) -> list[str]:
        return self._ring.segment_names() if self._ring is not None else []

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()
        self._map.close()


def aligned_layout_lens(lens: list[int]) -> tuple[list[int], int]:
    """Cache-line-aligned offsets + padded total from buffer LENGTHS —
    the ONE packing-layout implementation.  Both transports share it (a
    shm segment here; a sender's wire stream and the matching receive
    slab in ``transport.py``), so sender and receiver offsets can never
    diverge and reconstructed arrays stay ``_ALIGN``-byte aligned."""
    offs = []
    pos = 0
    for n in lens:
        offs.append(pos)
        pos += (int(n) + _ALIGN - 1) & ~(_ALIGN - 1)
    return offs, pos


def aligned_layout(bufs: list[memoryview]) -> tuple[list[int], int]:
    """Sender-side form of :func:`aligned_layout_lens` over memoryviews."""
    return aligned_layout_lens([v.nbytes for v in bufs])
