"""Cross-host bulk transport: the zero-copy data plane beyond localhost.

The shm ring (``shm.py``) removed the same-host copies, but every
cross-host byte — training ``DataFeed`` chunks, serving intake, batch
``array`` shards, standby weight clones, disaggregated KV-page session
handoffs — still rode the per-message pickle socket
(``reservation.MessageSocket``).  That path is efficient for ONE large
contiguous buffer (out-of-band framing, ``recv_into`` straight into the
final backing store) but keeps two structural costs for realistic
payloads:

- **sub-64 KB buffers travel in-band** (``OOB_MIN_BYTES``): a chunk of
  sample-sized arrays pays a full pickle-stream build on the sender and
  a full copy out of the stream on the receiver — two extra passes over
  every byte.  The threshold exists because per-buffer ``sendall``/
  ``recv_into`` syscalls made small-buffer OOB 5x SLOWER; the fix is not
  a lower threshold but **scatter/gather frames**: many buffers per
  syscall (``sendmsg`` iovecs out, one contiguous slab region in).
- **a fresh receive allocation per message**: every OOB buffer lands in
  a brand-new ``bytearray`` whose pages fault in under ``recv_into``;
  a **pool of pre-registered reusable slabs** keeps the pages warm.

:class:`BulkChannel` is the third transport tier, negotiated during the
queue authkey hello (``queues.py``), preference order **shm > bulk >
per-message pickle**:

- the message is pickled ONCE (protocol 5) with a much lower out-of-band
  threshold (:data:`BULK_OOB_MIN`); the pickle stream travels in a small
  envelope frame, the buffers as a sequence of **chunk frames** — fixed
  20-byte header ``[magic][ver][flags][stream id][seq][length][crc]``
  followed by raw bytes gathered *directly from the source buffers*
  (``sendmsg`` scatter/gather — no intermediate copy of the payload,
  in-band or otherwise);
- buffers are packed into the receiver's slab at 64-byte-aligned offsets
  (:func:`~tensorflowonspark_tpu_torch.shm.aligned_layout`, shared with the
  shm ring); the sender interleaves zero-padding iovecs so the wire
  stream IS the slab image and each chunk is ONE contiguous
  ``recv_into`` — no per-buffer syscalls on either side;
- the receiver hands ``pickle.loads(buffers=...)`` zero-copy
  ``memoryview`` s over the slab, GC-lease-tracked exactly like the shm
  ring's segment views: the slab returns to the pool when the LAST view
  of the message dies;
- **send-side pipelining**: with ``TFOS_BULK_PIPELINE=1`` (default: auto,
  on when the host has >1 CPU) a per-channel writer thread issues the
  ``sendmsg`` for chunk *i* while the caller assembles + checksums chunk
  *i+1* — measured a wash on a 1-core host (everything serializes on the
  GIL anyway), a real overlap on multi-core;
- **per-stream integrity**: every chunk header carries a CRC and the
  stream ends with a digest frame over all chunk CRCs + the total
  length, so a desynced or corrupted stream is rejected as a connection
  error (:class:`BulkIntegrityError`) before any frame of it reaches the
  consumer.  ``TFOS_BULK_CRC`` picks the coverage: ``fast`` (default)
  checksums the first :data:`CRC_SAMPLE_BYTES` of each chunk — catches
  desync, truncation, mis-offset scatter, and stale-slab reuse at ~zero
  cost; ``full`` checksums every byte (measured ~2.4x slower end-to-end
  on a 1-core host: zlib.crc32 runs at ~1.2 GB/s there, i.e. at wire
  speed); ``off`` disables payload CRCs (headers are still validated).
  End-to-end content guarantees stay where they belong: the KV-page
  handoff verifies per-page blake2b hashes in ``adopt_session``
  regardless of transport.

Fallback semantics mirror the shm tier, per message and per connection:

- ``TFOS_TPU_NO_BULK=1`` (or ``bulk=False`` on either endpoint) pins the
  per-message pickle protocol for the whole connection;
- a failed ``bulk_hello`` (old peer, refusing server) silently
  downgrades the connection;
- per message: payloads with no bulk-eligible buffers, below
  :data:`default_min_payload`, or larger than the peer's advertised slab
  (**oversized**) travel as an inline envelope — the same pickle-5
  out-of-band socket framing as the tier below, so backpressure and odd
  shapes degrade throughput, never correctness;
- slab-pool exhaustion (the consumer still holds views over every slab)
  allocates a one-shot slab instead (counted ``pool_miss``) — bulk
  framing is kept, only the page-warm reuse is lost.

Telemetry (docs/observability.md): ``tfos_transport_messages_total`` /
``tfos_transport_bytes_total`` labeled by tier (``bulk``/``inline``) and
direction, ``tfos_transport_chunk_seconds`` per received chunk, and
``tfos_transport_fallbacks_total`` by reason (``handshake`` /
``oversized`` / ``small`` / ``pool_miss``).
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
import time
import weakref
import zlib

import numpy as np

from tensorflowonspark_tpu_torch.shm import aligned_layout, aligned_layout_lens

logger = logging.getLogger(__name__)

__all__ = [
    "BulkChannel", "BulkIntegrityError", "SlabPool", "SlabLease",
    "aligned_layout_lens", "bulk_enabled", "bulk_resolve",
    "hello_payload", "accept_payload",
]

#: kill switch: set to "1" to keep every connection off the bulk tier
DISABLE_ENV = "TFOS_TPU_NO_BULK"
#: wire chunk size in KiB (client proposes, server may clamp down)
CHUNK_KB_ENV = "TFOS_BULK_CHUNK_KB"
#: receive-slab size in MiB — also the oversized-payload bound a peer
#: advertises in the hello
SLAB_MB_ENV = "TFOS_BULK_SLAB_MB"
#: number of reusable receive slabs per channel
SLABS_ENV = "TFOS_BULK_SLABS"
#: minimum total out-of-band bytes before a message takes the bulk path
MIN_KB_ENV = "TFOS_BULK_MIN_KB"
#: payload CRC coverage: "fast" (sampled, default) | "full" | "off"
CRC_ENV = "TFOS_BULK_CRC"
#: "1"/"0" forces the pipelined writer on/off (default: auto by CPU count)
PIPELINE_ENV = "TFOS_BULK_PIPELINE"

#: measured on the loopback-simulated cross-host A/B: 4 MB chunks beat
#: 1 MB by ~25% on a 1-core host (fewer header parses + recv wakeups);
#: the pipelined writer still overlaps at this granularity on multi-core
DEFAULT_CHUNK_BYTES = 4 << 20
DEFAULT_SLAB_BYTES = 32 << 20
DEFAULT_SLABS = 4
DEFAULT_MIN_PAYLOAD = 256 << 10

#: buffers at least this large leave the pickle stream on the bulk path
#: (the gather framing amortizes the old per-buffer syscall cost that
#: forced MessageSocket.OOB_MIN_BYTES up to 64 KB)
BULK_OOB_MIN = 4096
#: per-message buffer-count cap (envelope size + iovec bookkeeping bound)
BULK_MAX_BUFFERS = 4096

#: "fast" CRC mode samples this prefix of every chunk
CRC_SAMPLE_BYTES = 4096

#: hard per-stream byte bound: chunk/digest frame length fields are
#: 32-bit, so a receive capacity above this is clamped at negotiation —
#: payloads beyond it take the inline (pickle-5 socket) path, whose
#: per-buffer size table is 64-bit
MAX_STREAM_BYTES = (1 << 32) - 1

CRC_MODES = ("fast", "full", "off")

#: chunk frame header: magic, version, flags, stream id, seq, length, crc
_HDR = struct.Struct(">BBHIIII")
FRAME_MAGIC = 0xB7
FRAME_VERSION = 1
FLAG_END = 0x1      #: last payload chunk of the stream
FLAG_DIGEST = 0x2   #: stream-digest frame (crc = crc32 over chunk crcs)

#: stay clear of the kernel iovec limit (IOV_MAX, typically 1024) —
#: a chunk needing more segments is simply written in several sendmsg
#: calls, no extra framing required
_IOV_CAP = 512

_ZEROS = bytes(64)  # alignment padding source (gaps are < 64 bytes)


class BulkIntegrityError(EOFError):
    """A bulk stream failed verification (bad header, CRC or digest
    mismatch, sequence gap).  Subclasses ``EOFError`` so every receive
    loop treats the connection as dead — a desynced byte stream cannot
    be resynchronized — but callers log it explicitly first."""


def bulk_enabled() -> bool:
    """False when the operator disabled the bulk tier via env."""
    return os.environ.get(DISABLE_ENV, "").strip() not in ("1", "true", "yes")


def bulk_resolve(param: bool | None) -> bool:
    """Tri-state policy shared by QueueServer and QueueClient (mirrors
    ``shm.shm_resolve``): ``None`` = auto, ``False`` = refuse, ``True``
    = want bulk but the env kill switch still vetoes."""
    return bulk_enabled() if param is None else bool(param) and bulk_enabled()


def default_chunk_bytes() -> int:
    return int(float(os.environ.get(CHUNK_KB_ENV,
                                    DEFAULT_CHUNK_BYTES >> 10)) * 1024)


def default_slab_bytes() -> int:
    return int(float(os.environ.get(SLAB_MB_ENV,
                                    DEFAULT_SLAB_BYTES >> 20)) * (1 << 20))


def default_slabs() -> int:
    return int(os.environ.get(SLABS_ENV, DEFAULT_SLABS))


def default_min_payload() -> int:
    return int(float(os.environ.get(MIN_KB_ENV,
                                    DEFAULT_MIN_PAYLOAD >> 10)) * 1024)


def resolve_crc(proposed: str | None = None) -> str:
    """This endpoint's CRC mode: the env knob wins, else the peer's
    proposal, else ``fast``.  Unknown values fall back to ``fast`` (a
    typo'd knob must not silently disable verification)."""
    mode = os.environ.get(CRC_ENV, "").strip().lower() or proposed or "fast"
    return mode if mode in CRC_MODES else "fast"


def pipeline_resolve() -> bool:
    """Whether to run the pipelined writer thread: env override first,
    else on for multi-core hosts (measured a wash — slightly negative —
    when everything shares one core)."""
    v = os.environ.get(PIPELINE_ENV, "").strip()
    if v in ("1", "true", "yes"):
        return True
    if v in ("0", "false", "no"):
        return False
    return (os.cpu_count() or 1) > 1


# --------------------------------------------------------------------------
# receive side: the reusable slab pool + GC-tracked leases

class SlabPool:
    """Pre-registered reusable receive buffers (module docstring).

    ``acquire`` leases a slab for one incoming stream; the lease's views
    (handed to ``pickle.loads``) anchor it, and the slab returns to the
    free list when the last view dies — the same GC-lease design as the
    shm ring's receive side, applied to process-local memory.  An
    exhausted pool falls back to a one-shot slab (``pool_misses``): the
    bulk framing is unaffected, only page-warm reuse is lost.
    """

    #: floor for a demand-sized slab: small streams still get a
    #: reusable buffer without fragmenting the pool into tiny slabs
    MIN_SLAB = 1 << 20

    def __init__(self, slabs: int | None = None,
                 slab_bytes: int | None = None):
        self.slabs = slabs if slabs is not None else default_slabs()
        self.slab_bytes = (slab_bytes if slab_bytes is not None
                           else default_slab_bytes())
        self._free: list[bytearray] = []
        self._created = 0
        self._lock = threading.Lock()
        self._closed = False
        self.pool_misses = 0

    def _slab_size(self, nbytes: int) -> int:
        # demand-sized: the advertised ``slab_bytes`` is the peer's
        # oversized BOUND, not the allocation — a 32 MB bytearray costs
        # ~15 ms (memset + faults) where 2 MB costs ~0.07 ms, so a
        # stream of 2 MB messages must not pay max-size slabs up front.
        # Round up to the next power of two so the steady repeated-size
        # stream reuses instead of churning near-fit slabs.
        size = max(int(nbytes), self.MIN_SLAB)
        return min(1 << (size - 1).bit_length(), self.slab_bytes)

    def acquire(self, nbytes: int) -> "SlabLease":
        """A lease over a slab with room for ``nbytes`` (caller bounds
        ``nbytes`` by the advertised slab size before sending)."""
        slab = None
        if nbytes <= self.slab_bytes:
            with self._lock:
                # best-fit reuse: the smallest free slab that holds it
                fits = [s for s in self._free if len(s) >= nbytes]
                if fits:
                    slab = min(fits, key=len)
                    self._free.remove(slab)
                elif not self._closed:
                    if self._created >= self.slabs and self._free:
                        # full pool, nothing fits: the stream size grew
                        # past the demand-sized slabs — evict the
                        # smallest free one and allocate bigger in its
                        # place, else every future message would pay the
                        # one-shot path forever
                        self._free.remove(min(self._free, key=len))
                        self._created -= 1
                    if self._created < self.slabs:
                        # pre-fault the pages once: reused slabs then
                        # absorb recv_into without per-message fault
                        # storms
                        slab = bytearray(self._slab_size(nbytes))
                        np.frombuffer(slab, np.uint8)[::4096] = 0
                        self._created += 1
        if slab is None:
            with self._lock:
                self.pool_misses += 1
            return SlabLease(self, bytearray(nbytes), pooled=False)
        return SlabLease(self, slab, pooled=True)

    def _release(self, slab: bytearray) -> None:
        with self._lock:
            if not self._closed:
                self._free.append(slab)

    @property
    def free_slabs(self) -> int:
        with self._lock:
            return len(self._free) + (self.slabs - self._created)

    def close(self) -> None:
        """Drop the free list; leased slabs die with their last view."""
        with self._lock:
            self._closed = True
            self._free = []


class SlabLease:
    """One incoming stream's slab: scatter target, then view factory."""

    def __init__(self, pool: SlabPool, slab: bytearray, pooled: bool):
        self._pool = pool
        self._slab = slab
        self._pooled = pooled
        self.mv = memoryview(slab)

    def views(self, offs: list[int], lens: list[int]) -> list[memoryview]:
        """Zero-copy per-buffer ``memoryview`` s, lease-anchored.

        Identical mechanism to ``shm.SegmentMap.views``: each view wraps
        a per-message ndarray slice; numpy's base collapse lands every
        derived array on it, so the ``weakref.finalize`` fires — and the
        slab returns to the pool — only once NO view of this message's
        data is alive.
        """
        slab_arr = np.frombuffer(self.mv, np.uint8)
        pool, slab, pooled = self._pool, self._slab, self._pooled
        self.mv = None          # views own the buffer from here on
        if pooled:
            # ONE finalizer per message: every view below is a slice of
            # ``slab_arr``, numpy's base collapse makes every array the
            # consumer derives from them reference ``slab_arr`` too — so
            # it dies (and the slab recycles) exactly when the LAST view
            # of this message's data dies.
            weakref.finalize(slab_arr, pool._release, slab)
        return [memoryview(slab_arr[off:off + ln])
                for off, ln in zip(offs, lens)]

    def discard(self) -> None:
        """Abort before views were handed out (stream failed)."""
        self.mv = None
        if self._pooled:
            self._pool._release(self._slab)


# --------------------------------------------------------------------------
# send side: chunk assembly over the aligned layout

def _iter_chunks(bufs: list, offs: list[int], total: int,
                 chunk_bytes: int):
    """Yield ``(clen, iovecs)`` wire chunks covering the aligned layout
    ``[0, total)``: buffer bytes where a buffer is mapped, zero padding
    in the alignment gaps — so the byte stream IS the receiver's slab
    image and each chunk is one contiguous ``recv_into``."""
    spans = []  # (start, memoryview) in layout order, gaps implied
    for off, v in zip(offs, bufs):
        spans.append((off, v.cast("B") if v.format != "B" or v.ndim != 1
                      else v))
    pos = 0
    si = 0
    while pos < total:
        clen = min(chunk_bytes, total - pos)
        end = pos + clen
        iov: list = []
        cur = pos
        while cur < end:
            if si < len(spans):
                s_off, s_v = spans[si]
                if cur < s_off:                      # alignment gap
                    pad = min(s_off, end) - cur
                    while pad > 0:
                        take = min(pad, len(_ZEROS))
                        iov.append(_ZEROS[:take])
                        pad -= take
                        cur += take
                    continue
                s_end = s_off + s_v.nbytes
                take = min(s_end, end) - cur
                iov.append(s_v[cur - s_off:cur - s_off + take])
                cur += take
                if cur >= s_end:
                    si += 1
            else:                                    # trailing gap
                pad = end - cur
                while pad > 0:
                    take = min(pad, len(_ZEROS))
                    iov.append(_ZEROS[:take])
                    pad -= take
                    cur += take
        yield clen, iov
        pos = end


def _chunk_crc(iov: list, mode: str) -> int:
    """Sender-side chunk CRC per the negotiated mode (module docstring):
    chained ``zlib.crc32`` over every byte (``full``) or the first
    :data:`CRC_SAMPLE_BYTES` (``fast``); 0 for ``off``."""
    if mode == "off":
        return 0
    crc = 0
    budget = None if mode == "full" else CRC_SAMPLE_BYTES
    for piece in iov:
        if budget is not None:
            if budget <= 0:
                break
            piece = piece[:budget] if len(piece) > budget else piece
            budget -= len(piece)
        crc = zlib.crc32(piece, crc)
    return crc & 0xFFFFFFFF


def _recv_crc(view: memoryview, mode: str) -> int:
    if mode == "off":
        return 0
    if mode == "fast" and len(view) > CRC_SAMPLE_BYTES:
        view = view[:CRC_SAMPLE_BYTES]
    return zlib.crc32(view) & 0xFFFFFFFF


def _sendmsg_all(sock, iov: list) -> None:
    """``sendmsg`` the full iovec list, handling partial writes and the
    kernel's IOV_MAX by advancing through the list."""
    idx = 0
    skip = 0
    while idx < len(iov):
        batch: list = []
        first = True
        for v in iov[idx:idx + _IOV_CAP]:
            batch.append(v[skip:] if first and skip else v)
            first = False
        sent = sock.sendmsg(batch)
        while sent > 0 and idx < len(iov):
            remaining = len(iov[idx]) - skip
            if sent >= remaining:
                sent -= remaining
                idx += 1
                skip = 0
            else:
                skip += sent
                sent = 0


class _PipelinedWriter:
    """Per-channel writer thread: the caller enqueues fully assembled
    frame iovec lists and immediately assembles (and checksums) the next
    chunk while this thread's ``sendmsg`` blocks in the kernel.  FIFO, so
    frame order on the wire is exactly enqueue order; any socket error is
    latched and re-raised to the next ``write``/``join`` caller."""

    def __init__(self, sock):
        import queue as _q

        self._sock = sock
        self._q: "_q.Queue" = _q.Queue(maxsize=4)
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run,
                                        name="bulk-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if self._exc is None:
                    _sendmsg_all(self._sock, item)
            except Exception as e:
                # ANY escape would kill this thread with frames queued
                # and leave the next flush() deadlocked in Queue.join();
                # latch it instead — write/flush re-raise it to the
                # caller, who treats the connection as dead
                self._exc = e
            finally:
                self._q.task_done()

    def write(self, iov: list) -> None:
        if self._exc is not None:
            raise self._exc
        self._q.put(iov)

    def flush(self) -> None:
        self._q.join()
        if self._exc is not None:
            raise self._exc

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)


# --------------------------------------------------------------------------
# the channel

class BulkChannel:
    """Bulk-aware framing for one authenticated queue connection side
    (module docstring).  Wire envelopes, mirroring ``shm.ShmChannel``:

        {"bulk": {"sid", "lens", "total", "crc", "p"}}   # stream head
        {"p": pickle5-stream, "b": [buf, ...]}           # inline

    A ``bulk`` envelope is followed on the socket by chunk frames
    covering ``total`` bytes (the last one flagged ``FLAG_END``) and one
    digest frame, which this side reads directly off the socket into a
    leased slab.
    """

    def __init__(self, ms, sock, chunk_bytes: int | None = None,
                 peer_max: int | None = None, crc_mode: str = "fast",
                 slabs: int | None = None, slab_bytes: int | None = None,
                 pipeline: bool | None = None):
        self._ms = ms
        self._sock = sock
        self.chunk_bytes = int(chunk_bytes or default_chunk_bytes())
        #: the PEER's receive-slab capacity — our oversized bound
        #: (clamped: the frame headers' length fields are 32-bit)
        self.peer_max = min(int(peer_max or default_slab_bytes()),
                            MAX_STREAM_BYTES)
        self.crc_mode = crc_mode if crc_mode in CRC_MODES else "fast"
        self.min_payload = default_min_payload()
        self._pool = SlabPool(slabs, slab_bytes)
        self._sid = 0
        self._writer: _PipelinedWriter | None = None
        self._pipeline = (pipeline_resolve() if pipeline is None
                          else bool(pipeline))
        # per-channel stats (tests/bench) + process-wide registry metrics
        self.bulk_msgs = 0
        self.inline_msgs = 0
        self.fallbacks = 0
        from tensorflowonspark_tpu_torch import metrics as _metrics

        reg = _metrics.get_registry()
        self._m_msgs = reg.counter(
            "tfos_transport_messages_total",
            "Bulk-transport messages by tier and direction.",
            labelnames=("tier", "dir"))
        self._m_bytes = reg.counter(
            "tfos_transport_bytes_total",
            "Bulk-transport payload bytes by tier and direction.",
            labelnames=("tier", "dir"))
        self._m_chunk = reg.histogram(
            "tfos_transport_chunk_seconds",
            "Receive time per bulk chunk frame.")
        self._m_fall = reg.counter(
            "tfos_transport_fallbacks_total",
            "Messages that left the bulk path, by reason.",
            labelnames=("reason",))

    # -- send --------------------------------------------------------------
    def send(self, msg) -> None:
        data, bufs = self._ms.split_oob(msg, oob_min=BULK_OOB_MIN,
                                        max_buffers=BULK_MAX_BUFFERS)
        offs, total = aligned_layout(bufs) if bufs else ([], 0)
        raw = sum(v.nbytes for v in bufs)
        if not bufs or total < self.min_payload or total > self.peer_max:
            if bufs:
                self.fallbacks += 1
                self._m_fall.inc(reason="oversized" if total > self.peer_max
                                 else "small")
            self.inline_msgs += 1
            self._m_msgs.inc(tier="inline", dir="tx")
            self._m_bytes.inc(raw + len(data), tier="inline", dir="tx")
            # inline: the ALREADY-pickled stream + buffers re-wrapped as
            # uint8 arrays ride MessageSocket's own out-of-band framing
            # (no re-pickle, no extra copies) — the per-message tier
            p = np.frombuffer(data, np.uint8) \
                if len(data) >= self._ms.OOB_MIN_BYTES else data
            self._write_frames([self._ms.frame_bytes(
                {"p": p, "b": [np.frombuffer(v, np.uint8) for v in bufs]})])
            self._flush()
            return
        self._sid += 1
        sid = self._sid
        env = self._ms.frame_bytes(
            {"bulk": {"sid": sid, "lens": [v.nbytes for v in bufs],
                      "total": total, "crc": self.crc_mode, "p": data}})
        self._write_frames([env])
        seq = 0
        digest = 0
        pos = 0
        for clen, iov in _iter_chunks(bufs, offs, total, self.chunk_bytes):
            pos += clen
            crc = _chunk_crc(iov, self.crc_mode)
            digest = zlib.crc32(crc.to_bytes(4, "big"), digest)
            flags = FLAG_END if pos >= total else 0
            hdr = _HDR.pack(FRAME_MAGIC, FRAME_VERSION, flags, sid, seq,
                            clen, crc)
            self._write_frames([[hdr, *iov]])
            seq += 1
        hdr = _HDR.pack(FRAME_MAGIC, FRAME_VERSION, FLAG_DIGEST, sid, seq,
                        total, digest & 0xFFFFFFFF)
        self._write_frames([[hdr]])
        self._flush()
        self.bulk_msgs += 1
        self._m_msgs.inc(tier="bulk", dir="tx")
        self._m_bytes.inc(raw, tier="bulk", dir="tx")

    def _write_frames(self, frames: list) -> None:
        for iov in frames:
            if self._pipeline:
                if self._writer is None:
                    self._writer = _PipelinedWriter(self._sock)
                self._writer.write(iov)
            else:
                _sendmsg_all(self._sock, iov)

    def _flush(self) -> None:
        # the strict request-response protocol means the caller reads a
        # reply next; the writer must have drained first so a writer
        # error surfaces here, on the message that caused it
        if self._writer is not None:
            self._writer.flush()

    # -- receive -----------------------------------------------------------
    def receive(self):
        env = self._ms.receive(self._sock)
        if not isinstance(env, dict) or not ("bulk" in env or "p" in env):
            return env      # un-enveloped control frame: pass through
        bulk = env.get("bulk")
        if bulk is None:
            p = env["p"]
            if not isinstance(p, (bytes, bytearray)):   # uint8-wrapped
                p = memoryview(p)
            bufs = env["b"]
            self._m_msgs.inc(tier="inline", dir="rx")
            self._m_bytes.inc(sum(len(b) for b in bufs) + len(p),
                              tier="inline", dir="rx")
            return pickle.loads(p, buffers=bufs)
        return self._receive_stream(bulk)

    def _receive_stream(self, bulk: dict):
        lens = bulk["lens"]
        total = int(bulk["total"])
        sid = int(bulk["sid"])
        mode = bulk.get("crc", self.crc_mode)
        offs, expect_total = aligned_layout_lens(lens)
        if expect_total != total:
            raise BulkIntegrityError(
                f"bulk stream {sid}: advertised total {total} != layout "
                f"total {expect_total}")
        lease = self._pool.acquire(total)
        ok = False
        try:
            mv = lease.mv
            pos = 0
            seq = 0
            digest = 0
            while True:
                t0 = time.perf_counter()
                magic, ver, flags, h_sid, h_seq, clen, crc = _HDR.unpack(
                    self._ms._recv_exact(self._sock, _HDR.size))
                if magic != FRAME_MAGIC or ver != FRAME_VERSION:
                    raise BulkIntegrityError(
                        f"bulk chunk magic/version mismatch: "
                        f"(0x{magic:02x}, v{ver})")
                if h_sid != sid:
                    raise BulkIntegrityError(
                        f"bulk stream id mismatch: chunk {h_sid} inside "
                        f"stream {sid}")
                if flags & FLAG_DIGEST:
                    if pos != total or h_seq != seq:
                        raise BulkIntegrityError(
                            f"bulk stream {sid} truncated: digest after "
                            f"{pos}/{total} bytes, {seq} chunk(s)")
                    if mode != "off" and crc != (digest & 0xFFFFFFFF):
                        raise BulkIntegrityError(
                            f"bulk stream {sid} digest mismatch")
                    if clen != total:
                        raise BulkIntegrityError(
                            f"bulk stream {sid} digest length mismatch: "
                            f"{clen} != {total}")
                    break
                if h_seq != seq:
                    raise BulkIntegrityError(
                        f"bulk stream {sid} sequence gap: chunk {h_seq}, "
                        f"expected {seq}")
                if pos + clen > total:
                    raise BulkIntegrityError(
                        f"bulk stream {sid} overrun: {pos + clen} > {total}")
                self._ms._recv_exact_into(self._sock, mv[pos:pos + clen])
                if mode != "off":
                    got = _recv_crc(mv[pos:pos + clen], mode)
                    if got != crc:
                        raise BulkIntegrityError(
                            f"bulk stream {sid} chunk {seq} CRC mismatch "
                            f"({mode}): 0x{got:08x} != 0x{crc:08x}")
                digest = zlib.crc32(crc.to_bytes(4, "big"), digest)
                pos += clen
                seq += 1
                self._m_chunk.record(time.perf_counter() - t0)
            views = lease.views(offs, lens)
            ok = True
            self.bulk_msgs += 1
            self._m_msgs.inc(tier="bulk", dir="rx")
            self._m_bytes.inc(sum(lens), tier="bulk", dir="rx")
            return pickle.loads(bulk["p"], buffers=views)
        finally:
            if not ok:
                lease.discard()

    # -- stats / lifecycle -------------------------------------------------
    @property
    def stats(self) -> dict:
        return {"bulk_msgs": self.bulk_msgs,
                "inline_msgs": self.inline_msgs,
                "fallbacks": self.fallbacks,
                "pool_misses": self._pool.pool_misses,
                "free_slabs": self._pool.free_slabs}

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._pool.close()


# --------------------------------------------------------------------------
# negotiation payloads (the queue hello's third tier — queues.py drives)

def hello_payload() -> dict:
    """The client's ``bulk_hello`` body: proposed chunk size, this side's
    receive capacity (the server's oversized bound for responses), CRC
    proposal, and the frame version."""
    return {"op": "bulk_hello", "ver": FRAME_VERSION,
            "chunk": default_chunk_bytes(), "max": default_slab_bytes(),
            "crc": resolve_crc()}


def accept_payload(hello: dict) -> dict | None:
    """Server side: validate a ``bulk_hello`` and compute the negotiated
    parameters (None = refuse).  The chunk size is the smaller of the two
    proposals; each side keeps its own receive capacity and advertises it
    so the PEER can bound outgoing payloads; the server resolves the CRC
    mode (its env knob wins over the client proposal).  The returned
    ``peer_max`` (the client's validated capacity) is for the SERVER's
    own channel — callers pop it before relaying the rest to the
    client."""
    try:
        if int(hello.get("ver")) != FRAME_VERSION:
            return None
        chunk = min(int(hello["chunk"]), default_chunk_bytes())
        if chunk < 4096:
            return None
        # a malformed capacity refuses the hello rather than killing the
        # serve thread later; 0/absent falls back to this side's default
        peer_max = int(hello.get("max") or 0) or None
        return {"chunk": chunk, "max": default_slab_bytes(),
                "crc": resolve_crc(hello.get("crc")),
                "peer_max": peer_max}
    except (TypeError, ValueError, KeyError):
        return None
