"""TFRecord file IO: native C++ codec with a pure-Python fallback.

Port of ``tensorflowonspark_tpu/tfrecord.py``, copied; only the build of
the native codec changes.  The reference reads/writes TFRecords through
the JVM ``tensorflow-hadoop`` JAR (``dfutil.py::saveAsTFRecords`` →
``saveAsNewAPIHadoopFile`` with ``TFRecordFileOutputFormat``) and TF's C++
readers; this module is the JVM-free native equivalent.  Framing + CRC32C
run in the port's own copy of the codec, ``native/tfrecord.cc``, which
:func:`build_native` compiles with ``g++`` at first use into
``build/torch_native/`` at the checkout's root (never beside the source);
Python keeps only file handling, so the per-record hot path never
computes checksums in the interpreter.  When no compiler is available the
pure-Python CRC32C fallback keeps everything working (slower, same
format).  The codec is host code: no device is involved.

The format is byte-identical to TensorFlow's, so files written here load in
``tf.data.TFRecordDataset`` and vice versa.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import stat
import struct
import subprocess
import tempfile
from typing import Iterable, Iterator

logger = logging.getLogger(__name__)

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "tfrecord.cc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None          # ctypes CDLL once loaded
_lib_failed = False  # don't retry a failed build every call


def _trusted_so(so_path: str) -> bool:
    """Only dlopen a library owned by us (or root) and not writable by
    anyone else."""
    try:
        st = os.lstat(so_path)
    except OSError:
        return False
    return (stat.S_ISREG(st.st_mode)
            and st.st_uid in (os.getuid(), 0)
            and not (st.st_mode & 0o022))


def build_native() -> str:
    """Compile ``native/tfrecord.cc`` into ``BUILD_DIR`` unless a library
    built from the same source and flags is already there; return its
    path.  The library's name carries a hash of the source and the flags.
    It is compiled under an unpredictable temporary name (``mkstemp``) and
    renamed into place, so workers that build at once never load a
    half-written file.  Raises when ``g++`` fails or is missing."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libtfrecord.{digest}.so")
    if os.path.exists(so_path) and _trusted_so(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libtfrecord.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SOURCE, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o755)
        os.replace(tmp, so_path)  # atomic: concurrent builders both succeed
        tmp = None
    finally:
        if tmp is not None:  # failed build: don't litter the build dir
            os.unlink(tmp)
    logger.info("built native TFRecord codec: %s", so_path)
    return so_path


def _native():
    """Load (building if needed) the native codec; None → use Python fallback."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        so_path = build_native()
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("no native TFRecord codec (%s); using pure-Python CRC32C", e)
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(so_path)
        lib.tfr_masked_crc.restype = ctypes.c_uint32
        lib.tfr_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.tfr_crc32c.restype = ctypes.c_uint32
        lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.tfr_frame.restype = ctypes.c_size_t
        lib.tfr_frame.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        lib.tfr_next.restype = ctypes.c_int64
        lib.tfr_next.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_size_t),
                                 ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.exp_scan.restype = ctypes.c_int64
        lib.exp_scan.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i64p,
                                 ctypes.c_int64]
        lib.exp_read_int64.restype = ctypes.c_int64
        lib.exp_read_int64.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i64p,
                                       ctypes.c_int64]
        lib.exp_read_float.restype = ctypes.c_int64
        lib.exp_read_float.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64]
        lib.exp_read_bytes.restype = ctypes.c_int64
        lib.exp_read_bytes.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i64p,
                                       ctypes.c_int64]
    except (OSError, AttributeError) as e:  # stale/corrupt/wrong-arch cache
        logger.warning("native TFRecord codec failed to load (%s); "
                       "using pure-Python CRC32C", e)
        _lib_failed = True
        return None
    _lib = lib
    return _lib


# -- pure-Python CRC32C fallback (same Castagnoli polynomial) ---------------

_PY_TABLE: list[int] | None = None


def _py_table() -> list[int]:
    global _PY_TABLE
    if _PY_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _PY_TABLE = table
    return _PY_TABLE


def crc32c(data: bytes) -> int:
    data = bytes(data)  # ctypes c_char_p rejects bytearray/memoryview
    lib = _native()
    if lib is not None:
        return lib.tfr_crc32c(data, len(data))
    table = _py_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    data = bytes(data)
    lib = _native()
    if lib is not None:
        return lib.tfr_masked_crc(data, len(data))
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- framing ----------------------------------------------------------------

def frame_record(data: bytes) -> bytes:
    """One framed TFRecord: len + crc(len) + data + crc(data)."""
    data = bytes(data)
    lib = _native()
    if lib is not None:
        out = ctypes.create_string_buffer(len(data) + 16)
        n = lib.tfr_frame(data, len(data), out)
        return out.raw[:n]
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc(header)) + data
            + struct.pack("<I", masked_crc(data)))


class TFRecordCorruptError(ValueError):
    """A framing/CRC failure in a TFRecord stream, carrying *where*: the
    source ``path`` (None for in-memory buffers) and the byte ``offset``
    of the record whose frame failed — enough to seek straight to the
    damage with ``dd``/``xxd`` instead of re-deriving it from a bare
    ``struct.error``."""

    def __init__(self, reason: str, *, path: str | None = None,
                 offset: int | None = None):
        where = f" at offset {offset}" if offset is not None else ""
        src = f" in {path!r}" if path else ""
        super().__init__(f"{reason}{where}{src}")
        self.path = path
        self.offset = offset


def iter_records(buf: bytes, verify: bool = True,
                 path: str | None = None) -> Iterator[bytes]:
    """Yield record payloads from an in-memory TFRecord file image.
    ``path`` only labels corruption errors with the buffer's origin."""
    buf = bytes(buf)
    lib = _native()
    off = 0
    if lib is not None:
        d_off = ctypes.c_size_t()
        d_len = ctypes.c_size_t()
        while True:
            nxt = lib.tfr_next(buf, len(buf), off, ctypes.byref(d_off),
                               ctypes.byref(d_len), int(verify))
            if nxt == -1:
                return
            if nxt == -2:
                raise TFRecordCorruptError("truncated record",
                                           path=path, offset=off)
            if nxt in (-3, -4):
                raise TFRecordCorruptError(
                    f"crc mismatch ({'length' if nxt == -3 else 'data'})",
                    path=path, offset=off)
            yield buf[d_off.value:d_off.value + d_len.value]
            off = nxt
        return
    # Python fallback
    n = len(buf)
    while off < n:
        if off + 12 > n:
            raise TFRecordCorruptError("truncated record",
                                       path=path, offset=off)
        header = buf[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        (len_crc,) = struct.unpack("<I", buf[off + 8:off + 12])
        if verify and len_crc != masked_crc(header):
            raise TFRecordCorruptError("crc mismatch (length)",
                                       path=path, offset=off)
        if off + 16 + length > n:
            raise TFRecordCorruptError("truncated record",
                                       path=path, offset=off)
        data = buf[off + 12:off + 12 + length]
        (data_crc,) = struct.unpack("<I", buf[off + 12 + length:off + 16 + length])
        if verify and data_crc != masked_crc(data):
            raise TFRecordCorruptError("crc mismatch (data)",
                                       path=path, offset=off)
        yield data
        off += 16 + length


# -- file API ---------------------------------------------------------------

class TFRecordWriter:
    """Write framed records to a file (tf.io.TFRecordWriter analogue).

    ``path`` may be local or any fsspec scheme (``gs://``, ``memory://``,
    ...) — the HDFS-write capability the reference gets from the
    tensorflow-hadoop JAR (``dfutil.py::saveAsTFRecords``).
    """

    def __init__(self, path: str):
        from tensorflowonspark_tpu_torch import filesystem as fsutil

        self.path = path
        self._f = fsutil.open_output(path, "wb")

    def write(self, record: bytes) -> None:
        self._f.write(frame_record(record))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Stream record payloads from a TFRecord file.

    True streaming (header, then exact-size payload read) — multi-GB part
    files are never slurped whole, matching ``tf.data.TFRecordDataset``'s
    memory profile.  CRCs still run natively via :func:`masked_crc`.
    ``path`` may be local or any fsspec scheme (``gs://``, ``s3://``).
    """
    from tensorflowonspark_tpu_torch import filesystem as fsutil

    with fsutil.open_file(path, "rb") as f:
        off = 0
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise TFRecordCorruptError("truncated record (tail shorter "
                                           "than the 12-byte frame header)",
                                           path=path, offset=off)
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify and len_crc != masked_crc(header[:8]):
                raise TFRecordCorruptError("crc mismatch (length)",
                                           path=path, offset=off)
            body = f.read(length + 4)
            if len(body) < length + 4:
                raise TFRecordCorruptError(
                    f"truncated record (payload ends {length + 4 - len(body)}"
                    " byte(s) early)", path=path, offset=off)
            data = body[:length]
            if verify and struct.unpack("<I", body[length:])[0] != masked_crc(data):
                raise TFRecordCorruptError("crc mismatch (data)",
                                           path=path, offset=off)
            yield data
            off += 16 + length


def write_records(path: str, records: Iterable[bytes]) -> int:
    """Write all ``records`` to ``path``; returns the record count."""
    count = 0
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
            count += 1
    return count
