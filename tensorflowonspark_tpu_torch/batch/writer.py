"""Committed shard outputs: TFRecord parts with atomic rename-commit.

One output part per (shard, trial): ``<output_dir>/parts/<key>.tfrecord``,
written by the scoring worker.  The part is streamed into a same-directory
temp file and published with ``os.replace`` — a crashed worker leaves at
worst an orphan temp (swept by :meth:`ShardWriter.sweep_temps`), never a
half-written part, so a part that *exists under its final name* is whole.
That is the invariant the :mod:`~tensorflowonspark_tpu_torch.batch.ledger`
leans on: ``done`` is appended only after the rename returned.

Records are TFRecord-framed bytes (``tensorflowonspark_tpu_torch.tfrecord``), so
parts are also valid ``tf.data.TFRecordDataset`` inputs.  Non-bytes
prediction records are pickled (protocol 4, deterministic for the usual
scalar/ndarray outputs); jobs that need a custom on-disk format should
encode to bytes inside their ``predict_fn``.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Iterable, Iterator

from tensorflowonspark_tpu_torch import tfrecord

PARTS_DIR = "parts"
_TMP_PREFIX = ".tmp-part-"


def encode_record(rec) -> bytes:
    """Bytes pass through; anything else is pickled (protocol pinned so
    restarted and uninterrupted runs produce identical part bytes)."""
    if isinstance(rec, (bytes, bytearray, memoryview)):
        return bytes(rec)
    return pickle.dumps(rec, protocol=4)


def decode_record(data: bytes):
    """Inverse of :func:`encode_record` for pickled records.  Only for
    parts this job wrote itself — never unpickle untrusted files."""
    return pickle.loads(data)


class ShardWriter:
    """Writes one job's output parts (see module docstring)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.parts_dir = os.path.join(output_dir, PARTS_DIR)
        os.makedirs(self.parts_dir, exist_ok=True)

    def part_path(self, key: str) -> str:
        if "/" in key or key.startswith("."):
            raise ValueError(f"invalid shard key {key!r}")
        return os.path.join(self.parts_dir, f"{key}.tfrecord")

    def write(self, key: str, records: Iterable) -> tuple[str, int]:
        """Stream ``records`` into the part for ``key``; atomic commit.
        Returns ``(final_path, record_count)``.  Re-writing an existing
        part (the crashed-between-rename-and-ledger resume case) simply
        replaces it with identical content."""
        final = self.part_path(key)
        fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX, suffix=f"-{key}",
                                   dir=self.parts_dir)
        count = 0
        try:
            with os.fdopen(fd, "wb") as f:
                for rec in records:
                    f.write(tfrecord.frame_record(encode_record(rec)))
                    count += 1
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)  # the commit point
            tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return final, count

    def sweep_temps(self) -> int:
        """Remove orphan temp files left by killed workers (called by the
        dispatcher before assigning work).  Returns the count removed."""
        removed = 0
        for name in os.listdir(self.parts_dir):
            if name.startswith(_TMP_PREFIX):
                try:
                    os.unlink(os.path.join(self.parts_dir, name))
                    removed += 1
                except OSError:
                    pass
        return removed


def iter_part(path: str, decode: bool = False) -> Iterator:
    """Stream one part's records (raw bytes, or decoded with
    :func:`decode_record`)."""
    for raw in tfrecord.read_records(path):
        yield decode_record(raw) if decode else raw


def iter_results(output_dir: str, manifest, decode: bool = False) -> Iterator:
    """Stream the job's merged output: every shard's records in manifest
    order — the single-run oracle shape regardless of worker scheduling
    or restarts — at O(one record) driver memory.  All parts are checked
    for existence up front, so a missing part raises before any record
    is yielded."""
    writer = ShardWriter(output_dir)
    paths = []
    for shard in manifest:
        path = writer.part_path(shard.key)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"missing output part for shard {shard.key!r}: {path}")
        paths.append(path)

    def _gen():
        for path in paths:
            yield from iter_part(path, decode=decode)
    return _gen()


def read_results(output_dir: str, manifest, decode: bool = False) -> list:
    """:func:`iter_results` materialized as a list — convenient for
    small jobs and tests; multi-GB outputs should stream through
    :func:`iter_results` instead."""
    return list(iter_results(output_dir, manifest, decode=decode))
