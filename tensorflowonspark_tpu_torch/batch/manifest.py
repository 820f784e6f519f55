"""Shard manifests: the unit of work for the batch-inference plane.

A :class:`ShardManifest` names every input shard of a bulk-predict job in a
fixed order.  That order is the job's output contract: the merged output is
the per-shard outputs concatenated in manifest order, regardless of which
worker scored which shard or how many times the job was restarted.

Two shard kinds:

- ``tfrecord`` — a TFRecord part file read worker-side via
  :func:`tensorflowonspark_tpu_torch.tfrecord.read_records` (local path or any
  fsspec scheme, e.g. ``gs://`` part files written by ``dfutil``);
- ``array`` — records shipped inline in the shard descriptor (a numpy
  array or a list of records).  These travel driver → worker through the
  node queue, so on a same-host topology they ride the zero-copy shm
  plane — the ``DataFeed.next_chunk`` consumer path.  Used by tests, the
  data-plane A/B bench, and any job whose inputs already live in driver
  memory.

The manifest is intentionally driver-side state: a restarted job
(``cluster.run_with_recovery``) re-creates it from the same inputs and the
:class:`~tensorflowonspark_tpu_torch.batch.ledger.ProgressLedger` decides which
shards are already committed.  ``save``/``load`` persist the *descriptors*
(JSON in the output dir) for auditing and for resuming tfrecord jobs from
the output dir alone; inline array payloads are not persisted.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Sequence

MANIFEST_NAME = "manifest.json"


@dataclasses.dataclass(frozen=True)
class Shard:
    """One unit of batch-inference work.

    ``shard_id`` must be unique within a manifest (and stable across
    restarts — the progress ledger keys on it).  ``trial`` tags the shard
    with a grid-search trial id (empty for plain jobs); the
    (shard_id, trial) pair is the ledger key, so the same input shard can
    be scored once per trial in one job.
    """

    shard_id: str
    kind: str                      # "tfrecord" | "array"
    path: str | None = None        # tfrecord source file
    data: object | None = None     # inline records (array source)
    num_records: int | None = None
    trial: str = ""

    def __post_init__(self):
        if self.kind not in ("tfrecord", "array"):
            raise ValueError(f"unknown shard kind {self.kind!r} "
                             "(expected 'tfrecord' or 'array')")
        if self.kind == "tfrecord" and not self.path:
            raise ValueError(f"tfrecord shard {self.shard_id!r} needs a path")
        if self.kind == "array" and self.data is None:
            raise ValueError(f"array shard {self.shard_id!r} needs data")

    @property
    def key(self) -> str:
        """Ledger/output key: ``shard_id`` or ``shard_id@trial``."""
        return f"{self.shard_id}@{self.trial}" if self.trial else self.shard_id

    def descriptor(self) -> dict:
        """JSON-able descriptor (inline data elided)."""
        return {"shard_id": self.shard_id, "kind": self.kind,
                "path": self.path, "num_records": self.num_records,
                "trial": self.trial}


class ShardManifest:
    """An ordered collection of :class:`Shard` s (see module docstring)."""

    def __init__(self, shards: Sequence[Shard]):
        self.shards = list(shards)
        seen: set[str] = set()
        for s in self.shards:
            if s.key in seen:
                raise ValueError(f"duplicate shard key {s.key!r} in manifest")
            seen.add(s.key)

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_tfrecords(cls, pattern_or_paths) -> "ShardManifest":
        """One shard per TFRecord part file.  Accepts a glob pattern
        (``/data/part-*.tfrecord``, any fsspec scheme) or an explicit
        path list; shard ids are the zero-padded manifest positions so
        output parts sort in input order."""
        from tensorflowonspark_tpu_torch import filesystem as fsutil

        if isinstance(pattern_or_paths, str):
            paths = fsutil.expand_glob(pattern_or_paths)
            if not paths:
                raise FileNotFoundError(
                    f"no TFRecord files match {pattern_or_paths!r}")
        else:
            paths = list(pattern_or_paths)
            if not paths:
                raise ValueError("empty path list")
        width = max(5, len(str(len(paths) - 1)))
        return cls([Shard(shard_id=f"shard-{i:0{width}d}", kind="tfrecord",
                          path=p) for i, p in enumerate(paths)])

    @classmethod
    def from_arrays(cls, chunks: Iterable[object]) -> "ShardManifest":
        """One shard per element of ``chunks`` — each element is that
        shard's inline record batch (a numpy array, a list of records,
        ...), shipped to workers through the queue/shm plane as-is."""
        chunks = list(chunks)
        if not chunks:
            raise ValueError("empty chunk list")
        width = max(5, len(str(len(chunks) - 1)))
        return cls([Shard(shard_id=f"shard-{i:0{width}d}", kind="array",
                          data=c, num_records=len(c))
                    for i, c in enumerate(chunks)])

    def with_trials(self, trial_ids: Sequence[str]) -> "ShardManifest":
        """The grid-search expansion: every shard tagged once per trial id
        (trial-major order, so one trial's output is contiguous)."""
        out = []
        for tid in trial_ids:
            for s in self.shards:
                out.append(dataclasses.replace(s, trial=str(tid)))
        return ShardManifest(out)

    # -- persistence -------------------------------------------------------
    def save(self, output_dir: str) -> str:
        """Write the descriptor list as ``manifest.json`` in the output dir
        (schema: ``{"shards": [Shard.descriptor(), ...]}``)."""
        import os

        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"shards": [s.descriptor() for s in self.shards]}, f,
                      indent=2)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, output_dir: str) -> "ShardManifest":
        """Rebuild a manifest from ``manifest.json`` — tfrecord jobs can
        resume from the output dir alone.  Array shards cannot be loaded
        (their records were never persisted) and raise."""
        import os

        with open(os.path.join(output_dir, MANIFEST_NAME)) as f:
            doc = json.load(f)
        shards = []
        for d in doc["shards"]:
            if d["kind"] == "array":
                raise ValueError(
                    f"array shard {d['shard_id']!r} cannot be loaded from a "
                    "saved manifest (inline data is not persisted) — "
                    "reconstruct the manifest with from_arrays")
            shards.append(Shard(shard_id=d["shard_id"], kind=d["kind"],
                                path=d.get("path"),
                                num_records=d.get("num_records"),
                                trial=d.get("trial", "")))
        return cls(shards)
