"""DataFrame ↔ TFRecord conversion utilities.

Port of ``tensorflowonspark_tpu/dfutil.py``, copied; it goes through the
port's own ``tfrecord``, ``example_proto``, ``filesystem`` and
``dataframe``.

Equivalent of the reference's ``tensorflowonspark/dfutil.py``:
``saveAsTFRecords(df, dir)`` (Rows → ``tf.train.Example`` →
``saveAsNewAPIHadoopFile`` with the JVM ``tensorflow-hadoop`` output format),
``loadTFRecords(sc, dir, binary_features)`` with schema inference from a
sample Example (``infer_schema`` / ``fromTFExample`` / ``toTFExample``).

Here the JVM connector is replaced by the package's own native TFRecord codec
(``tfrecord.py`` + ``native/tfrecord.cc``) and the hand-rolled Example proto
codec (``example_proto.py``); files are byte-compatible with TensorFlow's
readers/writers.  One ``part-r-NNNNN`` file is written per DataFrame
partition, mirroring the Hadoop output layout so directory trees are
interchangeable with the reference's.
"""

from __future__ import annotations

import logging
import re
from typing import Sequence

import numpy as np

from tensorflowonspark_tpu_torch import example_proto, tfrecord
from tensorflowonspark_tpu_torch import filesystem as fsutil
from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

logger = logging.getLogger(__name__)

_PART_RE = re.compile(r"^part-(r-)?\d+$")


# -- row/Example conversion -------------------------------------------------

def toTFExample(row: Row | dict, columns: Sequence[str] | None = None) -> bytes:
    """One Row → serialized ``tf.train.Example``.

    Reference: ``dfutil.py::toTFExample`` (type-sniffing dispatch from Spark
    SQL types to bytes/float/int64 lists).
    """
    mapping = row.asDict() if isinstance(row, Row) else dict(row)
    if columns is not None:
        mapping = {c: mapping[c] for c in columns}
    return example_proto.encode_example(mapping)


def fromTFExample(serialized: bytes, binary_features: Sequence[str] = (),
                  schema: dict[str, str] | None = None) -> Row:
    """Serialized Example → Row.

    Reference: ``dfutil.py::fromTFExample``.  ``binary_features`` names
    bytes-list features kept as raw ``bytes``; other bytes features are
    decoded as UTF-8 strings (the reference's string-vs-binary split).
    Without a ``schema``, length-1 lists unwrap to scalars; with one (as
    ``loadTFRecords`` passes), columns typed ``kind[]`` stay lists even for
    single-value rows so variable-length columns never come back ragged.
    """
    decoded = example_proto.decode_example(serialized)
    out = {}
    for name in sorted(decoded):
        kind, values = decoded[name]
        if kind == "bytes" and name not in binary_features:
            values = [v.decode("utf-8") for v in values]
        is_list = (schema[name].endswith("[]") if schema and name in schema
                   else len(values) != 1)
        if is_list:
            out[name] = list(values)
        else:
            # an empty feature in a scalar-typed column → null, not a crash
            out[name] = values[0] if values else None
    return Row(**out)


def infer_schema(example: bytes | Row, binary_features: Sequence[str] = ()
                 ) -> dict[str, str]:
    """Infer {column: type} from a sample Example (or Row).

    Reference: ``dfutil.py::infer_schema`` — used by ``loadTFRecords`` to
    build the DataFrame schema from the first record.  Types are the
    wire-level kinds: ``bytes`` / ``string`` / ``float`` / ``int64`` with
    ``[]`` suffix for multi-value features.
    """
    if isinstance(example, Row):
        example = toTFExample(example)
    decoded = example_proto.decode_example(example)
    schema = {}
    for name in sorted(decoded):
        kind, values = decoded[name]
        if kind == "bytes":
            kind = "bytes" if name in binary_features else "string"
        schema[name] = f"{kind}[]" if len(values) > 1 else kind
    return schema


# -- directory save/load ----------------------------------------------------

def saveAsTFRecords(df: DataFrame, output_dir: str,
                    columns: Sequence[str] | None = None) -> int:
    """Write a DataFrame as a directory of TFRecord part files.

    Reference: ``dfutil.py::saveAsTFRecords`` — one output file per
    partition (Hadoop ``part-r-NNNNN`` naming), plus ``_SUCCESS`` on
    completion like the Hadoop committer.  Returns the record count.
    """
    fsutil.makedirs(output_dir)
    total = 0
    for i, part in enumerate(df.partitions):
        path = fsutil.join(output_dir, f"part-r-{i:05d}")
        total += tfrecord.write_records(
            path, (toTFExample(r, columns) for r in part))
    with fsutil.open_output(fsutil.join(output_dir, "_SUCCESS"), "wb"):
        pass
    logger.info("wrote %d records to %s (%d part files)",
                total, output_dir, df.num_partitions)
    return total


def loadTFRecords(input_dir: str, binary_features: Sequence[str] = (),
                  verify: bool = True) -> DataFrame:
    """Load a TFRecord directory (or single file) back into a DataFrame.

    Reference: ``dfutil.py::loadTFRecords`` — ``newAPIHadoopFile`` + schema
    inference from a sample Example.  Each part file becomes one partition.
    """
    if fsutil.isfile(input_dir):
        files = [input_dir]
    else:
        files = sorted(
            fsutil.join(input_dir, f) for f in fsutil.listdir(input_dir)
            if _PART_RE.match(f) or f.endswith(".tfrecord") or f.endswith(".tfrecords"))
    if not files:
        raise FileNotFoundError(f"no TFRecord part files under {input_dir}")

    # Decode each record ONCE; derive both the schema union and the Rows from
    # the same decoded dicts (the per-byte varint decode dominates load cost).
    # A column is a list if ANY record has ≠1 values (>1, or an empty feature
    # — an empty feature carries no type, so it must not force scalar/string);
    # its kind comes from the first non-empty occurrence.
    decoded_parts: list[list[dict]] = []
    kinds: dict[str, str] = {}
    multi: set[str] = set()
    for path in files:
        part = [example_proto.decode_example(s)
                for s in tfrecord.read_records(path, verify=verify)]
        for rec in part:
            for name, (kind, values) in rec.items():
                if values and name not in kinds:
                    if kind == "bytes":
                        kind = "bytes" if name in binary_features else "string"
                    kinds[name] = kind
                if len(values) != 1:
                    multi.add(name)
        decoded_parts.append(part)
    schema = {name: kinds.get(name, "string") + ("[]" if name in multi else "")
              for name in set(kinds) | multi}

    def _to_row(rec: dict) -> Row:
        out = {}
        for name in sorted(rec):
            kind, values = rec[name]
            if kind == "bytes" and name not in binary_features:
                values = [v.decode("utf-8") for v in values]
            if schema[name].endswith("[]"):
                out[name] = list(values)
            else:
                out[name] = values[0] if values else None
        return Row(**out)

    df = DataFrame.from_partitions(
        [[_to_row(rec) for rec in part] for part in decoded_parts])
    logger.info("loaded %d records from %s (schema: %s)",
                df.count(), input_dir, schema)
    return df


# -- convenience: numpy batches ---------------------------------------------

def examples_from_arrays(**columns) -> list[bytes]:
    """Column arrays → list of serialized Examples (bulk ``toTFExample``)."""
    names = sorted(columns)
    n = {len(v) for v in columns.values()}
    if len(n) != 1:
        raise ValueError("column lengths differ")
    out = []
    for i in range(n.pop()):
        out.append(example_proto.encode_example(
            {name: np.asarray(columns[name][i]) for name in names}))
    return out
