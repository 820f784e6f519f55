"""A lightweight partitioned DataFrame: the pyspark.sql stand-in.

Port of ``tensorflowonspark_tpu/dataframe.py``, copied; it imports the
port's ``util``.

The reference's pipeline layer (``tensorflowonspark/pipeline.py``) and data
utilities (``dfutil.py``) operate on Spark DataFrames — partitioned
collections of ``Row`` objects with a named-column schema, where training
consumes ``df.rdd.map(list)`` (rows as positional lists) and inference runs
``df.rdd.mapPartitions(...)``.  There is no pyspark in this environment
(SURVEY.md §7), so this module provides the minimal DataFrame contract those
layers need, keeping the reference's *semantics* (partitions are the unit of
scheduling and of feed routing; rows are ordered within a partition) without
any JVM.

This is deliberately a thin data container, not a query engine: the heavy
data path is grain / file readers on the hosts (InputMode.TENSORFLOW
equivalent); ``DataFrame`` exists so the Estimator/Model pipeline and the
TFRecord utilities have the same shape as upstream.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from tensorflowonspark_tpu_torch import util


class Row:
    """A named tuple of column values (pyspark ``Row`` analogue).

    Fields are ordered; access by attribute, by name, or by position.
    """

    __slots__ = ("_fields", "_values")

    def __init__(self, _fields: Sequence[str] | None = None,
                 _values: Sequence[Any] | None = None, **named):
        if named:
            if _fields is not None or _values is not None:
                raise TypeError("pass either kwargs or (_fields, _values), not both")
            # dict ordering is insertion order ⇒ column order is kwarg order
            object.__setattr__(self, "_fields", tuple(named))
            object.__setattr__(self, "_values", tuple(named.values()))
        else:
            fields = tuple(_fields or ())
            values = tuple(_values or ())
            if len(fields) != len(values):
                raise ValueError(f"{len(fields)} fields but {len(values)} values")
            object.__setattr__(self, "_fields", fields)
            object.__setattr__(self, "_values", values)

    # pyspark-Row-compatible access patterns
    def __getattr__(self, name: str):
        if name.startswith("_"):  # avoid recursion during unpickling of slots
            raise AttributeError(name)
        try:
            return self._values[self._fields.index(name)]
        except ValueError:
            raise AttributeError(f"Row has no field '{name}' (has {self._fields})")

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._values[self._fields.index(key)]
        return self._values[key]

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __eq__(self, other) -> bool:
        if isinstance(other, Row):
            return self._fields == other._fields and self._equal_values(other._values)
        return NotImplemented

    def _equal_values(self, other_values) -> bool:
        if len(self._values) != len(other_values):
            return False
        for a, b in zip(self._values, other_values):
            eq = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                  or isinstance(b, np.ndarray) else a == b)
            if not eq:
                return False
        return True

    def __repr__(self) -> str:
        inner = ", ".join(f"{f}={v!r}" for f, v in zip(self._fields, self._values))
        return f"Row({inner})"

    def asDict(self) -> dict:
        return dict(zip(self._fields, self._values))

    @property
    def fields(self) -> tuple:
        return self._fields


class DataFrame:
    """Partitioned rows + schema.  The subset of the pyspark DataFrame API
    that the pipeline/dfutil layers consume.

    Construct from rows (``DataFrame(rows, num_partitions=4)``), from
    pre-made partitions (``DataFrame.from_partitions([[...], [...]])``), or
    from columns (``DataFrame.from_columns({"image": xs, "label": ys})``).
    """

    def __init__(self, rows: Iterable, columns: Sequence[str] | None = None,
                 num_partitions: int = 1):
        rows = [self._coerce_row(r, columns) for r in rows]
        if columns is None:
            columns = rows[0].fields if rows else ()
        self._columns = tuple(columns)
        for r in rows:
            if r.fields != self._columns:
                raise ValueError(f"row fields {r.fields} != schema {self._columns}")
        self._partitions = util.split_evenly(rows, num_partitions) or [[]]

    @staticmethod
    def _coerce_row(r, columns) -> Row:
        if isinstance(r, Row):
            return r
        if isinstance(r, dict):
            return Row(**r)
        if isinstance(r, (list, tuple)) and columns is not None:
            return Row(_fields=columns, _values=r)
        raise TypeError(
            f"cannot build Row from {type(r).__name__}; pass Row/dict, or "
            "list/tuple together with columns=[...]")

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_partitions(cls, partitions: Iterable[Iterable],
                        columns: Sequence[str] | None = None) -> "DataFrame":
        df = cls.__new__(cls)
        parts = [[cls._coerce_row(r, columns) for r in p] for p in partitions]
        first = next((p[0] for p in parts if p), None)
        df._columns = tuple(columns) if columns is not None else (
            first.fields if first is not None else ())
        for p in parts:
            for r in p:
                if r.fields != df._columns:
                    raise ValueError(f"row fields {r.fields} != schema {df._columns}")
        df._partitions = parts or [[]]
        return df

    @classmethod
    def from_columns(cls, columns: dict[str, Sequence], num_partitions: int = 1
                     ) -> "DataFrame":
        names = list(columns)
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"column lengths differ: "
                             f"{ {n: len(v) for n, v in columns.items()} }")
        rows = [Row(_fields=names, _values=[columns[n][i] for n in names])
                for i in range(lengths.pop() if lengths else 0)]
        return cls(rows, columns=names, num_partitions=num_partitions)

    # -- introspection -------------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._columns)

    @property
    def partitions(self) -> list[list[Row]]:
        return self._partitions

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def collect(self) -> list[Row]:
        return [r for p in self._partitions for r in p]

    def __iter__(self) -> Iterator[Row]:
        return iter(self.collect())

    def __len__(self) -> int:
        return self.count()

    def __repr__(self) -> str:
        return (f"DataFrame(columns={list(self._columns)}, rows={self.count()}, "
                f"partitions={self.num_partitions})")

    # -- transforms ----------------------------------------------------------
    def select(self, *cols: str) -> "DataFrame":
        idx = [self._columns.index(c) for c in cols]
        return DataFrame.from_partitions(
            ([Row(_fields=cols, _values=[r[i] for i in idx]) for r in p]
             for p in self._partitions), columns=cols)

    def map_rows(self, fn: Callable[[Row], Row]) -> "DataFrame":
        return DataFrame.from_partitions([[fn(r) for r in p] for p in self._partitions])

    def map_partitions(self, fn: Callable[[list[Row]], Iterable]) -> list:
        """Run ``fn`` over each partition, concatenating results — the
        ``df.rdd.mapPartitions`` shape that ``TFModel._transform`` uses."""
        out: list = []
        for p in self._partitions:
            out.extend(fn(p))
        return out

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self.collect(), columns=self._columns, num_partitions=n)

    def to_lists(self) -> list[list[list]]:
        """Rows as positional lists per partition — the reference's
        ``df.rdd.map(list)`` used to feed ``cluster.train`` (SURVEY §3.4)."""
        return [[list(r) for r in p] for p in self._partitions]

    def to_columns(self) -> dict[str, np.ndarray]:
        rows = self.collect()
        return {c: np.asarray([r[i] for r in rows])
                for i, c in enumerate(self._columns)}
