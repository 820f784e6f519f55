"""Feed-queue sentinel markers.

Equivalent of the reference's ``tensorflowonspark/marker.py`` (``Marker``,
``EndPartition`` and the terminal end-of-feed sentinel).  Instances of these
classes are pushed onto the data-plane queues between ordinary data chunks:

- ``EndPartition`` marks a partition boundary so ``DataFeed.next_batch`` can
  return partial batches aligned to partition edges (reference:
  ``TFNode.py::DataFeed.next_batch``).
- ``EndOfFeed`` is the terminal sentinel pushed by ``TPUCluster.shutdown`` /
  the feeder when no more data will ever arrive (reference:
  ``TFSparkNode.py::shutdown``).
"""


class Marker:
    """Base class for queue sentinels."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<{type(self).__name__}>"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class EndPartition(Marker):
    """Marks the end of one data partition within the feed queue."""

    __slots__ = ()


class EndOfFeed(Marker):
    """Terminal sentinel: no more data will arrive on this queue."""

    __slots__ = ()
