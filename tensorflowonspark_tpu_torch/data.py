"""Host-local input pipelines: the ``InputMode.TENSORFLOW`` data layer.

Port of ``tensorflowonspark_tpu/data.py``.  :class:`Dataset` is the
tf.data equivalent each worker builds over its own shard: lazily
evaluated, re-run from the source on every iteration.  Its sources are
``from_tfrecords`` and ``from_examples`` (TFRecord files through the
port's ``tfrecord`` and ``example_proto``, sharded by file),
``from_tensor_slices``, ``from_generator``, ``from_grain`` and
``from_grain_sharded`` (grain is imported by the caller, never here);
its transforms ``shard``, ``map``, ``flat_map``, ``interleave``,
``filter``, ``shuffle``, ``repeat``, ``take``, ``skip``, ``batch``,
``padded_batch``, ``prefetch``, ``cache`` and
:meth:`Dataset.cache_on_device`.  These are the JAX module's pure-Python
transforms, copied; only the device side changes:

- :meth:`Dataset.cache_on_device` keeps every element as tensors on the
  device after the first full pass and replays them with no host traffic;
- :func:`device_prefetch` copies each batch from pinned host memory on a
  side CUDA stream, ``depth`` batches ahead of the consumer; the
  consumer's stream waits on an event per batch, and every tensor is
  ``record_stream``-ed on it so the caching allocator cannot reuse its
  memory while the consumer's kernels still read it.

Elements are numpy arrays, torch CPU tensors or scalars, nested in
tuples, lists and dicts.

Typical worker usage::

    def map_fun(args, ctx):
        ds = (Dataset.from_examples(args["data_dir"] + "/part-*",
                                    shard=(ctx.num_workers, ctx.executor_id))
                .map(parse_example_fn)
                .shuffle(10_000, seed=ctx.executor_id)
                .batch(args["batch_size"], drop_remainder=True)
                .prefetch(4))
        for batch in device_prefetch(iter(ds)):
            state, metrics = step(state, batch)
"""

from __future__ import annotations

import collections
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from tensorflowonspark_tpu_torch.util import resolve_device

__all__ = ["Dataset", "CheckpointableIterator", "device_prefetch"]


class Dataset:
    """Composable host-local input pipeline (the tf.data equivalent)."""

    def __init__(self, make_iter: Callable[[], Iterator]):
        self._make = make_iter

    # ---------------------------------------------------------------- sources
    @staticmethod
    def from_tfrecords(paths: str | Sequence[str], verify: bool = True,
                       shard: tuple[int, int] | None = None) -> "Dataset":
        """Raw records from TFRecord files (glob pattern or explicit list).

        ``shard=(n, i)`` shards at *file* granularity when there are at
        least ``n`` files (each worker opens only its own files — the cheap
        kind of sharding); with fewer files it falls back to an element
        stride over the full stream, which reads everything but keeps the
        partition exact, like ``tf.data.Dataset.shard``.

        Paths may be local or any fsspec scheme.
        """
        from tensorflowonspark_tpu_torch import filesystem as fsutil
        from tensorflowonspark_tpu_torch.tfrecord import read_records

        files = fsutil.expand_glob(paths) if isinstance(paths, str) \
            else list(paths)
        if isinstance(paths, str) and not files:
            raise FileNotFoundError(f"no TFRecord files match {paths!r}")

        stride_shard = None
        if shard is not None:
            n, i = shard
            assert 0 <= i < n, f"bad shard ({n}, {i})"
            if len(files) >= n:
                files = files[i::n]
            else:
                stride_shard = (n, i)

        def make():
            it = (rec for f in files for rec in read_records(f, verify=verify))
            if stride_shard is not None:
                n, i = stride_shard
                it = (rec for j, rec in enumerate(it) if j % n == i)
            return it

        return Dataset(make)

    @staticmethod
    def from_examples(paths: str | Sequence[str],
                      binary_features: Sequence[str] = (),
                      shard: tuple[int, int] | None = None) -> "Dataset":
        """Parsed ``tf.train.Example`` dicts (feature name → numpy value)
        from TFRecord files — ``from_tfrecords`` + the wire-format decoder
        (``example_proto.decode_example``), squeezing single-element
        features to scalars the way ``dfutil.fromTFExample`` does."""
        from tensorflowonspark_tpu_torch.example_proto import decode_example

        base = Dataset.from_tfrecords(paths, shard=shard)
        binary = set(binary_features)

        def parse(rec: bytes):
            out: dict[str, Any] = {}
            for name, (kind, values) in decode_example(rec).items():
                if kind == "bytes" and name not in binary:
                    values = [v.decode("utf-8", "replace") for v in values]
                arr = (values[0] if len(values) == 1 else
                       np.asarray(values))
                out[name] = arr
            return out

        return base.map(parse)

    @staticmethod
    def from_tensor_slices(data) -> "Dataset":
        """Elements along axis 0 of an array, tuple of arrays, or dict of
        arrays (matching ``tf.data.Dataset.from_tensor_slices``)."""
        if isinstance(data, dict):
            keys = list(data)
            arrays = [np.asarray(data[k]) for k in keys]
            n = len(arrays[0])
            assert all(len(a) == n for a in arrays), "ragged dict arrays"
            return Dataset(lambda: ({k: a[j] for k, a in zip(keys, arrays)}
                                    for j in range(n)))
        if isinstance(data, tuple):  # tuple = structure, list = tensor (tf.data)
            arrays = [np.asarray(a) for a in data]
            n = len(arrays[0])
            assert all(len(a) == n for a in arrays), "ragged tuple arrays"
            return Dataset(lambda: (tuple(a[j] for a in arrays)
                                    for j in range(n)))
        arr = np.asarray(data)
        return Dataset(lambda: iter(arr))

    @staticmethod
    def from_generator(fn: Callable[[], Iterable]) -> "Dataset":
        """A re-invocable generator factory (called once per iteration)."""
        return Dataset(lambda: iter(fn()))

    @staticmethod
    def from_grain(source) -> "Dataset":
        """Wrap a grain object — ``DataLoader``, ``IterDataset``, or
        ``MapDataset`` — as a framework Dataset.  All three re-iterate from
        the start on each ``iter()``, matching this class's re-invocable
        contract, so the wrapped dataset composes with every transform
        here.  The caller imports grain; this module never does."""
        return Dataset(lambda: iter(source))

    @staticmethod
    def from_grain_sharded(map_dataset, num_shards: int, index: int, *,
                           shuffle: bool = False,
                           seed: int | None = None) -> "Dataset":
        """Per-host shard of a grain ``MapDataset`` — the
        InputMode.TENSORFLOW pattern (each worker reads its own slice;
        reference: ``tf.data.Dataset.shard(num_workers, worker_num)`` on
        executors) built from grain's native ops: optional global
        ``shuffle(seed)`` BEFORE the ``[index::num_shards]`` slice (so
        every epoch's permutation is consistent across hosts), then an
        ``IterDataset``.  Inside ``map_fun``, pass
        ``ctx.num_workers``/``ctx.task_index``.
        """
        if not 0 <= index < num_shards:
            # fail at wiring time even under python -O: a silent empty or
            # duplicated shard trains one host on the wrong data
            raise ValueError(f"shard index {index} out of range for "
                             f"num_shards={num_shards}")
        ds = map_dataset
        if shuffle:
            ds = ds.shuffle(seed=0 if seed is None else seed)
        return Dataset.from_grain(ds[index::num_shards].to_iter_dataset())

    # ------------------------------------------------------------- transforms
    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Element-stride partition ``index`` of ``num_shards`` (exact and
        order-stable; reference: ``tf.data.Dataset.shard(num, worker_num)``
        in the TENSORFLOW-mode examples)."""
        if not 0 <= index < num_shards:
            # fail at wiring time even under python -O: a silent empty or
            # duplicated shard trains one host on the wrong data
            raise ValueError(f"shard index {index} out of range for "
                             f"num_shards={num_shards}")
        src = self._make
        return Dataset(lambda: (x for j, x in enumerate(src())
                                if j % num_shards == index))

    def map(self, fn: Callable, num_parallel: int = 0) -> "Dataset":
        """Apply ``fn`` per element; ``num_parallel`` > 1 uses a thread pool
        that keeps that many elements in flight while preserving order."""
        src = self._make
        if num_parallel <= 1:
            return Dataset(lambda: (fn(x) for x in src()))

        def make():
            def gen():
                with ThreadPoolExecutor(max_workers=num_parallel) as pool:
                    pending: collections.deque = collections.deque()
                    it = src()
                    for x in it:
                        pending.append(pool.submit(fn, x))
                        if len(pending) >= num_parallel * 2:
                            yield pending.popleft().result()
                    while pending:
                        yield pending.popleft().result()
            return gen()

        return Dataset(make)

    def flat_map(self, fn: Callable[[Any], "Dataset | Iterable"]) -> "Dataset":
        """Map each element to a sub-dataset and concatenate them in order
        (``tf.data.Dataset.flat_map`` = sequential ``interleave``)."""
        return self.interleave(fn, cycle_length=1, block_length=1)

    def filter(self, pred: Callable[[Any], bool]) -> "Dataset":
        src = self._make
        return Dataset(lambda: (x for x in src() if pred(x)))

    def shuffle(self, buffer_size: int, seed: int | None = None) -> "Dataset":
        """Streaming buffer shuffle (tf.data semantics: uniform within a
        ``buffer_size`` window, not a global permutation)."""
        assert buffer_size > 0
        src = self._make

        def make():
            rng = random.Random(seed)

            def gen():
                buf: list = []
                for x in src():
                    buf.append(x)
                    if len(buf) >= buffer_size:
                        j = rng.randrange(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
                rng.shuffle(buf)
                yield from buf
            return gen()

        return Dataset(make)

    def repeat(self, count: int | None = None) -> "Dataset":
        """Repeat the source ``count`` times (``None`` = forever)."""
        src = self._make

        def make():
            def gen():
                n = 0
                while count is None or n < count:
                    yield from src()
                    n += 1
            return gen()

        return Dataset(make)

    def take(self, n: int) -> "Dataset":
        src = self._make

        def make():
            def gen():
                for j, x in enumerate(src()):
                    if j >= n:
                        return
                    yield x
            return gen()

        return Dataset(make)

    def skip(self, n: int) -> "Dataset":
        src = self._make
        return Dataset(lambda: (x for j, x in enumerate(src()) if j >= n))

    def interleave(self, fn: Callable[[Any], "Dataset | Iterable"],
                   cycle_length: int = 4, block_length: int = 1) -> "Dataset":
        """Map each element to a sub-dataset and interleave their elements
        round-robin (``tf.data.Dataset.interleave`` semantics): up to
        ``cycle_length`` sub-iterators open at once, ``block_length``
        consecutive elements pulled from each before rotating.  The
        sharded-file reading pattern — ``Dataset.from_tensor_slices(paths)
        .interleave(Dataset.from_tfrecords)`` — mixes records across files
        instead of reading them end to end."""
        assert cycle_length > 0 and block_length > 0
        src = self._make

        def make():
            def gen():
                inputs = src()
                active: collections.deque = collections.deque()

                def open_next():
                    for x in inputs:
                        sub = fn(x)
                        active.append(iter(sub))
                        return True
                    return False

                while len(active) < cycle_length and open_next():
                    pass
                while active:
                    it = active.popleft()
                    alive = True
                    for _ in range(block_length):
                        try:
                            yield next(it)
                        except StopIteration:
                            alive = False
                            break
                    if alive:
                        active.append(it)
                    else:
                        open_next()
            return gen()

        return Dataset(make)

    def cache(self) -> "Dataset":
        """Host-memory cache: materialize on the first full pass, replay
        thereafter (``tf.data.Dataset.cache()``; the device-side sibling is
        :meth:`cache_on_device`).  A partial first pass is discarded.

        Both the stored copies and the replayed elements are private: a
        consumer mutating a yielded array in place can never corrupt later
        epochs — tf.data's fresh-tensor-per-epoch semantics."""
        src = self._make
        cached: list = []
        complete = [False]

        def make():
            def gen():
                if complete[0]:
                    for x in cached:
                        yield _copy_tree(x)
                    return
                attempt: list = []
                for x in src():
                    attempt.append(_copy_tree(x))
                    yield x
                cached[:] = attempt
                complete[0] = True
            return gen()

        return Dataset(make)

    def padded_batch(self, batch_size: int, padding_value=0,
                     drop_remainder: bool = False) -> "Dataset":
        """Batch variable-length elements, padding each array dimension to
        the longest in the batch (``tf.data.Dataset.padded_batch`` with
        inferred shapes).  Works on arrays, dicts, and tuples — the NLP
        pattern (ragged token sequences → one rectangular batch) the
        reference delegates to tf.data.  Mixed dtypes within a batch
        promote via ``np.result_type`` (never silently truncate)."""

        def pad_leaf(items):
            arrs = [np.asarray(x) for x in items]
            rank = arrs[0].ndim
            if any(a.ndim != rank for a in arrs):
                raise ValueError("padded_batch: rank mismatch within batch")
            dtype = np.result_type(*arrs)
            if rank == 0:
                return np.stack(arrs).astype(dtype, copy=False)
            target = tuple(max(a.shape[d] for a in arrs) for d in range(rank))
            out = np.full((len(arrs),) + target, padding_value, dtype=dtype)
            for i, a in enumerate(arrs):
                out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
            return out

        return self._batched(batch_size, drop_remainder,
                             lambda items: _stack(items, leaf=pad_leaf))

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        """Stack ``batch_size`` consecutive elements: arrays → a leading
        batch axis; dicts/tuples → per-key/per-position stacking."""
        return self._batched(batch_size, drop_remainder, _stack)

    def _batched(self, batch_size: int, drop_remainder: bool,
                 stack_fn: Callable[[list], Any]) -> "Dataset":
        assert batch_size > 0
        src = self._make

        def make():
            def gen():
                buf: list = []
                for x in src():
                    buf.append(x)
                    if len(buf) == batch_size:
                        yield stack_fn(buf)
                        buf = []
                if buf and not drop_remainder:
                    yield stack_fn(buf)
            return gen()

        return Dataset(make)

    def prefetch(self, depth: int = 2) -> "Dataset":
        """Produce elements in a background thread, ``depth`` ahead."""
        assert depth > 0
        src = self._make

        def make():
            q: queue.Queue = queue.Queue(maxsize=depth)
            stop = threading.Event()
            END, ERR = object(), object()

            def producer():
                try:
                    for x in src():
                        while not stop.is_set():
                            try:
                                q.put(x, timeout=0.5)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                    # same stop-aware timed put as for data items: if the
                    # consumer abandoned us with the queue full, exit
                    # instead of blocking this thread forever
                    while not stop.is_set():
                        try:
                            q.put(END, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                except BaseException as e:  # surface at the consumer
                    while not stop.is_set():
                        try:
                            q.put((ERR, e), timeout=0.5)
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(target=producer, daemon=True,
                                 name="dataset-prefetch")
            t.start()

            def gen():
                try:
                    while True:
                        item = q.get()
                        if item is END:
                            return
                        if isinstance(item, tuple) and len(item) == 2 \
                                and item[0] is ERR:
                            raise item[1]
                        yield item
                finally:
                    stop.set()
            return gen()

        return Dataset(make)

    def cache_on_device(self, device=None) -> "Dataset":
        """Keep every element on ``device`` after the first full pass;
        later passes replay the same device tensors with no host↔device
        traffic.

        For datasets that fit in device memory (MNIST-class workloads,
        eval sets, benchmark loops): the first epoch pays one copy per
        element, every later epoch is pure compute.  ``device`` defaults
        to the card (raising without one); pass ``"cpu"`` to run on the
        CPU.  An interrupted first pass discards the partial cache — only
        a completed pass is replayed, so ``take``/early-stop consumers
        never see a truncated epoch masquerading as the full dataset.
        Consumers must not modify the replayed tensors in place.
        """
        device = resolve_device(device)
        src = self._make
        cached: list = []
        complete = [False]

        def make():
            def gen():
                if complete[0]:
                    yield from cached
                    return
                # Build into a local list and install only on completion: a
                # stale first-pass iterator resumed later (or two interleaved
                # first passes) must not corrupt an installed cache.
                attempt: list = []
                for x in src():
                    d = _tree_map(lambda t: _as_tensor(t).to(device), x)
                    attempt.append(d)
                    yield d
                cached[:] = attempt
                complete[0] = True
            return gen()

        return Dataset(make)

    # -------------------------------------------------------------- consumers
    def __iter__(self) -> Iterator:
        return self._make()

    def as_numpy(self) -> list:
        return list(self._make())

    def checkpointable(self, state: dict | None = None) -> "CheckpointableIterator":
        """Iterator whose position can be saved with a checkpoint and
        restored after a restart (the ``tf.data`` iterator-checkpointing
        analogue).  ``state`` is the dict a previous iterator's
        :meth:`~CheckpointableIterator.state` returned.  Restore replays
        the pipeline and skips the consumed prefix, so it is exact for
        *deterministic* pipelines (fixed ``shuffle`` seed, pure ``map``
        fns).  Call it on the **outermost** dataset (post-``batch``) so the
        state counts batches, not samples."""
        return CheckpointableIterator(self, state)


class CheckpointableIterator:
    """See :meth:`Dataset.checkpointable` (accepts any iterable source)."""

    _DONE = object()

    def __init__(self, source, state: dict | None = None):
        target = int(state.get("elements_consumed", 0)) if state else 0
        self._it = iter(source)
        # deterministic replay of the prefix; a source that shrank since
        # the state was saved stops early (position = what was skippable)
        # rather than raising StopIteration out of a constructor
        consumed = 0
        for _ in range(target):
            if next(self._it, self._DONE) is self._DONE:
                break
            consumed += 1
        self._count = consumed

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self._count += 1
        return item

    @property
    def position(self) -> int:
        """Elements consumed so far (including a restored prefix)."""
        return self._count

    def state(self) -> dict:
        """Savable position: pickle/JSON-safe, stable across restarts."""
        return {"elements_consumed": self._count}


def _default_leaf_stack(items: list):
    return np.stack([np.asarray(x) for x in items])


def _stack(items: list, leaf: Callable[[list], Any] = _default_leaf_stack):
    """Structure-recursive stacking: dicts per key, tuples per position,
    ``leaf`` (plain stack or pad-and-stack) at array leaves."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items], leaf) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_stack([it[j] for it in items], leaf)
                     for j in range(len(first)))
    return leaf(items)


def _copy_tree(x):
    """Private copy of a pipeline element (dict/tuple structure over
    numpy/scalars) so cached elements can't be mutated by consumers."""
    if isinstance(x, dict):
        return {k: _copy_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_copy_tree(v) for v in x)
    if isinstance(x, list):
        return [_copy_tree(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _as_tensor(x):
    import torch

    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def device_prefetch(it: Iterator, depth: int = 2, device=None):
    """Yield the items of ``it`` as tensors on ``device`` with ``depth``
    host→device copies in flight, so the copy of batch k+1 overlaps the
    compute on batch k.

    On the card (the default; raises without one) each item is staged in
    pinned host memory and copied on a side stream; before an item is
    yielded, the caller's current stream waits on the copy's event and
    each tensor is ``record_stream``-ed on it, so the allocator keeps its
    memory until the caller's kernels that read it have run.  On
    ``device="cpu"`` each item is converted with a plain ``.to``.

    Composes with the shm data plane: an iterator over
    ``DataFeed.next_chunk`` items hands the pinning copy numpy views
    backed by the producer's shared-memory segments."""
    import torch

    assert depth > 0
    device = resolve_device(device)
    if device.type != "cuda":
        for item in it:
            yield _tree_map(lambda t: _as_tensor(t).to(device), item)
        return
    stream = torch.cuda.Stream(device=device)
    buf: collections.deque = collections.deque()

    def hand_over(dev, done):
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _leaves(dev):
            t.record_stream(current)
        return dev

    for item in it:
        host = _tree_map(lambda t: _as_tensor(t).pin_memory(), item)
        with torch.cuda.stream(stream):
            dev = _tree_map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(stream)
        buf.append((dev, done))
        if len(buf) >= depth:
            yield hand_over(*buf.popleft())
    while buf:
        yield hand_over(*buf.popleft())
