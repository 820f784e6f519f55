"""The port's input pipeline (``data.py``) on the CPU.

Each pipeline of the JAX package's ``tests/test_data.py`` that the port's
transforms cover runs through both ``Dataset`` classes; the elements must
be equal in structure, dtype and value (the transforms are the same pure
Python, so the seeded shuffle draws the same order).  The device side is
the port's own: ``cache_on_device`` replays the same tensors without
touching the source again, ``device_prefetch`` yields the source's
batches as tensors in order, and both default to the card (raising
without one).
"""

import json

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.data import Dataset as JaxDataset
from tensorflowonspark_tpu_torch.data import CheckpointableIterator, Dataset, device_prefetch

XS, YS = np.arange(10, dtype=np.float32), np.arange(10, dtype=np.int32)

PIPELINES = {
    "slices_list": lambda D: D.from_tensor_slices([1, 2, 3]),
    "slices_tuple": lambda D: D.from_tensor_slices((np.arange(4), np.arange(4) * 10)),
    # a list of lists is a tensor sliced on axis 0, not a structure
    "slices_list_of_lists": lambda D: D.from_tensor_slices([[1, 2], [3, 4]]),
    "slices_dict": lambda D: D.from_tensor_slices({"a": np.arange(4), "b": np.arange(4) * 10}),
    "shard": lambda D: D.from_tensor_slices(list(range(10))).shard(3, 1),
    "map_filter": lambda D: D.from_tensor_slices(list(range(10))).map(
        lambda x: int(x) * 2).filter(lambda x: x % 4 == 0),
    "take_repeat": lambda D: D.from_tensor_slices(list(range(10))).take(2).repeat(3),
    "skip": lambda D: D.from_tensor_slices(list(range(10))).skip(7),
    "parallel_map": lambda D: D.from_tensor_slices(list(range(64))).map(
        lambda x: int(x) ** 2, num_parallel=8),
    "shuffle": lambda D: D.from_tensor_slices(list(range(100))).shuffle(16, seed=7),
    "batch_tuple": lambda D: D.from_tensor_slices((XS, YS)).batch(4),
    "batch_drop_remainder": lambda D: D.from_tensor_slices((XS, YS)).batch(4, drop_remainder=True),
    "batch_dict": lambda D: D.from_tensor_slices({"a": XS}).batch(5),
    "prefetch": lambda D: D.from_tensor_slices(list(range(32))).map(lambda x: int(x) + 1)
    .prefetch(4),
    "cache": lambda D: D.from_generator(lambda: iter(range(4))).cache(),
    "worker_recipe": lambda D: D.from_tensor_slices(
        (np.arange(80, dtype=np.float32).reshape(40, 2), np.arange(40) % 3)).shard(2, 0)
    .map(lambda e: (e[0], np.int32(e[1]))).shuffle(8, seed=0).batch(4, drop_remainder=True)
    .prefetch(2),
}


def _assert_same(got, want):
    assert type(got) is type(want) or (np.isscalar(got) and np.isscalar(want)), (got, want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_matches_the_jax_package(name):
    build = PIPELINES[name]
    ds, want = build(Dataset), list(build(JaxDataset))
    _assert_same(list(ds), want)
    _assert_same(list(ds), want)          # re-iteration restarts from the source
    assert len(ds.as_numpy()) == len(want)


def test_prefetch_propagates_errors():
    def boom(x):
        if x == 5:
            raise ValueError("boom at 5")
        return x

    with pytest.raises(ValueError, match="boom at 5"):
        list(Dataset.from_tensor_slices(list(range(10))).map(boom).prefetch(2))


def test_host_cache_is_private_and_consumes_the_source_once():
    calls = [0]

    def gen():
        calls[0] += 1
        yield np.arange(3, dtype=np.float32)

    ds = Dataset.from_generator(gen).cache()
    for b in ds:
        b += 100                              # in-place mutation by the consumer
    replay = next(iter(ds))
    np.testing.assert_array_equal(replay, [0, 1, 2])
    replay += 7
    np.testing.assert_array_equal(next(iter(ds)), [0, 1, 2])
    assert calls[0] == 1


def test_cache_on_device_replays_the_same_tensors():
    calls = [0]

    def gen():
        calls[0] += 1
        yield from ((np.full((2,), i, np.float32), np.int64(i)) for i in range(3))

    ds = Dataset.from_generator(gen).cache_on_device("cpu")
    first, second = list(ds), list(ds)
    assert calls[0] == 1, "the source must be read once"
    assert all(torch.is_tensor(t) and t.device.type == "cpu" for b in first for t in b)
    assert all(a is b for x, y in zip(first, second) for a, b in zip(x, y))  # no new copies
    assert [float(x[0]) for x, _ in second] == [0.0, 1.0, 2.0]
    assert [int(y) for _, y in second] == [0, 1, 2]
    assert len(list(Dataset.from_generator(gen).cache_on_device("cpu").repeat(2))) == 6


def test_cache_on_device_installs_only_a_complete_pass():
    ds = Dataset.from_tensor_slices(np.arange(4, dtype=np.float32)).batch(1) \
        .cache_on_device("cpu")
    stale = iter(ds)
    next(stale)                          # a first pass abandoned after one element
    assert len(list(ds)) == 4            # a partial pass is not replayed as complete
    list(stale)                          # the stale iterator resumes and finishes
    assert [float(b[0]) for b in ds] == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_yields_every_batch_in_order(depth):
    ds = Dataset.from_tensor_slices({"x": np.arange(24, dtype=np.float32).reshape(12, 2),
                                     "y": np.arange(12)}).batch(4)
    out = list(device_prefetch(iter(ds), depth=depth, device="cpu"))
    assert len(out) == 3 and all(torch.is_tensor(b["x"]) for b in out)
    np.testing.assert_array_equal(torch.cat([b["x"] for b in out]).numpy(),
                                  np.arange(24, dtype=np.float32).reshape(12, 2))
    assert torch.cat([b["y"] for b in out]).tolist() == list(range(12))
    nchw = torch.zeros(2, 3, 4, 4).contiguous(memory_format=torch.channels_last)
    (got,) = device_prefetch(iter([(nchw,)]), device="cpu")
    assert got[0].is_contiguous(memory_format=torch.channels_last)


def test_device_side_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        Dataset.from_tensor_slices([1]).cache_on_device()
    with pytest.raises(RuntimeError, match="cuda"):
        next(device_prefetch(iter([np.zeros(1)])))


def test_checkpointable_iterator_resumes_exactly():
    ds = Dataset.from_tensor_slices(np.arange(20)).shuffle(8, seed=7).batch(2)
    it = ds.checkpointable()
    first = [next(it) for _ in range(4)]
    state = it.state()
    assert state == {"elements_consumed": 4} and it.position == 4
    assert json.loads(json.dumps(state)) == state
    rest = list(it)
    resumed = ds.checkpointable(state)
    np.testing.assert_array_equal(np.stack(list(resumed)), np.stack(rest))
    assert len(first) + len(rest) == 10
    # a source that shrank stops at what was skippable
    assert CheckpointableIterator([1, 2], {"elements_consumed": 5}).position == 2
