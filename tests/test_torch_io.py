"""The port's TFRecord, ``tf.train.Example`` and DataFrame IO against the
JAX package's, on the CPU.

The port keeps its own copies of ``tfrecord.py`` (with its own build of
``native/tfrecord.cc``), ``example_proto.py``, ``dataframe.py``,
``dfutil.py`` and ``filesystem.py``.  Files are byte-identical in both
directions: each package reads what the other writes.  The codec's two
paths — the native library and the pure-Python CRC32C and decoder — are
each held: the Python path by switching the native one off, as a host
without ``g++`` would run.  Everything is exact: no tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tensorflowonspark_tpu import dfutil as jdfutil
from tensorflowonspark_tpu import example_proto as jexample
from tensorflowonspark_tpu import tfrecord as jtfrecord
from tensorflowonspark_tpu.dataframe import DataFrame as JaxDataFrame
from tensorflowonspark_tpu_torch import dfutil, example_proto, filesystem, tfrecord
from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAYLOADS = [b"", b"a", bytes(range(256)) * 5, np.random.default_rng(0).bytes(4099)]
FEATURES = {
    "scalars": {"label": 7, "weight": 0.25, "name": "seven"},
    "lists": {"ids": [1, -2, 2 ** 40], "vec": np.arange(5, dtype=np.float32) / 3,
              "tags": ["a", "bb", ""]},
    "bytes": {"image": np.random.default_rng(1).integers(0, 256, 300, np.uint8).tobytes(),
              "empty": []},
    "numpy": {"x": np.int64(-3), "y": np.float32(1.5), "z": np.array([True, False])},
}


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Each test runs through the native codec and through the pure-Python
    fallback (the native library switched off, as without ``g++``)."""
    if request.param == "python":
        monkeypatch.setattr(tfrecord, "_lib", None)
        monkeypatch.setattr(tfrecord, "_lib_failed", True)
    else:
        assert tfrecord._native() is not None, "g++ is needed to build the codec"
    return request.param


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_framing_and_crc_match_the_jax_package(codec, i):
    data = PAYLOADS[i]
    assert tfrecord.crc32c(data) == jtfrecord.crc32c(data)
    assert tfrecord.masked_crc(data) == jtfrecord.masked_crc(data)
    assert tfrecord.frame_record(data) == jtfrecord.frame_record(data)
    assert list(tfrecord.iter_records(b"".join(jtfrecord.frame_record(p) for p in PAYLOADS))) \
        == PAYLOADS


def test_files_cross_read_byte_for_byte(codec, tmp_path):
    ours, theirs = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    assert tfrecord.write_records(ours, PAYLOADS) == len(PAYLOADS)
    jtfrecord.write_records(theirs, PAYLOADS)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(jtfrecord.read_records(ours)) == PAYLOADS
    assert list(tfrecord.read_records(theirs)) == PAYLOADS


def test_corruption_names_the_offset(codec, tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    tfrecord.write_records(path, PAYLOADS[:3])
    with open(path, "r+b") as f:
        f.seek(len(tfrecord.frame_record(PAYLOADS[0])) + 14)    # inside record 1's data
        f.write(b"\xff")
    with pytest.raises(tfrecord.TFRecordCorruptError, match="crc mismatch") as err:
        list(tfrecord.read_records(path))
    assert err.value.offset == len(tfrecord.frame_record(PAYLOADS[0]))


@pytest.mark.parametrize("name", list(FEATURES))
def test_examples_encode_and_decode_as_the_jax_package(codec, name):
    feats = FEATURES[name]
    blob = example_proto.encode_example(feats)
    assert blob == jexample.encode_example(feats)
    want = jexample.decode_example_py(blob)
    assert example_proto.decode_example(blob) == want
    assert example_proto.decode_example_py(blob) == want


def _frame(rows):
    rng = np.random.default_rng(2)
    return [dict(image=rng.integers(0, 256, 16, np.uint8).tobytes(), label=int(i),
                 vec=rng.standard_normal(4).astype(np.float32), text=f"t{i}",
                 ragged=list(range(i % 3))) for i in range(rows)]


def _as_tuples(df):
    return [tuple((f, v) for f, v in zip(r.fields, r)) for r in df.collect()]


def test_saved_directories_are_identical_and_load_across(codec, tmp_path):
    rows = _frame(7)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert dfutil.saveAsTFRecords(DataFrame(rows, num_partitions=3), str(ours)) == 7
    jdfutil.saveAsTFRecords(JaxDataFrame(rows, num_partitions=3), str(theirs))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "_SUCCESS", "part-r-00000", "part-r-00001", "part-r-00002"]
    for name in os.listdir(ours):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    got = dfutil.loadTFRecords(str(theirs), binary_features=("image",))
    want = jdfutil.loadTFRecords(str(ours), binary_features=("image",))
    assert isinstance(got, DataFrame) and isinstance(got.collect()[0], Row)
    assert got.num_partitions == want.num_partitions == 3
    assert _as_tuples(got) == _as_tuples(want)
    assert got.collect()[0]["ragged"] == []          # an empty feature stays a list


def test_row_conversions_match_the_jax_package(codec):
    row = _frame(3)[2]
    blob = dfutil.toTFExample(Row(**row))
    assert blob == jdfutil.toTFExample(row)
    assert dfutil.infer_schema(blob, ("image",)) == jdfutil.infer_schema(blob, ("image",))
    got, want = dfutil.fromTFExample(blob, ("image",)), jdfutil.fromTFExample(blob, ("image",))
    assert got.asDict() == want.asDict()
    cols = {"a": np.arange(3), "b": np.ones((3, 2), np.float32)}
    assert dfutil.examples_from_arrays(**cols) == jdfutil.examples_from_arrays(**cols)


def test_filesystem_paths_and_schemes(tmp_path):
    assert filesystem.has_scheme("memory://x/y") and not filesystem.has_scheme("/tmp/x")
    assert filesystem.join("gs://b/dir/", "/part-0") == "gs://b/dir/part-0"
    path = str(tmp_path / "a" / "b.bin")
    with filesystem.open_output(path) as f:
        f.write(b"x")
    assert filesystem.isfile(path) and filesystem.listdir(str(tmp_path / "a")) == ["b.bin"]
    assert filesystem.expand_glob(str(tmp_path / "a" / "*.bin")) == [path]
    # scheme paths go through fsspec, imported only for them
    uri = "memory://tfos_torch_io/rec.tfrecord"
    tfrecord.write_records(uri, PAYLOADS)
    assert list(jtfrecord.read_records(uri)) == PAYLOADS
    filesystem.remove(uri)
    assert not filesystem.exists(uri)


def test_native_codec_builds_atomically_under_concurrent_builders(tmp_path):
    """Two processes building the codec into one empty directory at once
    both load a whole library, built once under its content-hash name
    (each compiles to a ``mkstemp`` name and renames it into place)."""
    code = ("import sys, ctypes; from tensorflowonspark_tpu_torch import tfrecord as t; "
            "t.BUILD_DIR = sys.argv[1]; p = t.build_native(); ctypes.CDLL(p); print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]
    assert tfrecord.build_native().startswith(os.path.join(REPO, "build", "torch_native"))
