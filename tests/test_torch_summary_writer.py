"""The port's ``SummaryWriter`` against the JAX package's: the same bytes.

For the same scalars and step, ``_encode_summary`` and ``_encode_event``
give the reference's bytes exactly (the wall clock pinned, since it is the
one field that differs between two writers).  A file that the port wrote
reads back through the reference's record reader and TensorBoard's own
``Event`` parser, and a file that the reference wrote reads back through
the port's :func:`read_scalars`; values compare exactly (both sides store
float32).
"""

import glob
import os
import time

import numpy as np
import pytest

from tensorflowonspark_tpu import observability as jax_obs
from tensorflowonspark_tpu.tfrecord import read_records as jax_read_records
from tensorflowonspark_tpu_torch.observability import SummaryWriter, read_scalars

_CASES = [
    ({"train/loss": 0.5}, 1),
    ({"train/loss": 0.25, "train/acc": 0.9, "eval/mse": 1e-7}, 2),
    ({"x": -3.5, "a/b/c": 1e30, "nan?": float("inf")}, 0),
    ({"loss": np.float32(2.75), "lr": 3e-5}, 2 ** 40 + 7),
    ({}, 12),
]


@pytest.mark.parametrize("metrics,step", _CASES)
def test_encoding_is_the_reference_bytes(monkeypatch, metrics, step):
    monkeypatch.setattr(time, "time", lambda: 1792250000.123456)
    summary = SummaryWriter._encode_summary(metrics)
    assert summary == jax_obs.SummaryWriter._encode_summary(metrics)
    assert SummaryWriter._encode_event(step=step, summary=summary) == \
        jax_obs.SummaryWriter._encode_event(step=step, summary=summary)
    assert SummaryWriter._encode_event(file_version="brain.Event:2") == \
        jax_obs.SummaryWriter._encode_event(file_version="brain.Event:2")


def _write(writer_cls, logdir):
    with writer_cls(logdir, filename_suffix=".t") as w:
        w.scalar("train/loss", 0.5, step=1)
        w.scalars({"train/loss": 0.25, "train/acc": 0.9}, step=2)
        w.scalars({"eval/loss": 0.125}, step=2)
    files = glob.glob(os.path.join(logdir, "events.out.tfevents.*.t"))
    assert len(files) == 1
    return files[0]


WANT = [(1, "train/loss", 0.5), (2, "train/loss", 0.25),
        (2, "train/acc", float(np.float32(0.9))), (2, "eval/loss", 0.125)]


def test_port_file_reads_back_with_the_reference_reader(tmp_path):
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    path = _write(SummaryWriter, str(tmp_path / "tb"))
    events = []
    for rec in jax_read_records(path, verify=True):
        ev = event_pb2.Event()
        ev.ParseFromString(rec)
        events.append(ev)
    assert events[0].file_version == "brain.Event:2" and events[0].wall_time > 0
    got = [(ev.step, v.tag, v.simple_value) for ev in events[1:] for v in ev.summary.value]
    assert got == WANT
    assert [(s, t, v) for _, s, t, v in read_scalars(path)] == WANT


def test_reference_file_reads_back_with_the_port_reader(tmp_path):
    t0 = time.time()
    path = _write(jax_obs.SummaryWriter, str(tmp_path / "tb"))
    got = read_scalars(path)
    assert [(s, t, v) for _, s, t, v in got] == WANT
    assert all(t0 <= wall <= time.time() for wall, *_ in got)
