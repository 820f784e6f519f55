"""The port's batch-inference plane (``tensorflowonspark_tpu_torch/batch/``).

- **parity with the JAX package** — the same records give byte-identical
  parts from both ``ShardWriter`` s and each package's ``read_results``
  reads the other's output directory; ``ShardManifest.save``/``load``
  descriptors are identical and load across packages; ``ProgressLedger``
  writes the same ``progress.jsonl`` bytes for the same events (clock
  pinned) and replays either file identically (``done_at_attempt``,
  ``reprocessed_committed``); ``expand_param_grid`` gives the same grids;
- **the plane on a CPU cluster** (the port's ``TPUCluster``, real worker
  processes): an array manifest scored by 2 workers equals in-process
  scoring; a SIGKILLed only worker is relaunched and reprocesses zero
  committed shards, its output byte-identical to an uninterrupted run's;
  with 2 workers a killed one's shards go to the survivor without a
  restart; ``GridSearch`` runs 2 trials on one cluster;
- **the BERT QA predict function** (``bert_inference.batch_predict`` over
  ``batch_model_builder``, weights from a ``model_dir`` checkpoint) at
  2 layers, hidden 64, against the JAX package's flax model with its
  Pallas flash kernel in interpret mode, on weights carried over with
  ``params_from_flax``: float32 start/end logits within ``atol=1e-4`` (the
  same arithmetic in another order; ``tests/test_torch_bert.py`` sees
  ~1e-6), and the mask and token types swapped move them far outside it.

The scorers are ``tests/cluster_funcs.py``'s (numpy only), so both
packages' jobs run the same functions.
"""

import functools
import importlib
import os

import numpy as np
import pytest

from tests import cluster_funcs as funcs

PACKAGES = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")
WORKER_ENV = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
RUN = {"reservation_timeout": 60, "shutdown_timeout": 60}


def _batch(pkg):
    return importlib.import_module(f"{pkg}.batch")


def _chunks(n=6, rows=2, cols=2):
    return [np.arange(i * rows * cols, (i + 1) * rows * cols,
                      dtype=np.float64).reshape(rows, cols) for i in range(n)]


def _expected(chunks, scale=2.0, offset=None):
    return [((row + offset) if offset is not None else row * scale).tobytes()
            for c in chunks for row in c]


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_manifest_shards_keys_and_trials(pkg):
    B = _batch(pkg)
    m = B.ShardManifest.from_arrays(_chunks(3))
    assert [s.shard_id for s in m] == ["shard-00000", "shard-00001", "shard-00002"]
    mt = m.with_trials(["t0", "t1"])
    assert len(mt) == 6 and mt.shards[0].key == "shard-00000@t0"
    assert mt.shards[3].key == "shard-00000@t1"           # trial-major order
    with pytest.raises(ValueError, match="duplicate"):
        B.ShardManifest([B.Shard("a", "array", data=[1]), B.Shard("a", "array", data=[2])])
    with pytest.raises(ValueError, match="unknown shard kind"):
        B.Shard("x", "parquet", path="p")
    with pytest.raises(ValueError, match="needs a path"):
        B.Shard("x", "tfrecord")


@pytest.mark.parametrize("writer,reader", [(w, r) for w in PACKAGES for r in PACKAGES])
def test_manifest_descriptors_identical_and_load_across_packages(writer, reader, tmp_path):
    """Both packages glob the same parts into the same descriptors; a
    ``manifest.json`` saved by either loads in either, byte for byte."""
    from tensorflowonspark_tpu_torch import tfrecord

    for i in range(3):
        tfrecord.write_records(str(tmp_path / f"part-{i:05d}.tfrecord"), [b"r%d" % i])
    pattern = str(tmp_path / "part-*.tfrecord")
    m = _batch(writer).ShardManifest.from_tfrecords(pattern)
    other = _batch(reader).ShardManifest.from_tfrecords(pattern)
    assert [s.descriptor() for s in m] == [s.descriptor() for s in other]
    m.save(str(tmp_path / writer))
    other.save(str(tmp_path / f"{reader}-again"))
    assert (tmp_path / writer / "manifest.json").read_bytes() == \
        (tmp_path / f"{reader}-again" / "manifest.json").read_bytes()
    back = _batch(reader).ShardManifest.load(str(tmp_path / writer))
    assert [s.descriptor() for s in back] == [s.descriptor() for s in m]
    with pytest.raises(FileNotFoundError):
        _batch(reader).ShardManifest.from_tfrecords(str(tmp_path / "nope-*.tfrecord"))
    arrays = _batch(writer).ShardManifest.from_arrays(_chunks(1))
    arrays.save(str(tmp_path / "arr"))
    with pytest.raises(ValueError, match="from_arrays"):
        _batch(reader).ShardManifest.load(str(tmp_path / "arr"))


def _ledger_script(B, d):
    with B.ProgressLedger(d) as led:
        led.attempt(total=3)
        led.assigned("s0", worker=0)
        led.done("s0", worker=0, count=4, path="parts/s0.tfrecord")
        led.assigned("s1", worker=1)
        led.requeued("s1", worker=1)
        led.assigned("s1", worker=0)
        led.attempt(total=3)
        led.done("s1", worker=0, count=4, path="parts/s1.tfrecord")
        led.assigned("s0", worker=1)          # a committed shard assigned again


def test_ledger_writes_the_same_bytes_and_replays_identically(tmp_path, monkeypatch):
    """The same events through both ledgers (the clock pinned) give the same
    ``progress.jsonl`` bytes, and each package replays each file the same:
    committed keys, attempts, ``done_at_attempt``, ``reprocessed_committed``
    — and a corrupt tail line (a driver killed mid-append) is skipped."""
    for pkg in PACKAGES:
        monkeypatch.setattr(importlib.import_module(f"{pkg}.batch.ledger").time, "time",
                            lambda: 1722000000.5)
        _ledger_script(_batch(pkg), str(tmp_path / pkg))
    files = [(tmp_path / pkg / "progress.jsonl").read_bytes() for pkg in PACKAGES]
    assert files[0] == files[1]
    for d in PACKAGES:
        with open(tmp_path / d / "progress.jsonl", "a") as f:
            f.write('{"event": "done", "key": "s9"')         # killed mid-append
        views = []
        for pkg in PACKAGES:
            r = _batch(pkg).ProgressLedger.replay(str(tmp_path / d))
            views.append((sorted(r.committed), r.attempts, sorted(r.done_at_attempt(2)),
                          sorted(r.done_at_attempt(1)), r.reprocessed_committed))
        assert views == [(["s0", "s1"], 2, ["s0"], [], ["s0"])] * 2


@pytest.mark.parametrize("writer", PACKAGES)
def test_parts_are_byte_identical_and_read_across_packages(writer, tmp_path):
    records = [b"a", b"bb", {"obj": 1}, np.arange(3, dtype=np.float32), 7.5]
    dirs = {}
    for pkg in PACKAGES:
        dirs[pkg] = str(tmp_path / pkg)
        path, n = _batch(pkg).ShardWriter(dirs[pkg]).write("shard-00000", records)
        assert n == len(records)
    parts = [open(os.path.join(dirs[p], "parts", "shard-00000.tfrecord"), "rb").read()
             for p in PACKAGES]
    assert parts[0] == parts[1]
    manifest = _batch(writer).ShardManifest.from_arrays([records])
    for reader in PACKAGES:
        B = _batch(reader)
        got = B.read_results(dirs[writer], manifest)
        assert got[:2] == [b"a", b"bb"]
        decoded = [B.writer.decode_record(r) for r in got[2:]]
        assert decoded[0] == {"obj": 1} and decoded[2] == 7.5
        np.testing.assert_array_equal(decoded[1], records[3])


def test_writer_atomic_commit_sweep_and_keys(tmp_path):
    from tensorflowonspark_tpu_torch.batch import ShardWriter, iter_part
    from tensorflowonspark_tpu_torch.batch.writer import decode_record

    w = ShardWriter(str(tmp_path))
    path, n = w.write("s0", [b"a", b"bb", {"obj": 1}])
    got = list(iter_part(path))
    assert n == 3 and got[:2] == [b"a", b"bb"] and decode_record(got[2]) == {"obj": 1}

    def raising():
        yield b"one"
        raise RuntimeError("predict blew up mid-shard")

    with pytest.raises(RuntimeError):
        w.write("s1", raising())
    assert not os.path.exists(w.part_path("s1"))
    assert os.listdir(w.parts_dir) == ["s0.tfrecord"]
    orphan = os.path.join(w.parts_dir, ".tmp-part-killed123-s1")
    with open(orphan, "wb") as f:
        f.write(b"half a part")
    assert w.sweep_temps() == 1 and w.sweep_temps() == 0
    with pytest.raises(ValueError, match="invalid shard key"):
        w.part_path("../escape")


def test_read_results_missing_part_raises_and_grouping(tmp_path):
    from tensorflowonspark_tpu_torch.batch import ShardManifest, ShardWriter, read_results
    from tensorflowonspark_tpu_torch.batch.worker import _grouped

    m = ShardManifest.from_arrays(_chunks(2))
    ShardWriter(str(tmp_path)).write("shard-00000", [b"x"])
    with pytest.raises(FileNotFoundError, match="shard-00001"):
        read_results(str(tmp_path), m)
    assert list(_grouped([1, 2, 3, 4, 5], 2)) == [[1, 2], [3, 4], [5]]
    assert [g.shape[0] for g in _grouped(np.arange(10).reshape(5, 2), 2)] == [2, 2, 1]
    assert list(_grouped(iter([b"a", b"b", b"c"]), 2)) == [[b"a", b"b"], [b"c"]]


@pytest.mark.parametrize("grid", [
    [{"a": 1}, {"a": 2}],
    {"b": [10, 20], "a": ["x"]},
    {"temperature": [0.0, 0.7], "beam": [1, 4], "top_p": [0.9]},
    [{"continual_candidate": {"version": "v"}}]])
def test_expand_param_grid_gives_the_same_grid(grid):
    ref, port = (_batch(p).expand_param_grid(grid) for p in PACKAGES)
    assert port == ref and list(port) == [f"t{i}" for i in range(len(port))]
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="empty"):
            _batch(pkg).expand_param_grid([])


# -- the plane on a CPU cluster -------------------------------------------------

def _run(job, tmp_path, name="wd", **kw):
    kw.setdefault("max_restarts", 0)
    return job.run(worker_env={**WORKER_ENV, **kw.pop("env", {})},
                   working_dir=str(tmp_path / name), **RUN, **kw)


@pytest.mark.integration
def test_batch_job_two_workers_equal_in_process_scoring(tmp_path):
    from tensorflowonspark_tpu_torch import metrics
    from tensorflowonspark_tpu_torch.batch import BatchJob, ProgressLedger, ShardManifest

    chunks = _chunks(6)
    job = BatchJob(ShardManifest.from_arrays(chunks), str(tmp_path / "out"),
                   funcs.batch_predict_scale, batch_size=1)
    summary = _run(job, tmp_path, num_workers=2)
    assert summary["scored"] == 6 and summary["requeued"] == 0
    want = [r for c in chunks for r in funcs.batch_predict_scale(None, c, None)]
    assert job.results() == want == _expected(chunks)
    replay = ProgressLedger.replay(str(tmp_path / "out"))
    assert len(replay.committed) == 6 and replay.reprocessed_committed == []
    snap = metrics.get_registry().snapshot()
    done = sum(v for labels, v in snap["tfos_batch_shards_total"]["samples"]
               if labels.get("outcome") == "done")
    assert done >= 6 and snap["tfos_batch_shards_remaining_count"]["samples"][-1][1] == 0


@pytest.mark.integration
def test_batch_job_model_builder_and_a_lost_part(tmp_path):
    """A worker-built model reaches every predict call; a part deleted by
    hand is re-scored on resume (trust-but-verify), the other committed
    shards skipped."""
    from tensorflowonspark_tpu_torch.batch import BatchJob, ShardManifest, ShardWriter

    chunks = _chunks(4)
    out = str(tmp_path / "out")

    def job():
        return BatchJob(ShardManifest.from_arrays(chunks), out,
                        funcs.batch_predict_with_model,
                        model_builder=funcs.batch_model_builder_offset,
                        predict_args={"offset": 7.0}, batch_size=2)

    first = job()
    _run(first, tmp_path, num_workers=1)
    assert first.results() == _expected(chunks, offset=7.0)
    os.remove(ShardWriter(out).part_path("shard-00002"))
    again = job()
    summary = _run(again, tmp_path, "wd2", num_workers=1)
    assert summary["scored"] == 1 and summary["skipped_committed"] == 3
    assert again.results() == _expected(chunks, offset=7.0)


@pytest.mark.integration
def test_batch_job_sigkill_restart_resumes_zero_reprocess(tmp_path):
    """The resume contract on a TFRecord manifest: the only worker is
    SIGKILLed at its 5th predict batch; ``run_with_recovery``'s relaunch
    replays the ledger, skips every committed shard, and the output equals
    an uninterrupted run's bytes (in-process scoring of the same shards)."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.batch import BatchJob, ProgressLedger, ShardManifest

    for i in range(8):
        tfrecord.write_records(str(tmp_path / f"part-{i:05d}.tfrecord"),
                               [b"x" * (i + j + 1) for j in range(2)])
    manifest = ShardManifest.from_tfrecords(str(tmp_path / "part-*.tfrecord"))
    want = [r for s in manifest
            for r in funcs.batch_predict_len(None, list(tfrecord.read_records(s.path)), None)]
    job = BatchJob(manifest, str(tmp_path / "out"), funcs.batch_predict_len,
                   batch_size=1, prefetch=1)
    summary = _run(job, tmp_path, num_workers=1, max_restarts=2, reassign_dead=False,
                   backoff_base=0.2, env={"TFOS_CHAOS": "kill node=0 at_step=5"})
    replay = ProgressLedger.replay(str(tmp_path / "out"))
    assert replay.attempts == 2, "the SIGKILL must have forced a restart"
    committed_before = replay.done_at_attempt(2)
    assert len(committed_before) >= 1, "non-vacuous: work committed before the kill"
    assert replay.reprocessed_committed == []
    assert summary["skipped_committed"] == len(committed_before)
    assert job.results() == want


@pytest.mark.integration
def test_batch_job_reassigns_dead_worker_without_restart(tmp_path):
    from tensorflowonspark_tpu_torch.batch import BatchJob, ProgressLedger, ShardManifest

    chunks = _chunks(24)
    job = BatchJob(ShardManifest.from_arrays(chunks), str(tmp_path / "out"),
                   funcs.batch_predict_scale_paced, batch_size=1, prefetch=1)
    summary = _run(job, tmp_path, num_workers=2, max_restarts=2, reassign_dead=True,
                   backoff_base=0.2, env={"TFOS_CHAOS": "kill node=1 at_step=3"})
    replay = ProgressLedger.replay(str(tmp_path / "out"))
    assert replay.attempts == 1, "no restart: healed in flight"
    assert summary["handled_workers"] == [1] and summary["requeued"] >= 1
    assert replay.reprocessed_committed == []
    assert job.results() == _expected(chunks)


@pytest.mark.integration
def test_grid_search_multiplexes_trials_one_cluster(tmp_path):
    from tensorflowonspark_tpu_torch.batch import GridSearch, ShardManifest

    chunks = _chunks(3)
    gs = GridSearch(ShardManifest.from_arrays(chunks), str(tmp_path / "out"),
                    funcs.batch_predict_scale, param_grid={"scale": [1.0, 3.0]},
                    batch_size=2)
    summary = gs.run(num_workers=2, max_restarts=0, worker_env=WORKER_ENV,
                     working_dir=str(tmp_path / "wd"), **RUN)
    assert summary["scored"] == 6
    assert summary["trials"] == {"t0": {"scale": 1.0}, "t1": {"scale": 3.0}}
    assert gs.trial_results("t0") == _expected(chunks, scale=1.0)
    assert gs.trial_results("t1") == _expected(chunks, scale=3.0)
    assert gs.score(lambda rs: len(rs)) == {"t0": 6, "t1": 6}
    with pytest.raises(KeyError, match="t9"):
        gs.trial_manifest("t9")


# -- the BERT QA predict function -----------------------------------------------

TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64)
T, QA_TOL = 40, 1e-4


@functools.cache
def _qa_weights():
    """Flax ``BertForQuestionAnswering`` parameters at :data:`TINY` width
    and the JAX model over them, the flash kernel in interpret mode."""
    import flax
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models.bert import BertConfig, BertForQuestionAnswering
    from tensorflowonspark_tpu.ops import flash_attention

    cfg = BertConfig(**TINY, dropout_rate=0.0, dtype=jnp.float32,
                     attention_fn=functools.partial(flash_attention, block_q=16, block_k=16,
                                                    interpret=True))
    ids = np.zeros((1, T), np.int32)
    variables = jax.jit(BertForQuestionAnswering(cfg).init)(jax.random.key(0), ids, ids + 1,
                                                             ids)
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(variables["params"]))
    return cfg, params


@functools.cache
def _jax_qa(cfg):
    """The JAX model's forward, compiled whole as its callers run it."""
    import jax

    from tensorflowonspark_tpu.models.bert import BertForQuestionAnswering

    return jax.jit(lambda p, *cols: BertForQuestionAnswering(cfg).apply({"params": p}, *cols))


def test_bert_qa_batch_predict_matches_the_jax_model(tmp_path):
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.dfutil import examples_from_arrays
    from tensorflowonspark_tpu_torch.models.bert import params_from_flax

    cfg, params = _qa_weights()
    with CheckpointManager(str(tmp_path / "model")) as mngr:
        mngr.save(1, {"model": params_from_flax(params), "step": 1})
    rows = bi.make_rows(6, T, TINY["vocab_size"], 3, min_len=12)
    cols = [np.stack([r[c] for r in rows]) for c in range(3)]
    records = examples_from_arrays(**dict(zip(bi.INPUT_COLUMNS, cols)))
    args = {"config": {**TINY, "dtype": "float32"}, "model_dir": str(tmp_path / "model"),
            "batch_size": 4, "device": "cpu", "stats_dir": str(tmp_path)}
    threads = torch.get_num_threads()
    try:
        model = bi.batch_model_builder(args)           # a CPU worker's one thread
    finally:
        torch.set_num_threads(threads)
    out = bi.batch_predict(model, records[:4], None) + bi.batch_predict(model, records[4:], None)
    got = np.stack([np.frombuffer(b, np.float32) for b in out])
    j_start, j_end = _jax_qa(cfg)(params, *cols)
    want = np.concatenate([np.asarray(j_start), np.asarray(j_end)], axis=1)
    assert got.shape == (6, 2 * T)
    np.testing.assert_allclose(got, want, atol=QA_TOL, rtol=0)
    assert model["batches"] == 2 and model["launches"] == 0   # CPU: the plain version
    # phase 23's planted fault: the mask and the token types swapped
    ids, mask, types = bi.decode_rows(records[:4])
    with torch.inference_mode():
        bad = np.concatenate(bi.forward_batch(model["model"], [ids, types, mask], 4, "cpu"),
                             axis=1)
    assert np.abs(bad - want[:4]).max() > 100 * QA_TOL
