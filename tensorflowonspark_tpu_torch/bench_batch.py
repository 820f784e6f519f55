"""The batch-inference plane's two self-gating claims.

    python -m tensorflowonspark_tpu_torch.bench_batch [--smoke] [--workers 2]

The port's counterpart of ``scripts/bench_batch.py``:

1. **records/s A/B** — the same array-shard manifest scored through
   ``BatchJob.dispatch`` over a live 2-worker cluster for each transport
   tier the queue plane negotiates: the zero-copy shm transport, the
   chunked bulk transport a cross-host driver gets (``TFOS_TPU_NO_SHM=1``)
   and the per-message pickle socket (``TFOS_TPU_NO_BULK=1`` too).  The
   three clusters stay up and are dispatched to in turn, five rounds of
   192 MB each; every driver client's negotiated tier is recorded and
   must be its row's.  Inline shards ride driver → worker, so the
   transport is the hot path; shm's median must beat the socket's
   (advisory under ``--smoke``), and ``resolved`` says whether their
   ranges over the rounds stay apart.  Only the dispatch is timed (host
   clock), not the clusters' boots.
2. **SIGKILL resume** — a TFRecord-manifest job whose only worker is
   SIGKILLed mid-run (``TFOS_CHAOS kill``); ``run_with_recovery``
   relaunches it, and the ledger's replay must show zero committed shards
   scored again, at least one shard committed before the restart, and
   the merged output byte-identical to an uninterrupted run's.

The scorers are numpy over the host's records (the plane, not a model, is
what is measured).  Prints one JSON line (with the card's name and power
limit when a card is present) and exits non-zero if a gate misses.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

#: transport pins per A/B row, on both ends: the workers' env for their
#: queue servers, ``os.environ`` for the driver's queue clients
AB_MODES = {"shm": {}, "crosshost_bulk": {"TFOS_TPU_NO_SHM": "1"},
            "socket": {"TFOS_TPU_NO_SHM": "1", "TFOS_TPU_NO_BULK": "1"}}
#: the tier each A/B row's driver clients must negotiate
TIERS = {"shm": "shm", "crosshost_bulk": "bulk", "socket": "socket"}
WORKER_ENV = {"OMP_NUM_THREADS": "1"}


def log(*a) -> None:
    print("bench_batch:", *a, file=sys.stderr, flush=True)


def predict_rowsum(model, records, trial_params):
    """Array-shard scorer: one float64 sum a row, as hex bytes."""
    arr = np.asarray(records, dtype=np.float32)
    return [float(s).hex().encode() for s in arr.sum(axis=1)]


def predict_crc(model, records, trial_params):
    """TFRecord-shard scorer: each record's length and first and last byte."""
    return [b"%d:%d:%d" % (len(r), r[0], r[-1]) for r in records]


@contextlib.contextmanager
def _pinned_clients(pins: dict, tiers: list):
    """Pin the driver's queue clients to ``pins`` and append the tier each
    client of ``BatchJob.dispatch`` negotiates to ``tiers``."""
    from tensorflowonspark_tpu_torch.batch import job as job_mod

    real = job_mod.QueueClient

    def client(*a, **kw):
        c = real(*a, **kw)
        tiers.append("shm" if c.shm_active else "bulk" if c.bulk_active else "socket")
        return c

    os.environ.update(pins)
    job_mod.QueueClient = client
    try:
        yield
    finally:
        job_mod.QueueClient = real
        for k in pins:
            os.environ.pop(k, None)


def _clear(out_dir: str) -> None:
    """Empty a job's output directory (a live cluster's workers write into
    it, so its ``parts`` directory stays)."""
    os.remove(os.path.join(out_dir, "progress.jsonl"))
    parts = os.path.join(out_dir, "parts")
    for name in os.listdir(parts):
        os.remove(os.path.join(parts, name))


def bench_ab(shards: int, rows: int, cols: int, num_workers: int, reps: int) -> dict:
    """records/s over the three transport tiers: one live cluster a tier,
    ``reps`` rounds of one timed dispatch on each in turn, every output
    equal to the first's.  Only the dispatch is timed."""
    from tensorflowonspark_tpu_torch.batch import BatchJob, ShardManifest
    from tensorflowonspark_tpu_torch.batch.worker import batch_worker
    from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

    rng = np.random.default_rng(0)
    manifest = ShardManifest.from_arrays(
        [rng.standard_normal((rows, cols)).astype(np.float32) for _ in range(shards)])
    total, oracle, tmp = shards * rows, None, []
    runs = {mode: {"records_per_sec": [], "tiers": []} for mode in AB_MODES}

    def job(mode):
        return BatchJob(manifest, runs[mode]["out"], predict_rowsum, batch_size=rows,
                        prefetch=2)

    clusters = {}
    try:
        for mode, pins in AB_MODES.items():
            tmp.append(tempfile.mkdtemp(prefix=f"tfos_bench_batch_{mode}_"))
            runs[mode]["out"] = os.path.join(tmp[-1], "out")
            clusters[mode] = TPUCluster.run(
                batch_worker, job(mode).worker_args(), num_workers,
                input_mode=InputMode.SPARK, reservation_timeout=120,
                worker_env={**WORKER_ENV, **pins}, working_dir=os.path.join(tmp[-1], "wd"))
        for rep in range(reps):
            for mode, pins in AB_MODES.items():
                if rep:
                    _clear(runs[mode]["out"])
                j = job(mode)
                with _pinned_clients(pins, runs[mode]["tiers"]):
                    t0 = time.monotonic()
                    j.dispatch(clusters[mode])
                    wall = time.monotonic() - t0
                if (j.last_summary or {}).get("scored") != shards:
                    raise RuntimeError(f"{mode}: scored {j.last_summary}")
                results = j.results()
                if oracle is None:
                    oracle = results
                elif results != oracle:
                    raise RuntimeError(f"{mode} output differs from the first run's")
                runs[mode]["records_per_sec"].append(total / wall)
                log(f"[ab] round {rep} {mode}: {wall:.4f} s, {total / wall:.0f} records/s")
    finally:
        for cluster in clusters.values():
            cluster.shutdown(timeout=120)
        for d in tmp:
            shutil.rmtree(d, ignore_errors=True)
    out = {"records": total, "mb": total * cols * 4 / 1e6, "reps": reps}
    for mode, r in runs.items():
        rate = r["records_per_sec"]
        out[mode] = {"records_per_sec": rate, "median": float(np.median(rate)),
                     "min": min(rate), "max": max(rate), "tiers": sorted(set(r["tiers"])),
                     "clients": len(r["tiers"])}
    shm, sock = out["shm"], out["socket"]
    out["speedup"] = shm["median"] / sock["median"]
    out["bulk_speedup_vs_socket"] = out["crosshost_bulk"]["median"] / sock["median"]
    # the A/B is resolved when the two tiers' ranges over the rounds do not overlap
    out["resolved"] = shm["min"] > sock["max"] or shm["max"] < sock["min"]
    return out


def bench_resume(shards: int, recs_per_shard: int, kill_at_step: int) -> dict:
    """A mid-job SIGKILL and the relaunch's proof row."""
    from tensorflowonspark_tpu_torch import tfrecord
    from tensorflowonspark_tpu_torch.batch import BatchJob, ProgressLedger, ShardManifest

    src = tempfile.mkdtemp(prefix="tfos_bench_batch_src_")
    rng = np.random.default_rng(1)
    for i in range(shards):
        tfrecord.write_records(
            os.path.join(src, f"part-{i:05d}.tfrecord"),
            [rng.integers(1, 255, size=rng.integers(8, 64), dtype=np.uint8).tobytes()
             for _ in range(recs_per_shard)])
    manifest = ShardManifest.from_tfrecords(os.path.join(src, "part-*.tfrecord"))
    oracle_dir = tempfile.mkdtemp(prefix="tfos_bench_batch_oracle_")
    oracle_job = BatchJob(manifest, oracle_dir, predict_crc, batch_size=4)
    oracle_job.run(num_workers=1, max_restarts=0, worker_env=WORKER_ENV,
                   reservation_timeout=120, shutdown_timeout=120)
    oracle = oracle_job.results()
    out_dir = tempfile.mkdtemp(prefix="tfos_bench_batch_resume_")
    wd = tempfile.mkdtemp(prefix="tfos_bench_batch_wd_")
    job = BatchJob(manifest, out_dir, predict_crc, batch_size=4, prefetch=1)
    t0 = time.monotonic()
    job.run(num_workers=1, max_restarts=2, reassign_dead=False, backoff_base=0.2,
            working_dir=wd, worker_env={**WORKER_ENV,
                                        "TFOS_CHAOS": f"kill node=0 at_step={kill_at_step}"},
            reservation_timeout=120, shutdown_timeout=120)
    wall = time.monotonic() - t0
    replay = ProgressLedger.replay(out_dir)
    row = {"scenario": "sigkill_resume", "shards": shards,
           "records": shards * recs_per_shard, "kill_at_step": kill_at_step,
           "attempts": replay.attempts,
           "committed_before_restart": len(replay.done_at_attempt(2)),
           "reprocessed_committed": len(replay.reprocessed_committed),
           "output_identical_to_oracle": job.results() == oracle,
           "total_wall_secs": wall}
    for d in (src, oracle_dir, out_dir, wd):
        shutil.rmtree(d, ignore_errors=True)
    log(f"[resume] {row}")
    return row


def bench(smoke: bool = False, workers: int = 2) -> dict:
    """Both claims; ``gates`` holds each verdict and ``ok`` the hard ones
    (the transport's is advisory under ``smoke``)."""
    if smoke:
        ab = bench_ab(shards=4, rows=64, cols=64, num_workers=workers, reps=2)
        resume = bench_resume(shards=4, recs_per_shard=4, kill_at_step=2)
    else:
        ab = bench_ab(shards=96, rows=512, cols=1024, num_workers=workers, reps=5)
        resume = bench_resume(shards=12, recs_per_shard=16, kill_at_step=10)
    gates = {"tiers_as_pinned": all(ab[m]["tiers"] == [TIERS[m]] for m in AB_MODES),
             "zero_reprocess": resume["reprocessed_committed"] == 0,
             "resume_nonvacuous": (resume["attempts"] >= 2
                                   and resume["committed_before_restart"] >= 1),
             "oracle_identical": resume["output_identical_to_oracle"],
             "shm_beats_socket": ab["speedup"] > 1.0}
    hard = {k: v for k, v in gates.items() if not (smoke and k == "shm_beats_socket")}
    doc = {"bench": "batch", "workers": workers, "smoke": smoke, "ab": ab, "resume": resume,
           "gates": gates, "ok": all(hard.values())}
    try:
        from tensorflowonspark_tpu_torch.device_info import card_name_and_limit

        doc["card"] = card_name_and_limit()
    except Exception:          # no card here: the plane is host-only
        doc["card"] = None
    return doc


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true", help="a 4-shard manifest (the transport "
                   "gate advisory)")
    p.add_argument("--workers", type=int, default=2)
    a = p.parse_args()
    doc = bench(a.smoke, a.workers)
    print(json.dumps(doc), flush=True)
    if not doc["ok"]:
        log("gates missed:", [k for k, v in doc["gates"].items() if not v])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
