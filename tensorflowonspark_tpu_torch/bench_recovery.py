"""Recovery benchmark: detection latency and restart-to-first-step.

Port of ``scripts/bench_recovery.py``.  Two chaos scenarios run end to end
through ``LocalProcessBackend`` + ``run_with_recovery``, and the two numbers
that matter for goodput are timed:

- **detection latency** — from the instant the fault fires (the chaos
  sentinel's timestamp, written by the dying worker) to the driver's
  classified health event (``health_events.jsonl``);
- **restart-to-first-step** — from the classified event to the relaunched
  attempt's first *completed* training step (checkpoint restored, cluster
  re-registered, backoff elapsed, the card's context up again).

Scenarios:

1. ``kill`` — SIGKILL the chief at step 3 of 6 (``TFOS_CHAOS="kill node=0
   at_step=3"``); classified ``crash``; the resume must start at 3.
2. ``hang`` — stall the worker's heartbeats at step 2 while the process
   sleeps (``stall node=0 at_step=2``); the watchdog aborts after
   ``hang_timeout`` (detection latency ≈ hang_timeout + a poll, by design).

Each step updates a tensor on the workers' device (the card unless
``--cpu``) and the chief checkpoints it with ``CheckpointManager``, so a
relaunch pays what a real one does: a fresh worker, its CUDA context, a
restore.  Run::

    python -m tensorflowonspark_tpu_torch.bench_recovery [--hang-timeout 3.0] [--cpu]

Prints one JSON line a scenario, then the summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

TOTAL_STEPS = 6
KILL_AT = 3


def _attempt_log(ctx, *fields) -> None:
    with open(os.path.join(ctx.working_dir, f"log.{ctx.executor_id}"), "a") as f:
        f.write(f"{time.time():.6f} " + " ".join(str(x) for x in fields) + "\n")


def _device_step(w, device):
    import torch

    w = w + 1.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return w


def fn_kill_workload(args, ctx) -> None:
    """Checkpoint-per-step training on the device; the TFOS_CHAOS plan
    supplies the kill."""
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device(args["device"])
    ckpt = CheckpointManager(args["model_dir"])
    start, w = 0, torch.zeros((), device=device)
    if ckpt.latest_step() is not None:
        state = ckpt.restore()
        start, w = int(state["step"]), torch.as_tensor(state["w"], device=device)
    _attempt_log(ctx, "attempt_start", start)
    for s in range(start, args["total_steps"]):
        w = _device_step(w, device)
        step = s + 1
        if ctx.is_chief:
            ckpt.save(step, {"step": step, "w": w}, force=True)
            ckpt.wait()
        ctx.report_step(step)
        _attempt_log(ctx, "step_done", step)
    if ctx.is_chief:
        ckpt.close()


def fn_hang_workload(args, ctx) -> None:
    """Report two steps then wedge ONCE (marker-file guarded): attempt 1
    sleeps with stalled heartbeats; the relaunch runs to completion."""
    import torch

    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device(args["device"])
    w = torch.zeros((), device=device)
    _attempt_log(ctx, "attempt_start", 0)
    marker = os.path.join(ctx.working_dir, "wedged-once")
    for step in (1, 2):
        w = _device_step(w, device)
        ctx.report_step(step)
        _attempt_log(ctx, "step_done", step)
    if not os.path.exists(marker):
        with open(marker, "w"):
            pass
        time.sleep(600)  # wedged; only the watchdog can end this attempt
    for step in (3, 4):
        w = _device_step(w, device)
        ctx.report_step(step)
        _attempt_log(ctx, "step_done", step)


def _events(working_dir):
    from tensorflowonspark_tpu_torch.observability import EventLog

    return EventLog.read(os.path.join(working_dir, "health_events.jsonl"))


def _first_event(events, kinds):
    for e in events:
        if e["kind"] in kinds:
            return e
    raise RuntimeError(f"no {kinds} event found in {len(events)} events")


def _first_step_after(working_dir, executor_id, t):
    """Wall time of the first step_done recorded after ``t`` (the relaunched
    attempt's first completed step)."""
    with open(os.path.join(working_dir, f"log.{executor_id}")) as f:
        for line in f:
            parts = line.split()
            if parts[1] == "step_done" and float(parts[0]) > t:
                return float(parts[0])
    raise RuntimeError("no post-restart step found")


def _worker_env(device: str, plan: str) -> dict:
    env = {"TFOS_CHAOS": plan}
    if device == "cpu":
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return env


def bench_kill(hang_timeout: float, device: str) -> dict:
    from tensorflowonspark_tpu_torch import chaos
    from tensorflowonspark_tpu_torch.cluster import run_with_recovery

    wd = tempfile.mkdtemp(prefix="tfos_torch_bench_kill_")
    try:
        t0 = time.time()
        run_with_recovery(
            fn_kill_workload,
            {"total_steps": TOTAL_STEPS, "model_dir": os.path.join(wd, "ckpt"),
             "device": device},
            num_workers=2, max_restarts=2, backoff_base=0.2,
            working_dir=wd, reservation_timeout=120, shutdown_timeout=300,
            hang_timeout=hang_timeout,
            worker_env=_worker_env(device, f"kill node=0 at_step={KILL_AT}"))
        wall = time.time() - t0
        fired = chaos.fired_at(wd, node=0)
        event = _first_event(_events(wd), ("crash",))
        first_step = _first_step_after(wd, 0, event["t"])
        return {"scenario": "kill", "classified": "crash", "fault_fired_at_step": KILL_AT,
                "total_steps": TOTAL_STEPS, "detection_secs": event["t"] - fired,
                "restart_to_first_step_secs": first_step - event["t"],
                "total_wall_secs": wall}
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def bench_hang(hang_timeout: float, device: str) -> dict:
    from tensorflowonspark_tpu_torch import chaos
    from tensorflowonspark_tpu_torch.cluster import run_with_recovery

    wd = tempfile.mkdtemp(prefix="tfos_torch_bench_hang_")
    try:
        t0 = time.time()
        run_with_recovery(
            fn_hang_workload, {"device": device},
            num_workers=1, max_restarts=2, backoff_base=0.2,
            working_dir=wd, reservation_timeout=120, shutdown_timeout=300,
            hang_timeout=hang_timeout, heartbeat_interval=0.25,
            worker_env=_worker_env(device, "stall node=0 at_step=2"))
        wall = time.time() - t0
        fired = chaos.fired_at(wd, node=0)
        event = _first_event(_events(wd), ("hang",))
        first_step = _first_step_after(wd, 0, event["t"])
        return {"scenario": "hang", "classified": "hang", "hang_timeout_secs": hang_timeout,
                "detection_secs": event["t"] - fired,
                "restart_to_first_step_secs": first_step - event["t"],
                "total_wall_secs": wall}
    finally:
        shutil.rmtree(wd, ignore_errors=True)


def bench(hang_timeout: float = 3.0, device: str = "cuda") -> dict:
    """Both scenarios; the summary with each row."""
    from tensorflowonspark_tpu_torch.util import resolve_device

    dev = resolve_device(device)             # raises without a card unless "cpu"
    rows = []
    for fn in (bench_kill, bench_hang):
        row = fn(hang_timeout, dev.type)
        print(json.dumps(row), flush=True)
        rows.append(row)
    kind = None
    if dev.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(0)
    return {"benchmark": "recovery",
            "config": {"backend": "LocalProcessBackend", "device": dev.type, "card": kind,
                       "hang_timeout_secs": hang_timeout, "monitor_poll_interval_secs": 0.5,
                       "backoff_base_secs": 0.2},
            "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hang-timeout", type=float, default=3.0)
    p.add_argument("--cpu", action="store_true", help="run the workload on the CPU")
    args = p.parse_args(argv)
    print(json.dumps(bench(args.hang_timeout, "cpu" if args.cpu else "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
