"""Driver-fed BERT SQuAD fine-tuning — the port's second slice.

The counterpart of the ``train_fn`` half of ``examples/bert/bert_squad.py``:
the driver boots a cluster with :func:`map_fun` and pushes SQuAD-shaped
rows through ``cluster.train`` (queue/shm data plane into each worker's
``DataFeed``); each worker trains ``BertForQuestionAnswering`` with the CUDA
flash-attention kernels (forward, dQ, dK/dV) as its ``attention_fn``,
through :class:`~tensorflowonspark_tpu_torch.parallel.DataParallelStrategy`
(DDP across workers) and AdamW, as the example does with
``MultiWorkerMirroredStrategy`` and ``optax.adamw``.

A row is ``(input_ids, attention_mask, token_type_ids, start_position,
end_position)``.  Every worker must be fed the same number of batches:
DDP's all-reduce waits for every replica, so a worker that runs dry first
leaves the others hanging (the JAX multi-process path has the same
property).  ``steps`` caps each worker's step count.

At the end every worker checkpoints (model, AdamW state, step) through a
:class:`~tensorflowonspark_tpu_torch.checkpoint.CheckpointManager` under
``model_dir``, and the chief writes the serving export of the QA head,
``serve(params, input_ids, attention_mask, token_type_ids) -> (start,
end)`` logits (:func:`export`), with the flash kernels inside the exported
program — the counterpart of ``examples/bert/bert_squad.py``'s export,
which takes ``input_ids`` alone.

    from tensorflowonspark_tpu_torch.bert_inference import BERT_BASE

    rows = make_train_rows(128, 384, vocab_size=30522, seed=0)
    stats, weights = run_training(rows, BERT_BASE, seed=0, batch_size=16, steps=8,
                                  export_dir="/tmp/bert_export")
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from tensorflowonspark_tpu_torch.bert_inference import build_model, make_rows
from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

def make_train_rows(n: int, seq_len: int, vocab_size: int, seed: int,
                    min_len: int | None = None) -> list[tuple]:
    """``n`` SQuAD-shaped training rows made from ``seed``: the rows of
    :func:`~tensorflowonspark_tpu_torch.bert_inference.make_rows` plus an
    answer span ``start <= end`` inside the context (token type 1, before
    the last ``[SEP]``), at most 30 tokens long."""
    rng = np.random.default_rng([seed, 1])
    rows = []
    for ids, mask, types in make_rows(n, seq_len, vocab_size, seed, min_len):
        ctx = np.flatnonzero(types)[:-1]          # the context, without [SEP]
        start = int(rng.integers(ctx[0], ctx[-1] + 1))
        end = int(rng.integers(start, min(start + 30, ctx[-1]) + 1))
        rows.append((ids, mask, types, np.int64(start), np.int64(end)))
    return rows


def pad_batch(batch, batch_size: int) -> tuple:
    """A fed batch ``(ids, mask, types, starts, ends)`` of ``n <=
    batch_size`` rows as the step's arrays ``(ids, mask, types, starts,
    ends, w)``: padded to ``batch_size`` with all-zero rows of weight
    ``w = 0``, as ``examples/bert/bert_squad.py`` pads its last batch."""
    ids, mask, types, starts, ends = batch
    n = len(ids)
    pad = batch_size - n

    def padded(a, dtype):
        a = np.asarray(a, dtype)
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype)])

    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (padded(ids, np.int64), padded(mask, np.int32), padded(types, np.int64),
            padded(starts, np.int64), padded(ends, np.int64), w)


def squad_loss(model, batch, rng=None):
    """The example's loss: ``(CE(start) + CE(end)) * w`` summed, over
    ``max(sum(w), 1)``, over 2.  ``rng`` is the strategy's per-step
    generator, from which dropout draws its masks."""
    import torch.nn.functional as F

    ids, mask, types, starts, ends, w = batch
    start_logits, end_logits = model(ids, mask, types, train=True, rng=rng)
    ce = (F.cross_entropy(start_logits, starts, reduction="none")
          + F.cross_entropy(end_logits, ends, reduction="none"))
    return (ce * w).sum() / w.sum().clamp_min(1.0) / 2.0


def adamw(lr: float):
    """``optax.adamw(lr, weight_decay=0.01)`` as ``optimizer_fn``: both
    decay every parameter by its old value (decoupled) and put eps outside
    the bias-corrected square root."""
    import torch

    return lambda params: torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                            eps=1e-8, weight_decay=0.01)


def build_train_model(args: dict, device, attention="flash"):
    """:func:`~tensorflowonspark_tpu_torch.bert_inference.build_model` on
    a copy of ``args["state_dict"]``: training updates the parameters in
    place, and on the CPU the model would share the caller's tensors."""
    sd = args.get("state_dict")
    if sd is not None:
        args = {**args, "state_dict": {k: v.clone() for k, v in sd.items()}}
    return build_model(args, device, attention)


def serve_fn(model):
    """``serve(params, input_ids, attention_mask, token_type_ids) ->
    (start_logits, end_logits)`` over ``model`` (eval mode, so no dropout)
    with the weights ``params``; the inputs are int32 ``[N, T]`` as
    :func:`~tensorflowonspark_tpu_torch.bert_inference.make_rows` makes
    them."""
    import torch

    def serve(params, input_ids, attention_mask, token_type_ids):
        return torch.func.functional_call(
            model, params, (input_ids.long(), attention_mask, token_type_ids.long()))

    return serve


SERVE_INPUTS = ("input_ids", "attention_mask", "token_type_ids")
SERVE_OUTPUTS = ("start_logits", "end_logits")


def export(export_dir: str, model, seq_len: int, is_chief: bool = True):
    """Write ``model``'s QA serving export (:func:`serve_fn`) for
    sequences of ``seq_len``, any batch size; only the chief writes."""
    from tensorflowonspark_tpu_torch.checkpoint import export_model

    example = [np.zeros((2, seq_len), np.int32) for _ in SERVE_INPUTS]
    return export_model(export_dir, serve_fn(model), model.state_dict(), example,
                        input_names=SERVE_INPUTS, output_names=SERVE_OUTPUTS,
                        is_chief=is_chief)


def kernel_launches() -> dict[str, int]:
    """This process's launches of each flash-attention kernel so far."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_dq": flash_attention_bwd.launches_dq,
            "flash_attention_dkv": flash_attention_bwd.launches_dkv}


def map_fun(args: dict, ctx) -> None:
    """Worker half: join the cluster's process group, train on every fed
    batch until the feed ends or ``args["steps"]`` steps (then end the
    feed), checkpoint and export as the module docstring says, and write
    ``<working_dir>/bert_train_stats.<id>.json``:
    ``losses`` and ``step_ms`` (host clock after the loss is read, which
    synchronises the device) a step, ``rows``, ``launches`` of each kernel
    in the steps and the ``device``."""
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy
    from tensorflowonspark_tpu_torch.util import (resolve_device,
                                                  strict_matmul_precision)

    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        strategy = DataParallelStrategy(device, seed=args["seed"])
        state = strategy.init_state(build_train_model(args, device), adamw(args["lr"]))
        step = strategy.build_train_step(squad_loss)
        batch_size, steps = int(args["batch_size"]), int(args.get("steps") or 0)
        feed = ctx.get_data_feed(train_mode=True)
        stats = {"losses": [], "step_ms": [], "rows": 0}
        launches0 = kernel_launches()
        seq_len = None
        while not feed.should_stop() and (steps == 0 or len(stats["losses"]) < steps):
            batch = feed.next_batch_arrays(batch_size,
                                           timeout=float(args.get("feed_timeout", 600)))
            if batch is None:
                break
            t0 = time.perf_counter()
            state, metrics = step(state, strategy.shard_batch(pad_batch(batch, batch_size)))
            stats["losses"].append(float(metrics["loss"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["rows"] += len(batch[0])
            seq_len = batch[0].shape[1]
            ctx.report_step(len(stats["losses"]))
        if steps and len(stats["losses"]) >= steps:
            feed.terminate()
        stats["launches"] = {k: n - launches0[k] for k, n in kernel_launches().items()}
        stats["device"] = str(device)
        if args.get("model_dir"):
            with CheckpointManager(args["model_dir"]) as mngr:
                mngr.save(state.step, state.state_dict())
        if args.get("export_dir") and seq_len is not None:
            export(args["export_dir"], state.module, seq_len, is_chief=ctx.is_chief)
        with open(os.path.join(ctx.working_dir,
                               f"bert_train_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_training(rows: list, config: dict, *, seed: int = 0, batch_size: int = 16,
                 steps: int = 0, num_epochs: int = 1, lr: float = 3e-5,
                 dropout: float = 0.1, num_workers: int = 1, device: str = "cuda",
                 state_dict: dict | None = None, model_dir: str | None = None,
                 export_dir: str | None = None,
                 worker_env: dict | None = None, working_dir: str | None = None,
                 timeout: float = 600.0):
    """Driver half: boot ``num_workers`` workers running :func:`map_fun`,
    feed ``rows`` ``num_epochs`` times through ``cluster.train``, shut the
    cluster down (re-raising any worker error) and return ``(stats,
    weights)``: each worker's stats dict in executor order and the final
    weights (on the CPU) from the checkpoint in ``model_dir`` (default:
    ``<working_dir>/model``).  Weights start from ``state_dict``
    when given, else from ``seed``, which also seeds the dropout
    generators."""
    from tensorflowonspark_tpu_torch.checkpoint import restore_checkpoint

    working_dir = working_dir or tempfile.mkdtemp(prefix="bert_train_")
    model_dir = model_dir or os.path.join(working_dir, "model")
    args = {"config": dict(config), "seed": seed, "batch_size": batch_size,
            "steps": steps, "lr": lr, "dropout": dropout, "device": device,
            "state_dict": state_dict, "feed_timeout": timeout, "model_dir": model_dir,
            "export_dir": export_dir}
    cluster = TPUCluster.run(map_fun, args, num_workers, input_mode=InputMode.SPARK,
                             reservation_timeout=timeout, worker_env=worker_env,
                             working_dir=working_dir)
    try:
        cluster.train(rows, num_epochs=num_epochs, feed_timeout=timeout)
    finally:
        cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"bert_train_stats.{i}.json")) as f:
            stats.append(json.load(f))
    return stats, restore_checkpoint(model_dir)["model"]
