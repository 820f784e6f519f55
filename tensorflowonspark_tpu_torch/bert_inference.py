"""Driver-fed BERT question-answering inference — the port's first slice.

The counterpart of the ``TFModel.transform`` half of
``examples/bert/bert_squad.py``: the driver boots a cluster with
:func:`map_fun`, pushes tokenized SQuAD-shaped rows through
``cluster.inference`` (queue/shm data plane into each worker's
``DataFeed``), and each worker runs ``BertForQuestionAnswering`` with the
CUDA flash-attention kernel as its ``attention_fn`` and returns the start
and end logits of every row through ``feed.batch_results``.

A row is ``(input_ids, attention_mask, token_type_ids)``, three int32
arrays of the sequence length.  A result is ``(start_logits,
end_logits)``, two float32 arrays of the same length.

    rows = make_rows(64, 384, vocab_size=30522, seed=0)
    results, stats = run_inference(rows, BERT_BASE, seed=0, batch_size=16)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tensorflowonspark_tpu_torch.cluster import InputMode, TPUCluster

#: BERT-base widths (``__graft_entry__.py``'s flagship config), bf16
BERT_BASE = {"vocab_size": 30522, "hidden_size": 768, "num_layers": 12,
             "num_heads": 12, "intermediate_size": 3072,
             "max_position_embeddings": 512, "dtype": "bfloat16"}


def qa_config(config: dict, attention="flash", dropout_rate: float = 0.0):
    """A :class:`~tensorflowonspark_tpu_torch.models.bert.BertConfig` from a
    plain (picklable) dict; ``attention`` is ``"flash"`` (the CUDA kernels
    on the card), ``"reference"`` (their plain PyTorch versions, forward
    and backward) or an ``attention_fn`` itself."""
    import torch

    from tensorflowonspark_tpu_torch.models.bert import BertConfig
    from tensorflowonspark_tpu_torch.ops import flash_attention, flash_attention_plain

    attention_fn = attention if callable(attention) else {
        "flash": flash_attention, "reference": flash_attention_plain}[attention]
    kw = dict(config)
    kw["dtype"] = getattr(torch, kw.get("dtype", "bfloat16"))
    return BertConfig(dropout_rate=dropout_rate, attention_fn=attention_fn, **kw)


def make_rows(n: int, seq_len: int, vocab_size: int, seed: int,
              min_len: int | None = None) -> list[tuple]:
    """``n`` SQuAD-shaped rows made from ``seed``: ``[CLS] question [SEP]
    context [SEP]`` of a ragged real length in ``[min_len, seq_len]``
    (default ``seq_len // 2``), then padding.  Token types are 0 on the
    question, 1 on the context; the mask is 1 on real tokens."""
    rng = np.random.default_rng(seed)
    lo = seq_len // 2 if min_len is None else min_len
    rows = []
    for _ in range(n):
        length = int(rng.integers(lo, seq_len + 1))
        q_len = int(rng.integers(4, max(5, length // 4)))
        ids = np.zeros(seq_len, np.int32)
        ids[:length] = rng.integers(1000 % vocab_size, vocab_size, length)
        ids[0] = 101 % vocab_size                    # [CLS]
        ids[q_len] = ids[length - 1] = 102 % vocab_size  # [SEP]
        mask = np.zeros(seq_len, np.int32)
        mask[:length] = 1
        types = np.zeros(seq_len, np.int32)
        types[q_len + 1:length] = 1
        rows.append((ids, mask, types))
    return rows


def build_model(args: dict, device, attention="flash"):
    """The QA model of ``args`` on ``device``: weights from
    ``args["state_dict"]`` when given (carried across, e.g. by
    ``params_from_flax``), else drawn from ``args["seed"]``; dropout rate
    ``args["dropout"]`` (default 0)."""
    from tensorflowonspark_tpu_torch.models.bert import build_qa_model, init_params

    cfg = qa_config(args["config"], attention, args.get("dropout", 0.0))
    sd = args.get("state_dict") or init_params(cfg, args["seed"])
    return build_qa_model(cfg, sd, device)


def forward_batch(model, batch, batch_size: int, device):
    """Run one (possibly short) batch of rows through ``model``: pad it to
    ``batch_size`` with all-zero rows as ``examples/bert/bert_squad.py``
    pads its last batch, and return the real rows' start and end logits as
    float32 numpy arrays."""
    import torch

    cols = [np.asarray(c, np.int32) for c in batch]
    n = len(cols[0])
    if n < batch_size:
        cols = [np.concatenate([c, np.zeros((batch_size - n,) + c.shape[1:], c.dtype)])
                for c in cols]
    ids, mask, types = (torch.from_numpy(c).to(device, non_blocking=True)
                        for c in cols)
    start, end = model(ids.long(), mask, types.long())
    return (start[:n].float().cpu().numpy(), end[:n].float().cpu().numpy())


def map_fun(args: dict, ctx) -> None:
    """Worker half: serve every fed row until the feed ends, then write
    this worker's counts and timings to ``<working_dir>/bert_stats.<id>.json``:
    ``rows``, ``batches``, ``launches`` (flash-kernel launches in this
    process), ``batch_ms`` and, on the card, ``attention_ms`` (CUDA-event
    time of the attention calls in each batch)."""
    import torch

    from tensorflowonspark_tpu_torch.ops import flash_attention
    from tensorflowonspark_tpu_torch.util import (resolve_device,
                                                  strict_matmul_precision)

    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    events: list = []
    attention = (_timed_attention(flash_attention, events)
                 if device.type == "cuda" else "flash")
    model = build_model(args, device, attention)

    batch_size = int(args["batch_size"])
    feed = ctx.get_data_feed(train_mode=False)
    stats = {"rows": 0, "batches": 0, "batch_ms": [], "attention_ms": []}
    launches0 = flash_attention.launches
    with torch.inference_mode():
        while not feed.should_stop():
            batch = feed.next_batch_arrays(batch_size,
                                           timeout=float(args.get("feed_timeout", 600)))
            if batch is None:
                break
            t0 = time.perf_counter()
            start, end = forward_batch(model, batch, batch_size, device)
            stats["batch_ms"].append((time.perf_counter() - t0) * 1e3)
            if events:  # the .cpu() above synchronised the stream
                stats["attention_ms"].append(sum(s.elapsed_time(e) for s, e in events))
                events.clear()
            stats["rows"] += len(start)
            stats["batches"] += 1
            ctx.report_step(stats["batches"])
            feed.batch_results([(start[i], end[i]) for i in range(len(start))])
    stats["launches"] = flash_attention.launches - launches0
    stats["device"] = str(device)
    with open(os.path.join(ctx.working_dir, f"bert_stats.{ctx.executor_id}.json"), "w") as f:
        json.dump(stats, f)


def _timed_attention(attention_fn, events: list):
    """``attention_fn`` with a pair of CUDA events recorded around each call."""
    import torch

    def timed(q, k, v, mask=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = attention_fn(q, k, v, mask=mask)
        end.record()
        events.append((start, end))
        return out

    return timed


def run_inference(rows: list, config: dict, *, seed: int = 0,
                  batch_size: int = 16, num_workers: int = 1,
                  device: str = "cuda", state_dict: dict | None = None,
                  worker_env: dict | None = None, working_dir: str | None = None,
                  timeout: float = 600.0):
    """Driver half: boot ``num_workers`` workers running :func:`map_fun`,
    push ``rows`` through ``cluster.inference``, shut the cluster down
    (re-raising any worker error) and return ``(results, stats)``:
    one ``(start_logits, end_logits)`` per row in row order, and each
    worker's stats dict in executor order."""
    args = {"config": dict(config), "seed": seed, "batch_size": batch_size,
            "device": device, "state_dict": state_dict,
            "feed_timeout": timeout}
    cluster = TPUCluster.run(map_fun, args, num_workers,
                             input_mode=InputMode.SPARK,
                             reservation_timeout=timeout,
                             worker_env=worker_env, working_dir=working_dir)
    try:
        results = cluster.inference(rows, feed_timeout=timeout)
    finally:
        cluster.shutdown(timeout=timeout)
    stats = []
    for i in range(num_workers):
        with open(os.path.join(cluster.working_dir, f"bert_stats.{i}.json")) as f:
            stats.append(json.load(f))
    return results, stats
