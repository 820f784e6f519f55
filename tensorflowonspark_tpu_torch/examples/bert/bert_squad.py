"""BERT SQuAD-style span fine-tuning through the TFEstimator pipeline.

Port of ``examples/bert/bert_squad.py`` (``BASELINE.json`` configs[3],
"BERT-base SQuAD fine-tune via Spark ML TFEstimator pipeline").  The
DataFrame holds tokenized rows (``input_ids``, ``attention_mask``,
``token_type_ids``, ``start_position``, ``end_position``);
``TFEstimator.fit`` feeds them into a cluster training
``BertForQuestionAnswering`` (DDP across the workers, AdamW, dropout from
the strategy's per-step generators); ``TFModel.transform`` scores contexts
on the driver from the chief's export and emits the start and end logits.

The port's export takes ``(input_ids, attention_mask, token_type_ids)``
and returns the start and end logits (``bert_train.export``, outputs
``start`` and ``end`` here); the JAX package's takes ``input_ids`` alone
and returns their argmaxes.  With ``--flash`` the attention runs the CUDA
flash kernels (forward, dQ, dK/dV) on the card.  Tiny config by default so
it runs anywhere:

    python -m tensorflowonspark_tpu_torch.examples.bert.bert_squad \\
        --cpu --cluster_size 1 --steps 5

Besides the reference's flags: ``--seed`` (weights, data and dropout),
``--max_position_embeddings`` (default ``--seq_len``) and ``--model_dir``:
with it, every worker checkpoints (model, AdamW state, step) there at the
end and writes ``train_stats/<executor_id>.json`` beside the checkpoint
(``losses`` and ``step_ms`` a step, ``rows``, the flash kernels'
``launches`` and the ``device``).  An initial ``state_dict`` in the
arguments (e.g. carried over from flax by ``models.bert.params_from_flax``)
replaces the seeded weights.
"""

import argparse

SERVE_OUTPUTS = ("start", "end")


def model_config(args) -> dict:
    """The QA model's widths from the example's flags (FFN 4x hidden)."""
    return {"vocab_size": args.vocab_size, "hidden_size": args.hidden_size,
            "num_layers": args.num_layers, "num_heads": args.num_heads,
            "intermediate_size": args.hidden_size * 4,
            "max_position_embeddings": getattr(args, "max_position_embeddings", None)
            or args.seq_len,
            "dtype": "bfloat16" if args.bf16 else "float32"}


def train_fn(args, ctx):
    import json
    import os
    import time

    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.bert_train import (adamw, build_train_model, export,
                                                        kernel_launches, pad_batch, squad_loss)
    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.parallel.strategy import MultiWorkerMirroredStrategy
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if args.cpu else None)
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        seed = getattr(args, "seed", 0)
        model = build_train_model(
            {"config": model_config(args), "seed": seed, "dropout": args.dropout,
             "state_dict": getattr(args, "state_dict", None)},
            device, "flash" if args.flash else "reference")
        strategy = MultiWorkerMirroredStrategy(device, seed=seed)
        state = strategy.init_state(model, adamw(args.lr))
        step = strategy.build_train_step(squad_loss)
        feed = ctx.get_data_feed(train_mode=True)
        stats = {"losses": [], "step_ms": [], "rows": 0}
        launches0 = kernel_launches()
        while not feed.should_stop() and (args.steps == 0 or len(stats["losses"]) < args.steps):
            batch = feed.next_batch_arrays(args.batch_size, timeout=60)
            if batch is None:
                break
            t0 = time.perf_counter()
            state, metrics = step(state, strategy.shard_batch(pad_batch(batch, args.batch_size)))
            stats["losses"].append(float(metrics["loss"]))
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["rows"] += len(batch[0])
            ctx.report_step(len(stats["losses"]))
            if len(stats["losses"]) % 5 == 0:
                print(f"node {ctx.executor_id}: step {len(stats['losses'])} "
                      f"loss {stats['losses'][-1]:.4f}", flush=True)
        if len(stats["losses"]) >= args.steps > 0:
            feed.terminate()
        stats["launches"] = {k: n - launches0[k] for k, n in kernel_launches().items()}
        stats["device"] = str(device)

        if getattr(args, "model_dir", None):
            with CheckpointManager(args.model_dir) as mngr:
                mngr.save(state.step, state.state_dict())
            os.makedirs(os.path.join(args.model_dir, "train_stats"), exist_ok=True)
            with open(os.path.join(args.model_dir, "train_stats",
                                   f"{ctx.executor_id}.json"), "w") as f:
                json.dump(stats, f)
        if ctx.is_chief:
            export(args.export_dir, state.module, args.seq_len, output_names=SERVE_OUTPUTS)
            print(f"chief: exported {args.export_dir}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def make_rows(args) -> list:
    """The example's synthetic rows from ``args.seed``: full-length random
    ids (mask 1, token type 0) and a random answer span, as the JAX
    package's example draws them."""
    import numpy as np

    from tensorflowonspark_tpu_torch.dataframe import Row

    rng = np.random.default_rng(getattr(args, "seed", 0))
    rows = []
    for _ in range(args.num_samples):
        ids = rng.integers(1, args.vocab_size, size=args.seq_len)
        start = int(rng.integers(0, args.seq_len - 1))
        end = int(rng.integers(start, args.seq_len))
        rows.append(Row(input_ids=ids.astype(np.int32),
                        attention_mask=np.ones(args.seq_len, np.int32),
                        token_type_ids=np.zeros(args.seq_len, np.int32),
                        start_position=start, end_position=end))
    return rows


INPUT_MAPPING = {"input_ids": "input_ids", "attention_mask": "attention_mask",
                 "token_type_ids": "token_type_ids"}
OUTPUT_MAPPING = {"start": "pred_start", "end": "pred_end"}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--num_samples", type=int, default=128)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--vocab_size", type=int, default=1000)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1,
                   help="dropout rate; generator threaded per step by the strategy")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--flash", action="store_true",
                   help="the CUDA flash-attention kernels (use on the card)")
    p.add_argument("--export_dir", default="/tmp/bert_squad_export")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_position_embeddings", type=int, default=None)
    p.add_argument("--model_dir", default=None)
    return p


if __name__ == "__main__":
    import numpy as np

    from tensorflowonspark_tpu_torch import pipeline as pl
    from tensorflowonspark_tpu_torch.dataframe import DataFrame

    args = parser().parse_args()
    df = DataFrame(make_rows(args), num_partitions=max(2, args.cluster_size))

    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else None
    estimator = (pl.TFEstimator(train_fn, args, worker_env=worker_env,
                                device="cpu" if args.cpu else None)
                 .setClusterSize(args.cluster_size)
                 .setBatchSize(args.batch_size)
                 .setEpochs(args.epochs)
                 .setExportDir(args.export_dir)
                 .setInputMapping(INPUT_MAPPING)
                 .setOutputMapping(OUTPUT_MAPPING))
    model = estimator.fit(df)

    sample = DataFrame(df.collect()[:4]).select(*INPUT_MAPPING)
    preds = model.transform(sample)
    for row in preds.collect():
        print(f"pred span: [{int(np.argmax(row.pred_start))}, "
              f"{int(np.argmax(row.pred_end))}]")
    print("bert_squad: done")
