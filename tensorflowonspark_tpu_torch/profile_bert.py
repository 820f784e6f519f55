"""Where a BERT-base QA batch, or a training step, spends its time on the card.

    python -m tensorflowonspark_tpu_torch.profile_bert [--seed 0] [--batches 5] [--train]

Without ``--train``: the slice-1 worker forward
(``bert_inference.forward_batch``, flash attention, bf16, random weights
from ``--seed``) on one batch of 16 SQuAD-shaped rows at T=384.  With
``--train``: one full training step of the slice-2 worker
(``bert_train.squad_loss`` through ``DataParallelStrategy``: forward,
backward through the flash kernels, AdamW at lr 3e-5, dropout 0.1) on 16
rows.  Either warms up, then traces ``--batches`` batches or steps with
``torch.profiler``.  Prints device time by kernel family, the device's
busy share of the traced wall time and of the same loop's wall time with
the profiler off, and one JSON line with the same
numbers.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json


def forward(seed: int, device):
    """One inference batch of the slice-1 worker, as a callable."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch import bert_inference as bi

    model = bi.build_model({"config": bi.BERT_BASE, "seed": seed}, device)
    rows = bi.make_rows(16, 384, bi.BERT_BASE["vocab_size"], seed)
    batch = [np.stack([r[c] for r in rows]) for c in range(3)]

    def run():
        with torch.inference_mode():
            bi.forward_batch(model, batch, 16, device)
    return run


def train_step(seed: int, device):
    """One training step of the slice-2 worker (forward, backward, AdamW),
    as a callable; the loss is read back each step, as the worker does."""
    import numpy as np

    from tensorflowonspark_tpu_torch import bert_inference as bi
    from tensorflowonspark_tpu_torch import bert_train as bt
    from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

    args = {"config": bi.BERT_BASE, "seed": seed, "dropout": 0.1}
    strategy = DataParallelStrategy(device, seed=seed)
    state = strategy.init_state(bt.build_train_model(args, device), bt.adamw(3e-5))
    step = strategy.build_train_step(bt.squad_loss)
    rows = bt.make_train_rows(16, 384, bi.BERT_BASE["vocab_size"], seed)
    batch = bt.pad_batch([np.stack([r[c] for r in rows]) for c in range(5)], 16)

    def run():
        _, metrics = step(state, strategy.shard_batch(batch))
        float(metrics["loss"])
    return run


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batches", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="profile a training step instead of an inference batch")
    args = p.parse_args()

    from tensorflowonspark_tpu_torch.device_info import card_name_and_limit
    from tensorflowonspark_tpu_torch.devtime import profile_calls
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cuda")
    strict_matmul_precision()
    card = card_name_and_limit()
    run = train_step(args.seed, device) if args.train else forward(args.seed, device)
    what = "training step" if args.train else "batch"
    print(f"profile_bert on {card}: {what}s of 16 x 384")
    print(json.dumps({"card": card, "mode": "train" if args.train else "inference",
                      **profile_calls(run, args.batches, what)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
