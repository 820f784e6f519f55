"""Long-context LM: sequence parallelism end to end.

Port of ``examples/long_context/ring_lm.py``: a causal LM (the port's
``Bert`` trunk, causal attention, its token table tied as the LM head)
whose sequence is cut over the ``sp`` axis of a mesh, trained through the
``Estimator`` with ``MeshStrategy``.  Each rank holds its block of every
sequence, its positions offset by ``rank * T/sp``, and its attention runs
over the whole sequence through
:func:`~tensorflowonspark_tpu_torch.parallel.ring_attention.ring_attention`
(``--sp_impl ring``: K/V blocks travel around the ranks) or
:func:`~tensorflowonspark_tpu_torch.parallel.ulysses.ulysses_attention`
(``--sp_impl ulysses``: an all-to-all to head shards, where each rank runs
the flash kernels over its heads; ``--window`` bands them).  The next-token
targets are shifted over the whole sequence before it is cut, so no target
is lost at a block boundary.

The ranks are the workers of ``TFCluster.run`` (``--sp`` of them), one a
card, in a NCCL group on the GPU (``--backend gloo`` when several
ranks share one card) or a gloo group with ``--cpu``::

    python -m tensorflowonspark_tpu_torch.examples.long_context.ring_lm \\
        --cpu --sp 2 --seq_len 64

The chief writes ``<model_dir>/ring_lm.json``: each step's loss (from the
Estimator's summaries), the eval loss before and after.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np

#: the chief's results file in ``--model_dir``
RESULTS_NAME = "ring_lm.json"
#: the JAX example's fixed settings: its depth, heads, Adam rate and seed
NUM_LAYERS, NUM_HEADS, LR, SEED = 2, 4, 3e-3, 0


def model_config(args) -> dict:
    return {"vocab_size": args.vocab, "hidden_size": args.hidden,
            "num_layers": NUM_LAYERS, "num_heads": NUM_HEADS,
            "intermediate_size": args.hidden * 4,
            "max_position_embeddings": args.seq_len, "dropout_rate": 0.0,
            "dtype": args.dtype}


def make_batches(seed: int, n: int, batch_size: int, seq_len: int, vocab: int) -> list:
    """``n`` "count up" batches (learnable structure): each row starts at a
    random token and counts up modulo the vocabulary."""
    rng = np.random.default_rng(seed)
    ramp = np.arange(seq_len)[None, :]
    return [{"ids": ((rng.integers(0, vocab, size=(batch_size, 1)) + ramp) % vocab)
             .astype(np.int64)} for _ in range(n)]


def attention_fn(mesh, sp_impl: str, window: int = 0):
    """The model's ``attention_fn``: causal sequence-parallel attention
    over ``mesh``'s ``sp`` axis.  Ulysses runs the port's flash attention
    on each rank's heads (``window`` bands it); the ring streams K/V
    blocks and has no inner kernel to band."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
    from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention
    from tensorflowonspark_tpu_torch.parallel.ulysses import ulysses_attention

    if sp_impl == "ring":
        if window:
            raise ValueError("--window requires --sp_impl ulysses")
        return functools.partial(ring_attention, causal=True, mesh=mesh)
    inner = functools.partial(flash_attention, window=window) if window else flash_attention
    return functools.partial(ulysses_attention, causal=True, attn_fn=inner, mesh=mesh)


def build_model(cfg: dict, attention, state_dict: dict | None = None, seed: int = 0):
    """The trunk (``models.bert.Bert``) of ``cfg`` with ``attention`` as its
    ``attention_fn``, holding ``state_dict`` (a trunk state dict; a missing
    ``type_emb`` table is zeros) or random weights from ``seed``."""
    import torch

    from tensorflowonspark_tpu_torch.models.bert import Bert, BertConfig, init_params

    dtype = getattr(torch, cfg["dtype"])
    config = BertConfig(**{**cfg, "dtype": dtype, "attention_fn": attention})
    if state_dict is None:
        state_dict = {k[len("bert."):]: v for k, v in init_params(config, seed).items()
                      if k.startswith("bert.")}
    sd = dict(state_dict)
    sd.setdefault("type_emb.weight", torch.zeros(config.type_vocab_size, config.hidden_size))
    with torch.device("meta"):
        model = Bert(config)
    model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()},
                          assign=True)
    return model


def lm_loss(strategy, seq_len: int):
    """``loss_fn(model, batch)`` for ``strategy``: this rank's block of each
    row, its global positions, the next-token cross-entropy of its tokens
    against the tied token table in float32.  The targets are shifted over
    the whole sequence first (the last position has none); the loss is
    this rank's token-loss sum over its share of the global count, so the
    mean over the ranks is the global mean (``MeshStrategy``'s contract).
    ``strategy=None`` is one process holding the whole sequence."""
    import torch
    import torch.nn.functional as F

    sp = 1 if strategy is None else strategy.axis_size("sp")

    def loss_fn(model, batch):
        ids = batch["ids"]
        B = ids.shape[0]
        target = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
        weight = torch.ones(ids.shape, device=ids.device)
        weight[:, -1] = 0.0
        offset = 0
        if strategy is not None:
            ids, target, weight = (strategy.sequence_block(x) for x in (ids, target, weight))
            offset = strategy.sequence_offset(seq_len)
        pos = offset + torch.arange(ids.shape[1], device=ids.device)
        h = model(ids, position_ids=pos[None, :])
        logits = h.float() @ model.tok_emb.weight.float().t()
        xent = F.cross_entropy(logits.flatten(0, 1), target.flatten(), reduction="none")
        return (xent * weight.flatten()).sum() * sp / (B * (seq_len - 1))

    return loss_fn


def map_fun(args, ctx) -> None:
    """One rank: join the group, build the mesh and the model, train with
    the Estimator, and (chief) write the losses."""
    import torch

    from tensorflowonspark_tpu_torch.estimator import Estimator
    from tensorflowonspark_tpu_torch.observability import read_scalars
    from tensorflowonspark_tpu_torch.parallel import MeshStrategy, make_mesh
    from tensorflowonspark_tpu_torch.parallel.strategy import adam
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cpu":
        torch.set_num_threads(1)           # CPU workers share the host's cores
    ctx.initialize_distributed(device, backend=args.backend)
    try:
        mesh = make_mesh(sp=args.sp, dp=-1, device_type=device.type)
        strategy = MeshStrategy(mesh=mesh, device=device)
        state_dict = None
        if args.init_params:
            state_dict = dict(np.load(args.init_params))
        model = build_model(model_config(args), attention_fn(mesh, args.sp_impl, args.window),
                            state_dict, seed=SEED)
        batches = make_batches(SEED, args.max_steps + 2, args.batch_size, args.seq_len,
                               args.vocab)
        summary_dir = os.path.join(args.model_dir, "summaries")

        def train_input():
            return iter(batches[:args.max_steps])

        def eval_input():
            return iter(batches[args.max_steps:])

        with Estimator(model, lm_loss(strategy, args.seq_len), adam(LR), args.model_dir,
                       strategy=strategy, save_every_steps=10 ** 9,
                       summary_dir=summary_dir if ctx.is_chief else None,
                       log_every_steps=1) as est:
            baseline = est.evaluate(eval_input, steps=2)["loss"]
            est.train(train_input, max_steps=args.max_steps)
            final = est.evaluate(eval_input, steps=2)["loss"]
        if ctx.is_chief:
            scalars = sorted((step, value) for path in _event_files(summary_dir)
                             for _, step, tag, value in read_scalars(path)
                             if tag == "train/loss")
            out = {"losses": [v for _, v in scalars], "baseline": baseline, "final": final,
                   "sp": args.sp, "sp_impl": args.sp_impl}
            with open(os.path.join(args.model_dir, RESULTS_NAME), "w") as f:
                json.dump(out, f)
            print(f"ring_lm: loss {baseline:.4f} -> {final:.4f} (T={args.seq_len}, "
                  f"sp={args.sp}, {args.sp_impl})", flush=True)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _event_files(summary_dir: str) -> list[str]:
    return [os.path.join(summary_dir, f) for f in sorted(os.listdir(summary_dir))
            if "tfevents" in f]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--sp_impl", choices=("ring", "ulysses"), default="ring")
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (ulysses only; 0 = full causal)")
    p.add_argument("--vocab", type=int, default=32)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--seq_len", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=30)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--init_params", default="",
                   help="an npz of the trunk's state dict to start from")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default nccl on the card, gloo "
                        "with --cpu; gloo when ranks share one card)")
    p.add_argument("--model_dir", default="/tmp/ring_lm")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.cluster import InputMode

    args = parse_args(argv)
    env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else {}
    cluster = TFCluster.run(None, map_fun, args, args.sp, 0, False,
                            InputMode.TENSORFLOW, reservation_timeout=120, worker_env=env,
                            working_dir=args.model_dir)
    cluster.shutdown(timeout=600)
    with open(os.path.join(args.model_dir, RESULTS_NAME)) as f:
        out = json.load(f)
    if not out["final"] < out["baseline"]:
        raise SystemExit(f"ring_lm: no learning ({out['baseline']} -> {out['final']})")
    print("ring_lm: done", flush=True)
    return out


if __name__ == "__main__":
    main()
