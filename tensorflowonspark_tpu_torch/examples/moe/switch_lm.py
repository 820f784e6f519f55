"""Switch-style MoE language model: expert parallelism end to end.

Port of ``examples/moe/switch_lm.py``: a causal LM of an embedding, one
causal attention sublayer of ``HEADS`` heads, one capacity-bounded top-k
mixture-of-experts FFN (:func:`~tensorflowonspark_tpu_torch.parallel.make_moe_layer`)
and the embedding tied as the head, trained on the "copy the previous
token" corpus through the ``Estimator`` (``train_and_evaluate``) with
``MeshStrategy`` over a ``{ep, dp}`` mesh, the GShard load-balancing loss
added at ``--aux_weight``.  The expert stacks are cut over ``ep`` (each
rank keeps ``num_experts / ep`` of them); the rows of each global batch
are cut over ``dp`` x ``ep``, each rank routes its own tokens, and two
all-to-all exchanges move them to their experts and back.

The ranks are the workers of ``TFCluster.run`` (``--cluster_size``, by
default ``--ep``), one a card, in a NCCL group on the GPU (``--backend
gloo`` when several ranks share one card) or a gloo group with ``--cpu``::

    python -m tensorflowonspark_tpu_torch.examples.moe.switch_lm --cpu --ep 2 --max_steps 30

The chief writes ``<model_dir>/switch_lm.json``: the eval loss before and
after, the final step and the expert shards a rank.  ``--model_dir``
defaults to a fresh temporary directory; a directory that holds a
checkpoint is resumed from it.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

#: the chief's results file in ``--model_dir``
RESULTS_NAME = "switch_lm.json"
#: the JAX example's fixed settings: attention heads, Adam rate, data seed
HEADS, LR, SEED = 4, 1e-2, 0


def expert_rules():
    """Partition rules: the expert stacks cut over ``ep``, the rest
    replicated."""
    from tensorflowonspark_tpu_torch.parallel.sharding import P, PartitionRules

    return PartitionRules([(r"moe/(win|wout)", P("ep", None, None)), (r".*", P())])


def build_model(args, mesh=None, seed: int = SEED):
    """The model at ``args``' widths with weights drawn from ``seed`` (the
    MoE's from ``seed + 1``), whole: :class:`MeshStrategy` cuts the expert
    stacks.  ``mesh`` supplies the ``ep`` group (none: one rank, every
    expert local)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from tensorflowonspark_tpu_torch.parallel import make_moe_layer
    from tensorflowonspark_tpu_torch.parallel.ring_attention import reference_attention

    V, H = args.vocab, args.hidden
    moe_fn, moe_init, moe_specs = make_moe_layer(
        H, H * 4, args.num_experts, top_k=args.top_k, ep=args.ep,
        capacity_factor=getattr(args, "capacity_factor", 1.25), mesh=mesh)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return nn.Parameter(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                             * np.float32(0.02)))

    class SwitchLM(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = normal(V, H)
            self.wqkv = normal(H, 3, HEADS, H // HEADS)
            self.wo = normal(HEADS, H // HEADS, H)
            self.moe = nn.ParameterDict({k: nn.Parameter(v) for k, v in
                                         moe_init(seed + 1).items()})
            self.moe_fn, self.moe_specs, self.mesh = moe_fn, moe_specs, mesh

        def forward(self, ids):
            """``(logits [B, T, V] float32, aux_loss)``."""
            from tensorflowonspark_tpu_torch.parallel import moe_apply

            x = F.embedding(ids, self.emb)
            qkv = torch.einsum("bth,hkjd->btkjd", x, self.wqkv)
            o = reference_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True)
            x = x + torch.einsum("btjd,jdm->btm", o, self.wo)
            flat = x.reshape(-1, H)
            params = dict(self.moe.items())
            if self.mesh is None:
                y, aux = self.moe_fn(params, flat)
            else:
                y, aux = moe_apply(self.mesh, self.moe_fn, params, flat,
                                   param_specs=self.moe_specs)
            x = x + y.reshape(x.shape)
            return torch.einsum("bth,vh->btv", x.float(), self.emb.float()), aux

    return SwitchLM()


def lm_loss(aux_weight: float):
    """``loss_fn(model, batch)``: the next-token cross-entropy of this
    rank's rows (the last position has no target) plus ``aux_weight`` x
    the load-balancing loss averaged over the token shards, so the mean
    over the ranks is the global loss."""
    import torch.nn.functional as F

    def loss_fn(model, batch):
        ids = batch["ids"].long()
        logits, aux = model(ids)
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                             ids[:, 1:].reshape(-1))
        return ce + aux_weight * aux.float()

    return loss_fn


def make_batches(seed: int, n: int, batch_size: int, seq_len: int, vocab: int) -> list:
    """``n`` global batches of the "copy the previous token" corpus: each
    row one random token repeated (learnable structure)."""
    rng = np.random.default_rng(seed)
    return [{"ids": np.repeat(rng.integers(0, vocab, size=(batch_size, 1)), seq_len, axis=1)
             .astype(np.int64)} for _ in range(n)]


def rows_block(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch: its block over ``dp`` x
    ``fsdp`` x ``ep``."""
    import torch

    from tensorflowonspark_tpu_torch.parallel.sharding import P, local_block

    return {k: local_block(torch.as_tensor(v), mesh, P(("dp", "fsdp", "ep"))).contiguous()
            for k, v in batch.items()}


def map_fun(args, ctx) -> None:
    """One rank: join the group, build the mesh and the model, train with
    the Estimator (``train_and_evaluate``), and (chief) write the
    results."""
    import torch

    from tensorflowonspark_tpu_torch.estimator import (Estimator, EvalSpec, TrainSpec,
                                                       train_and_evaluate)
    from tensorflowonspark_tpu_torch.parallel import MeshStrategy, make_mesh
    from tensorflowonspark_tpu_torch.parallel.strategy import adam
    from tensorflowonspark_tpu_torch.util import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cpu":
        torch.set_num_threads(1)           # CPU workers share the host's cores
    ctx.initialize_distributed(device, backend=args.backend)
    try:
        mesh = make_mesh(ep=args.ep, dp=-1, device_type=device.type)
        print(f"switch_lm mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}", flush=True)
        strategy = MeshStrategy(mesh=mesh, rules=expert_rules(), device=device)
        # one stream of global batches, every rank cutting its own rows
        stream = iter(make_batches(SEED, 10 ** 4, args.batch_size, args.seq_len, args.vocab))

        def input_fn():
            for _ in range(8):
                yield rows_block(mesh, next(stream))

        loss_fn = lm_loss(args.aux_weight)
        with Estimator(build_model(args, mesh), loss_fn, adam(LR), args.model_dir,
                       strategy=strategy, save_every_steps=50,
                       eval_metrics_fn=lambda model, batch: {"loss": loss_fn(model, batch)},
                       summary_dir="") as est:
            baseline = est.evaluate(input_fn, steps=2)["loss"]
            final = train_and_evaluate(
                est, TrainSpec(input_fn=input_fn, max_steps=args.max_steps),
                EvalSpec(input_fn=input_fn, steps=2,
                         throttle_steps=max(1, args.max_steps // 2)))
            shards = est.params["moe.win"].shape[0]
        if ctx.is_chief:
            print(f"switch_lm: baseline {baseline:.4f} -> final {final['loss']:.4f} at step "
                  f"{final['global_step']}", flush=True)
            print(f"switch_lm: {shards} of {args.num_experts} experts a rank", flush=True)
            with open(os.path.join(args.model_dir, RESULTS_NAME), "w") as f:
                json.dump({"baseline": baseline, "final": final["loss"],
                           "step": final["global_step"], "experts_a_rank": shards}, f)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ep", type=int, default=2)
    p.add_argument("--num_experts", type=int, default=4)
    p.add_argument("--top_k", type=int, default=2)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seq_len", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_steps", type=int, default=30)
    p.add_argument("--aux_weight", type=float, default=0.01)
    p.add_argument("--cluster_size", type=int, default=0,
                   help="workers: ep x dp (default: --ep, dp 1)")
    p.add_argument("--backend", default=None,
                   help="torch.distributed backend (default nccl on the card, gloo with "
                        "--cpu; gloo when ranks share one card)")
    p.add_argument("--model_dir", default=None,
                   help="checkpoints and results; a run resumes from what is there "
                        "(default: a fresh temporary directory)")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from tensorflowonspark_tpu_torch import TFCluster
    from tensorflowonspark_tpu_torch.cluster import InputMode

    args = parse_args(argv)
    if args.model_dir is None:
        args.model_dir = tempfile.mkdtemp(prefix="switch_lm_")
    workers = args.cluster_size or args.ep
    if workers % args.ep or args.batch_size % workers:
        raise SystemExit(f"--cluster_size {workers} must divide by --ep {args.ep} and "
                         f"--batch_size {args.batch_size} by the workers")
    env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else {}
    cluster = TFCluster.run(None, map_fun, args, workers, 0, False, InputMode.TENSORFLOW,
                            reservation_timeout=120, worker_env=env,
                            working_dir=args.model_dir)
    cluster.shutdown(timeout=600)
    with open(os.path.join(args.model_dir, RESULTS_NAME)) as f:
        out = json.load(f)
    if not out["final"] < out["baseline"]:
        raise SystemExit(f"switch_lm: MoE LM failed to learn ({out['baseline']} -> "
                         f"{out['final']})")
    print("switch_lm: done", flush=True)
    return out


if __name__ == "__main__":
    main()
