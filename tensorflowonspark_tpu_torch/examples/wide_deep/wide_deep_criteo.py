"""Wide&Deep CTR on Criteo-style data — the PS-mode parity workload.

Port of ``examples/wide_deep/wide_deep_criteo.py`` (``BASELINE.json``
configs[4]: the reference's gRPC parameter servers exist to hold the big
sparse embedding tables).  As in the JAX example, ``--num_ps`` is the size
of the mesh's ``ep`` axis (:func:`~tensorflowonspark_tpu_torch.parallel.mesh_from_num_ps`)
and the rest of the workers make its ``dp`` axis: the tables shard by
vocab rows over each ``ep`` group
(:class:`~tensorflowonspark_tpu_torch.parallel.ShardedEmbedding`), with
synchronous semantics and no parameter server to run.  ``--num_ps`` must
divide the cluster's size.

``--batch_size`` counts the rows of one ``dp`` shard, not of the whole
step: each ``dp`` shard draws its own ``--batch_size`` rows a step from the
stream of ``default_rng(17 + its dp index)`` (every rank of an embedding
group on the same rows, as the lookup needs), so a step trains on ``dp`` x
``--batch_size`` rows.  This differs from the JAX example, whose one
process draws one batch of ``--batch_size`` rows from ``default_rng(17)``
and cuts it over ``dp``; here a ``dp`` shard stands where a JAX executor
does, with that executor's seed, and ``--num_ps 1`` keeps the port's
earlier data-parallel runs as they were.  The step's loss is the mean over
those rows: the dense MLP's gradients are averaged over ``dp`` × ``ep``,
each table's over ``dp`` only (each ``ep`` rank owns its rows and already
holds their whole gradient).

As the JAX example: ``TPUCluster.run`` in ``InputMode.TENSORFLOW``, the
synthetic click rule of :func:`_batch` (``dense[0] > 0.6`` and feature 0 in
the low third of its vocab), ``adagrad(lr)`` (optax's, :func:`~tensorflowonspark_tpu_torch.parallel.adagrad`)
over the whole model applied dense, and the mean sigmoid binary
cross-entropy; the chief saves ``{"model": weights}`` into ``--model_dir``
through the port's ``checkpoint.py``.  For Criteo-scale tables, where the
dense step's O(vocab) sweeps dominate, train the tables with
``parallel.build_sparse_embedding_train_step`` (``bench_embedding``).

Run:

    python -m tensorflowonspark_tpu_torch.examples.wide_deep.wide_deep_criteo \\
        --cpu --cluster_size 4 --num_ps 2 --steps 20 --vocab_size 1000

Besides the reference's flags: ``--seed`` (weights), ``--save_every``
(checkpoint every that many steps as well) and ``--cpu``.  Each worker
writes ``<working_dir>/wide_deep_stats.<id>.json`` (every step's loss on
its rows and time, examples/s, peak device memory).
"""

import argparse
import json
import os
import time

NUM_DENSE = 13
NUM_CATEGORICAL = 26


def _batch(rng, vocab_sizes, batch_size):
    import numpy as np

    dense = rng.random((batch_size, NUM_DENSE), np.float32)
    cat = np.stack([rng.integers(0, v, size=batch_size) for v in vocab_sizes],
                   axis=1)
    # synthetic click rule so learning is measurable: dense[0] high + feature
    # 0 in its low vocab range → click
    label = ((dense[:, 0] > 0.6) & (cat[:, 0] < vocab_sizes[0] // 3)).astype(
        np.float32)
    return dense, cat, label


def batches(args, data_seed: int):
    """The batches a data shard trains on, as numpy: the stream of
    ``default_rng(data_seed)``, whose first draw the JAX example spends on
    its init batch."""
    import numpy as np

    vocab_sizes = [args.vocab_size] * NUM_CATEGORICAL
    rng = np.random.default_rng(data_seed)
    _batch(rng, vocab_sizes, args.batch_size)
    for _ in range(args.steps):
        yield _batch(rng, vocab_sizes, args.batch_size)


def data_seed(mesh) -> int:
    """The seed of this rank's batches: 17 + its ``dp`` index (17 with no
    mesh: a single worker)."""
    return 17 + (0 if mesh is None else mesh.get_local_rank("dp"))


def gradient_reducer(model, mesh):
    """``reduce(model)`` for :func:`train`: each table's gradients averaged
    over ``dp`` (the ranks holding the same rows), every other gradient
    over ``dp`` × ``ep`` (all of them the same over ``ep``, whose ranks
    share the rows and the loss); ``None`` with no mesh.  Builds its
    process groups, so every rank calls it at the same point."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import comm
    from tensorflowonspark_tpu_torch.parallel.mesh import group_over
    from tensorflowonspark_tpu_torch.parallel.strategy import _coalesced

    if mesh is None:
        return None
    tables = {id(p) for m in (*model.wide, *model.emb) for p in m.parameters()}
    groups = [(group_over(mesh, ("dp", "fsdp")),
               [p for p in model.parameters() if id(p) in tables]),
              (group_over(mesh, ("dp", "fsdp", "ep")),
               [p for p in model.parameters() if id(p) not in tables])]

    def reduce(model):
        with torch.no_grad():
            for group, params in groups:
                n = comm.group_size(group)
                grads = [p.grad for p in params if p.grad is not None]
                if n > 1 and grads:
                    _coalesced(grads, lambda flat, g=group, n=n: comm.all_reduce(flat, g)
                               .div_(n))
    return reduce


def build_model(args, device, group=None):
    """``WideDeep`` on ``device`` with the weights of ``--seed`` (drawn
    whole on the host, then this rank's rows cut out)."""
    import torch

    from tensorflowonspark_tpu_torch.models import wide_deep

    with torch.device("meta"):
        model = wide_deep.WideDeep([args.vocab_size] * NUM_CATEGORICAL, args.embed_dim,
                                   group=group)
    sd = wide_deep.shard_state_dict(model, wide_deep.init_params(model, args.seed))
    model.load_state_dict(sd, assign=True)
    return model.to(device)


def train(model, args, device, data, reduce=None, report=None, optimizer_fn=None):
    """Train ``model`` on ``data`` (``(dense, cat, label)`` numpy batches)
    with dense optax adagrad (or ``optimizer_fn``'s optimizer), the
    gradients combined over the ranks by ``reduce(model)``
    (:func:`gradient_reducer`; none alone).  Returns stats: every step's
    ``losses`` (on these rows) and ``step_ms`` (host clock after the loss
    is read), ``examples`` and the device's ``peak_bytes``.
    ``report(step, model, loss)`` runs after each step (the worker's log
    lines and checkpoints)."""
    import torch

    from tensorflowonspark_tpu_torch.models.wide_deep import sigmoid_binary_cross_entropy
    from tensorflowonspark_tpu_torch.parallel import adagrad

    opt = (optimizer_fn or adagrad(args.lr))(model.parameters())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    stats = {"losses": [], "step_ms": [], "examples": 0}
    for step, (dense, cat, label) in enumerate(data, 1):
        t0 = time.perf_counter()
        d, c, y = (torch.from_numpy(a).to(device, non_blocking=True) for a in (dense, cat, label))
        opt.zero_grad(set_to_none=True)
        loss = sigmoid_binary_cross_entropy(model(d, c), y).mean()
        loss.backward()
        if reduce is not None:
            reduce(model)
        opt.step()
        stats["losses"].append(loss.item())
        stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
        stats["examples"] += len(label)
        if report is not None:
            report(step, model, stats["losses"][-1])
    stats["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
    return stats


def mesh_and_model(args, device):
    """The ``{ep: num_ps, dp: the rest}`` mesh over the process group and
    the model with its tables cut over this rank's ``ep`` group; a single
    worker (no process group) has no mesh and holds the whole model."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel import mesh_from_num_ps
    from tensorflowonspark_tpu_torch.parallel.mesh import axis_group

    if not dist.is_initialized():
        if args.num_ps > 1:
            raise ValueError(f"--num_ps {args.num_ps} needs that many workers at least")
        return None, build_model(args, device)
    mesh = mesh_from_num_ps(args.num_ps, device_type=device.type)
    return mesh, build_model(args, device, axis_group(mesh, "ep"))


def main_fun(args, ctx):
    import torch
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.models.wide_deep import full_state_dict
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    device = resolve_device("cpu" if args.cpu else getattr(args, "device", None))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    ctx.initialize_distributed(device)
    try:
        mesh, model = mesh_and_model(args, device)
        shape = {} if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"node {ctx.executor_id}: mesh {shape}: embedding group of {args.num_ps}, "
              f"{sum(t.weight.shape[0] for t in model.emb)} deep rows here", flush=True)
        mngr = CheckpointManager(args.model_dir, async_save=False) if args.model_dir else None

        def report(step, model, loss):
            if step % 10 == 0:
                print(f"node {ctx.executor_id}: step {step} logloss {loss:.4f}", flush=True)
            if mngr and (step == args.steps or args.save_every and step % args.save_every == 0):
                mngr.save(step, {"model": full_state_dict(model)}, force=True)

        stats = train(model, args, device, batches(args, data_seed(mesh)),
                      reduce=gradient_reducer(model, mesh), report=report)
        if mngr:
            mngr.close()
            if ctx.is_chief:
                print(f"chief: saved {args.model_dir}", flush=True)
        stats["device"] = str(device)
        with open(os.path.join(ctx.working_dir,
                               f"wide_deep_stats.{ctx.executor_id}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    from tensorflowonspark_tpu_torch import InputMode, TPUCluster

    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=1)
    p.add_argument("--num_ps", type=int, default=1,
                   help="the ep axis: embedding-group size (the reference's PS count); it "
                        "must divide cluster_size, the rest of which is dp")
    p.add_argument("--batch_size", type=int, default=256,
                   help="rows a step of each dp shard (the JAX example's: of the whole step)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--vocab_size", type=int, default=1000)
    p.add_argument("--embed_dim", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=0)
    p.add_argument("--model_dir", default="")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    worker_env = {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""} if args.cpu else None
    cluster = TPUCluster.run(main_fun, args, args.cluster_size,
                             input_mode=InputMode.TENSORFLOW,
                             worker_env=worker_env, reservation_timeout=60)
    cluster.shutdown(timeout=1800)
    print("wide_deep_criteo: done")
