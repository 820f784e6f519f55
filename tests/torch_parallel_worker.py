"""One rank of the port's side of ``tests/test_torch_parallel.py``.

Run as ``python -m tests.torch_parallel_worker RANK WORLD PORT DIR``: the
rank joins a gloo group of ``WORLD`` CPU processes, runs every case of
``DIR/inputs.pkl`` (numpy inputs the test drew, with the JAX package's
weights where a case needs them) in the same order as every other rank,
and writes what it computed to ``DIR/out.RANK.pkl``.  It imports torch
and the port only, never JAX.
"""

from __future__ import annotations

import functools
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention
from tensorflowonspark_tpu_torch.parallel import (FSDPStrategy, MeshStrategy,
                                                  make_hybrid_mesh, make_mesh,
                                                  mesh_from_num_ps, ring_self_attention,
                                                  ulysses_self_attention)
from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel.mesh import group_over
from tensorflowonspark_tpu_torch.parallel import sharding as sh
from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention
from tensorflowonspark_tpu_torch.parallel.transformer import make_transformer_stage
from tensorflowonspark_tpu_torch.parallel.ulysses import ulysses_attention


def t(x, grad=False):
    out = torch.from_numpy(np.array(x))
    return out.requires_grad_(grad) if grad else out


def attention_case(fn, mesh, case):
    q, k, v = (t(case[n], grad=True) for n in "qkv")
    mask = None if case["mask"] is None else t(case["mask"])
    out = fn(mesh, q, k, v, mask=mask, causal=case["causal"])
    (out * t(case["cot"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def missing_axis(mesh, case):
    q = t(case["q"])[:, :4]
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        try:
            fn(q, q, q, axis_name="sq_typo", mesh=mesh)
            out[name] = None
        except Exception as e:  # noqa: BLE001 — the test reads what was raised
            out[name] = (type(e).__name__, str(e))
    return out


def _full_grad(g, spec, mesh):
    """Gather a tp-sharded gradient back to its full shape."""
    for d, entry in enumerate(spec):
        if entry is not None:
            g = comm.all_gather(g.contiguous(), mesh.get_group(entry), dim=d)
    return g


def transformer_case(mesh, case, impl):
    stage_fn, _, specs = make_transformer_stage(
        case["hidden"], case["heads"], case["ffn"], tp=2, causal=True, sp_impl=impl,
        mesh=mesh)
    sp = mesh.get_group("sp")
    params = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            params[name] = {k: t(case["params"][name][k], grad=True) for k in spec}
        else:
            params[name] = sh.local_block(t(case["params"][name]), mesh, spec) \
                .clone().requires_grad_(True)
    x = sh.local_block(t(case["x"]), mesh, sh.P(None, "sp")).clone().requires_grad_(True)
    cot = sh.local_block(t(case["cot"]), mesh, sh.P(None, "sp"))
    out = stage_fn(params, x)
    (out * cot).sum().backward()
    grads = {}
    for name, spec in specs.items():
        if isinstance(spec, dict):
            grads[name] = {k: comm.all_reduce(params[name][k].grad, sp).numpy()
                           for k in spec}
        else:
            g = comm.all_reduce(params[name].grad, sp)
            grads[name] = _full_grad(g, spec, mesh).numpy()
    return {"out": comm.all_gather(out.detach(), sp, dim=1).numpy(),
            "dx": comm.all_gather(x.grad, sp, dim=1).numpy(), "grads": grads}


class Linear(nn.Module):
    """``x @ w (+ b)`` over the given parameters (FSDP2 gathers its shards
    around ``forward``)."""

    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, nn.Parameter(t(v).float()))

    def forward(self, x):
        return x @ self.w + self.b if hasattr(self, "b") else x @ self.w


def _full(p):
    return (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().numpy()


def train_case(strategy, model, lr, batch, loss_fn, steps):
    state = strategy.init_state(model, lambda ps: torch.optim.SGD(ps, lr=lr))
    step = strategy.build_train_step(loss_fn)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, strategy.shard_batch(batch))
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "params": {n: _full(p) for n, p in state.module.named_parameters()},
            "state": state}


def mse(model, batch):
    return torch.mean((model(batch["x"]) - batch["y"]) ** 2)


def routing_case(mesh):
    strategy = MeshStrategy(mesh=mesh, device="cpu")
    seen = {}

    def fresh():
        return strategy.init_state(Linear({"w": np.zeros((), np.float32)}),
                                   lambda ps: torch.optim.SGD(ps, lr=0.1))

    state = fresh()
    state.extras["scale"] = torch.tensor(3.0)

    def loss_extras(model, batch, extras):
        return ((model.w * extras["scale"] - batch) ** 2).mean(), \
            {"extras": {"scale": extras["scale"] + 1}}
    loss_extras.has_aux = True
    state, _ = strategy.build_train_step(loss_extras)(state, torch.ones(8))
    seen["scale"] = float(state.extras["scale"])

    def loss_default(model, batch, rng=None):
        seen["rng"] = isinstance(rng, torch.Generator)
        return ((model.w - batch) ** 2).mean()
    strategy.build_train_step(loss_default)(fresh(), torch.ones(8))

    def loss_kwargs(model, batch, **kw):
        seen["kwargs"] = sorted(kw)
        return ((model.w - batch) ** 2).mean()
    strategy.build_train_step(loss_kwargs)(fresh(), torch.ones(8))
    x = {"h": torch.ones(8, 4, 6), "loss": 0.5}
    seen["anchor"] = strategy.anchor_activations(x) is x
    return seen


def main(rank: int, world: int, port: int, wd: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    # the test draws the inputs while the group boots (and runs the JAX side
    # while the ranks run)
    deadline = time.monotonic() + 300
    while not os.path.exists(f"{wd}/inputs.pkl"):
        if time.monotonic() > deadline:
            raise TimeoutError("no inputs.pkl")
        time.sleep(0.05)
    with open(f"{wd}/inputs.pkl", "rb") as f:
        cases = pickle.load(f)
    meshes = {"dp2_sp2": make_mesh(dp=2, sp=2, device_type="cpu"),
              "sp4": make_mesh(dp=1, sp=4, device_type="cpu"),
              "tp2_sp2": make_mesh(dp=1, sp=2, tp=2, device_type="cpu"),
              "tp2": make_mesh(tp=2, device_type="cpu"),
              "num_ps2": mesh_from_num_ps(2, device_type="cpu"),
              "hybrid": make_hybrid_mesh(ici=dict(tp=2), dcn=dict(dp=2),
                                         slice_key=lambda r: r // 2, device_type="cpu")}
    out = {"shapes": {k: dict(zip(m.mesh_dim_names, m.mesh.shape)) for k, m in meshes.items()},
           "hybrid_grid": meshes["hybrid"].mesh.tolist(),
           "placements": repr(sh.named_sharding(meshes["tp2_sp2"], None, ("sp", "tp")))}
    fns = {"ring": ring_self_attention, "ulysses": ulysses_self_attention}
    for key, case in cases["attention"].items():
        impl, mesh = key.split("-")[:2]
        out[key] = attention_case(fns[impl], meshes[mesh], case)
    window = cases["window"]
    out["window"] = attention_case(functools.partial(
        ulysses_self_attention, attn_fn=functools.partial(flash_attention,
                                                          window=window["window"])),
        meshes["dp2_sp2"], window)
    out["missing_axis"] = missing_axis(meshes["sp4"], window)
    for impl in ("ring", "ulysses"):
        out[f"transformer-{impl}"] = transformer_case(meshes["tp2_sp2"],
                                                      cases["transformer"], impl)
    hybrid = cases["hybrid"]
    got = train_case(MeshStrategy(mesh=meshes["hybrid"], device="cpu"),
                     Linear({"w": np.zeros(4, np.float32)}), hybrid["lr"],
                     sh.shard_batch(meshes["hybrid"], hybrid["batch"]), mse, hybrid["steps"])
    out["hybrid"] = {k: got[k] for k in ("losses", "params")}
    fsdp = cases["fsdp"]
    strategy = FSDPStrategy(min_shard_size=1, device="cpu")
    got = train_case(strategy, Linear(fsdp["params"]), fsdp["lr"],
                     sh.shard_batch(strategy.mesh, fsdp["batch"]), mse, fsdp["steps"])
    out["fsdp"] = {k: got[k] for k in ("losses", "params")}
    big = FSDPStrategy(min_shard_size=16, device="cpu").init_state(
        Linear({"big": np.ones((64, 8), np.float32), "tiny": np.zeros(3, np.float32)}),
        lambda ps: torch.optim.Adam(ps, lr=1e-3))
    params = dict(big.module.named_parameters())
    out["fsdp_placement"] = {
        n: (repr(getattr(p, "placements", None)),
            tuple(p.to_local().shape) if hasattr(p, "to_local") else tuple(p.shape))
        for n, p in params.items()}
    out["routing"] = routing_case(meshes["sp4"])
    # a strategy a run (or an arm) must not leave a new process group behind
    out["one_group"] = (MeshStrategy(mesh=meshes["sp4"], device="cpu")._grad_group
                        is MeshStrategy(mesh=meshes["sp4"], device="cpu")._grad_group
                        is group_over(meshes["sp4"], ("dp", "fsdp", "sp")))
    tp2 = meshes["tp2"]
    w = torch.arange(32.0).reshape(8, 4)
    placed = sh.shard_params(tp2, {"w": w, "b": torch.ones(4)},
                             sh.PartitionRules([(r"w", sh.P("tp", None)), (r".*", sh.P())]))
    out["shard_params"] = {
        "w": (repr(placed["w"].placements), placed["w"].to_local().numpy(),
              sh.local_block(w, tp2, sh.P("tp", None)).numpy()),
        "b": repr(placed["b"].placements),
        "constrained": repr(sh.constrain(placed["w"], tp2).placements)}
    with open(f"{wd}/out.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    except Exception:
        traceback.print_exc()
        sys.exit(1)
