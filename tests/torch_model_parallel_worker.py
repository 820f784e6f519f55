"""One rank of the port's side of ``tests/test_torch_pipeline_parallel.py``,
``tests/test_torch_moe.py``, the ``ep`` x ``dp`` case of
``tests/test_torch_wide_deep.py`` and the tp batcher cases of
``tests/test_torch_sharded_serving.py``.

Run as ``python -m tests.torch_model_parallel_worker SUITE RANK WORLD PORT
DIR``: the rank joins a gloo group of ``WORLD`` CPU processes, runs every
case of ``SUITE`` (``pipeline``, ``moe``, ``wide_deep`` or ``serving``) over
``DIR/inputs.pkl`` (numpy inputs and weights the test drew) in the same
order as every other rank, and writes what it computed to
``DIR/out.RANK.pkl``.  Cases on a 2-rank mesh run on both halves of the
world at once (ranks 0-1 and 2-3), each half on the same inputs.  It
imports torch and the port only, never JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.parallel import (MeshStrategy, PipelineStrategy, comm,
                                                  make_mesh, make_moe_layer, moe_apply,
                                                  pipeline_apply, pipeline_value_and_grad)
from tensorflowonspark_tpu_torch.parallel import sharding as sh
from tensorflowonspark_tpu_torch.parallel.mesh import group_over
from tensorflowonspark_tpu_torch.parallel.transformer import make_transformer_stage

DATA = sh.P(sh.DATA_AXES)


def t(x):
    return torch.from_numpy(np.array(x))


def tree(d, fn):
    return {k: tree(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in d.items()}


def gather(x, mesh, spec):
    """The whole tensor from this rank's block under ``spec`` (every axis
    the spec names gathered, minor axis first)."""
    for d, entry in reversed(list(enumerate(spec))):
        for axis in reversed(sh._axes_of(entry)):
            x = comm.all_gather(x.contiguous(), mesh.get_group(axis), dim=d)
    return x


def stage_fn(params, x):
    """The JAX tests' stage: a 2-layer MLP block with a residual."""
    return x + torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"]


def mse_head(hp, y, tgt):
    return torch.mean((y @ hp["wo"] - tgt) ** 2)


def halves(**sizes):
    """Two meshes over ranks 0-1 and 2-3 (built by every rank, in order),
    their groups made on every rank; this rank's half."""
    meshes = [make_mesh(devices=[0, 1], device_type="cpu", **sizes),
              make_mesh(devices=[2, 3], device_type="cpu", **sizes)]
    for m in meshes:
        for axes in (("dp", "fsdp", "sp", "ep"), m.mesh_dim_names, ("dp", "fsdp", "sp"),
                     ("dp", "fsdp", "ep")):
            group_over(m, axes)
    return meshes[dist.get_rank() // 2]


# ------------------------------------------------------------------ pipeline

def gpipe_case(mesh, case):
    blocks = tree(case["stacked"], lambda k, v: sh.local_block(t(v), mesh, sh.P("pp"))
                  .clone().requires_grad_())
    x = sh.local_block(t(case["x"]), mesh, DATA)
    y = pipeline_apply(mesh, stage_fn, blocks, x, num_microbatches=case["M"])
    # the global mean of y**2 is the mean of the data shards' local means
    (torch.mean(y ** 2) / comm.group_size(mesh.get_group("dp"))).backward()
    grads = {k: gather(comm.all_reduce(p.grad, mesh.get_group("dp")), mesh, sh.P("pp"))
             for k, p in blocks.items()}
    return {"y": gather(y.detach(), mesh, DATA).numpy(),
            "grads": tree(grads, lambda k, v: v.numpy())}


def pipeline_errors(half, full, hid):
    out = []
    for mesh, rows in ((half, 6), (full, 2)):
        blocks = {"w1": torch.zeros(1, hid, hid), "b1": torch.zeros(1, hid),
                  "w2": torch.zeros(1, hid, hid)}
        try:
            pipeline_apply(mesh, stage_fn, blocks, torch.zeros(rows, hid), num_microbatches=4)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


class Stacked(nn.Module):
    """A stage-stacked model: ``stages`` (the stacked tree) and the head's
    parameters by name."""

    def __init__(self, stacked, **head):
        super().__init__()
        self.stages = nn.ParameterDict({k: nn.Parameter(t(v)) for k, v in stacked.items()})
        for k, v in head.items():
            setattr(self, k, nn.Parameter(t(v)))


def strategy_gpipe_case(case):
    strat = PipelineStrategy(stage_fn, num_stages=2, num_microbatches=case["M"], dp=2,
                             device="cpu")
    state = strat.init_state(Stacked(case["stacked"], head=case["head"], emb=case["emb"]),
                             lambda ps: torch.optim.SGD(ps, lr=case["lr"]))

    def loss_fn(model, batch):
        """The table ``emb`` feeds stage 0 and is tied into the logits."""
        h = strat.apply(strat.split(model)[0], F.embedding(batch["ids"], model.emb))
        return F.cross_entropy(h @ model.head + h @ model.emb.T, batch["y"])

    rows = sh.shard_batch(strat.mesh, {k: case[k].astype(np.int64) for k in ("ids", "y")})
    state, metrics = strat.build_train_step(loss_fn)(state, rows)
    return {"loss": float(metrics["loss"]), "bubble": strat.bubble_fraction,
            "placement": tuple(state.module.stages["w1"].shape),
            "params": _stacked_params(strat.mesh, state.module)}


def _stacked_params(mesh, model):
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("stages."):
            out[name] = gather(p.detach(), mesh, sh.P("pp")).numpy()
        else:
            out[name] = p.detach().numpy()
    return out


def f1b_case(mesh, case, fn=stage_fn, specs=None, data_spec=None):
    specs = specs if specs is not None else tree(case["stacked"], lambda k, v: sh.P())
    blocks = tree(case["stacked"], lambda k, v: None)
    for path, spec in _paths(specs):
        _set(blocks, path, sh.local_block(t(_at(case["stacked"], path)), mesh,
                                          sh.P("pp", *spec)))
    spec = data_spec if data_spec is not None else DATA
    x = sh.local_block(t(case["x"]), mesh, spec)
    tgt = sh.local_block(t(case["tgt"]), mesh, spec)
    loss, ds, dh, dx = pipeline_value_and_grad(
        mesh, fn, mse_head, blocks, {"wo": t(case["wo"])}, x, tgt,
        num_microbatches=case["M"], param_specs=specs,
        data_spec=data_spec, target_spec=data_spec)
    full = tree(case["stacked"], lambda k, v: None)
    for path, s in _paths(specs):
        _set(full, path, gather(_at(ds, path), mesh, sh.P("pp", *s)).numpy())
    return {"loss": float(loss), "ds": full, "dh": {"wo": dh["wo"].numpy()},
            "dx": gather(dx, mesh, spec).numpy()}


def _paths(specs, prefix=()):
    for k, v in specs.items():
        if isinstance(v, dict):
            yield from _paths(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _at(d, path):
    for k in path:
        d = d[k]
    return d


def _set(d, path, value):
    _at(d, path[:-1])[path[-1]] = value


def f1b_tp_case(mesh, case):
    fn, _, specs = make_transformer_stage(case["hidden"], case["heads"], case["ffn"], tp=2,
                                          causal=True, mesh=mesh)
    return f1b_case(mesh, case, fn, specs)


def strategy_1f1b_case(case):
    strat = PipelineStrategy(stage_fn, num_stages=2, num_microbatches=case["M"], dp=2,
                             device="cpu")
    state = strat.init_state(Stacked(case["stacked"], wo=case["wo"]),
                             lambda ps: torch.optim.SGD(ps, lr=case["lr"]))
    step = strat.build_train_step_1f1b(mse_head)
    batch = (sh.local_block(t(case["x"]), strat.mesh, DATA),
             sh.local_block(t(case["tgt"]), strat.mesh, DATA))
    state, metrics = step(state, batch)
    return {"loss": float(metrics["loss"]), "params": _stacked_params(strat.mesh, state.module)}


def guard_case(case):
    strat = PipelineStrategy(stage_fn, num_stages=2, num_microbatches=4, tp=2, dp=1,
                             device="cpu")
    strat.init_state(Stacked(case["stacked"], wo=case["wo"]),
                     lambda ps: torch.optim.SGD(ps, lr=0.1))
    try:
        strat.build_train_step_1f1b(lambda hp, y, tgt: y.mean())
    except ValueError as e:
        return str(e)
    return None


def pipeline_suite(cases):
    half = halves(pp=2, dp=1)
    full22 = make_mesh(pp=2, dp=2, device_type="cpu")
    tp = make_mesh(pp=2, tp=2, device_type="cpu")
    sp = make_mesh(pp=2, sp=2, device_type="cpu")
    meshes = {"2-1": half, "2-2": full22}
    out = {}
    for key, case in cases["gpipe"].items():
        out[f"gpipe-{key}"] = gpipe_case(meshes[key], case)
    out["errors"] = pipeline_errors(half, full22, cases["hid"])
    out["strategy-gpipe"] = strategy_gpipe_case(cases["strategy-gpipe"])
    for key, case in cases["1f1b"].items():
        out[f"1f1b-{key}"] = f1b_case(meshes[key], case)
    out["1f1b-tp"] = f1b_tp_case(tp, cases["1f1b-tp"])
    out["1f1b-sp"] = f1b_case(sp, cases["1f1b-sp"],
                              data_spec=sh.P(sh.DATA_AXES, "sp", None))
    out["strategy-1f1b"] = strategy_1f1b_case(cases["strategy-1f1b"])
    out["guard"] = guard_case(cases["strategy-1f1b"])
    return out


# ----------------------------------------------------------------------- moe

class MoE(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.moe = nn.ParameterDict({k: nn.Parameter(t(v)) for k, v in params.items()})


def moe_checkpoint(strategy, loss_fn, x, case, ckpt_dir):
    """An Adam step of the MoE, saved through ``CheckpointManager``,
    restored on the CPU and loaded into a fresh state: whether the
    checkpoint holds every expert whole and the fresh state got back this
    rank's parameter and Adam blocks."""
    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    def fresh():
        return strategy.init_state(MoE(case["params"]), adam(1e-3))

    state = fresh()
    state, _ = strategy.build_train_step(loss_fn)(state, x)
    mngr = CheckpointManager(ckpt_dir, async_save=False)
    mngr.save(1, state.state_dict(), force=True)
    saved = mngr.restore()
    restored = fresh()
    restored.load_state_dict(saved)
    live = {k: p.detach() for k, p in state.module.moe.items()}
    win = gather(live["win"], strategy.mesh, sh.P("ep", None, None))
    adam_live = state.optimizer.state[state.module.moe["win"]]["exp_avg"]
    adam_back = restored.optimizer.state[restored.module.moe["win"]]["exp_avg"]
    return {"whole": tuple(saved["model"]["moe.win"].shape) == tuple(win.shape)
            and torch.equal(saved["model"]["moe.win"], win),
            "restored": all(torch.equal(p.detach(), live[k])
                            for k, p in restored.module.moe.items())
            and torch.equal(adam_back, adam_live)}


def moe_case(mesh, case, ckpt_dir=None):
    ep = mesh.size(mesh.mesh_dim_names.index("ep"))
    moe_fn, _, specs = make_moe_layer(case["hid"], case["ffn"], case["experts"],
                                      top_k=case["top_k"], ep=ep, mesh=mesh)
    rules = sh.PartitionRules([(r"moe/(win|wout)", sh.P("ep", None, None)), (r".*", sh.P())])
    strategy = MeshStrategy(mesh=mesh, rules=rules, device="cpu")
    state = strategy.init_state(MoE(case["params"]), lambda ps: torch.optim.SGD(ps, lr=0.0))
    tokens = sh.P(("dp", "fsdp", "ep"))
    x = sh.local_block(t(case["x"]), mesh, tokens)

    def loss_fn(model, x):
        y, aux = moe_apply(mesh, moe_fn, dict(model.moe.items()), x, param_specs=specs)
        return torch.mean(y ** 2) + 0.01 * aux

    with torch.no_grad():
        y, aux = moe_apply(mesh, moe_fn, dict(state.module.moe.items()), x, param_specs=specs)
    state, metrics = strategy.build_train_step(loss_fn)(state, x)
    grads = {k: gather(p.grad, mesh, specs[k]).numpy() for k, p in state.module.moe.items()}
    return {"y": gather(y, mesh, tokens).numpy(), "aux": float(aux),
            "loss": float(metrics["loss"]), "grads": grads,
            "experts_here": int(state.module.moe["win"].shape[0]),
            "checkpoint": None if ckpt_dir is None else moe_checkpoint(strategy, loss_fn, x, case,
                                                                       ckpt_dir)}


def moe_suite(cases):
    meshes = {"2-1": halves(ep=2, dp=1), "2-2": make_mesh(ep=2, dp=2, device_type="cpu"),
              "4-1": make_mesh(ep=4, dp=1, device_type="cpu")}
    # the checkpoint round trip on the mesh over the whole world
    return {key: moe_case(meshes[key.rsplit("-", 1)[0]], case,
                          f"{cases['wd']}/ckpt" if key == "4-1-2" else None)
            for key, case in cases["moe"].items()}


# ----------------------------------------------------------------- wide&deep

def wide_deep_suite(cases):
    from tensorflowonspark_tpu_torch.examples.wide_deep import wide_deep_criteo as wdc
    from tensorflowonspark_tpu_torch.models import wide_deep as pw

    case = cases["wide_deep"]
    args = argparse.Namespace(**case["args"])
    device = torch.device("cpu")
    mesh, model = wdc.mesh_and_model(args, device)
    model.load_state_dict(pw.shard_state_dict(model, tree(case["init"],
                                                          lambda k, v: t(v))))
    data = list(wdc.local_batches(args, mesh))
    stats = wdc.train(model, args, device, data, reduce=wdc.gradient_reducer(model, mesh))
    return {"rows": [a for a in data[0]], "losses": stats["losses"],
            "deep_rows": int(model.emb[0].weight.shape[0]),
            "params": {k: v.numpy() for k, v in pw.full_state_dict(model).items()}}


# ------------------------------------------------------------ sharded serving

def serving_suite(cases):
    """The batcher over tp 2 Megatron shards of one GPT, every case against
    the port's own tp ``greedy_generate`` in this world: plain, speculative
    (prompt lookup), paged with a prefix hit, a sharded draft, decode
    blocks, and int8 through ``shard_quantized``."""
    from tensorflowonspark_tpu_torch.models import gpt as G
    from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, DraftModel
    from tensorflowonspark_tpu_torch.ops import quantize_params, shard_quantized
    from tensorflowonspark_tpu_torch.parallel.mesh import axis_group

    c = cases["serving"]
    cfg = G.GPTConfig(**c["cfg"], dtype=torch.float32)
    mesh = make_mesh(tp=2, device_type="cpu")
    tp = G.TensorParallel(axis_group(mesh, "tp"))
    whole = {k: t(v) for k, v in c["params"].items()}
    shardings = sh.gpt_partition_rules().tree_shardings(mesh, whole)
    shards = {"f32": shard_quantized(whole, shardings, mesh),
              "int8": shard_quantized(quantize_params(whole), shardings, mesh)}

    def solo(params, p, n):
        out = G.greedy_generate(cfg, params, np.asarray(p)[None, :], n, tp=tp)
        return out[0, len(p):].numpy()

    def run(name, params, reqs, serial=False, draft=False, **kw):
        b = ContinuousBatcher(cfg, params, max_batch=2, tp=tp, **kw)
        if draft:
            b.set_draft(DraftModel(cfg, params, window=16, tp=tp))
        if serial:        # one at a time, so a later admission hits the prefix
            got = []
            for p, n in reqs:
                rid = b.submit(p, n)
                got.append(b.run()[rid])
        else:
            rids = [b.submit(p, n) for p, n in reqs]
            res = b.run()
            got = [res[r] for r in rids]
        return {"tokens": [np.asarray(g) for g in got],
                "tp_greedy": [solo(params, p, n) for p, n in reqs],
                "spec_accepted": b.spec_accepted, "prefix_hits": b.prefix_stats()["hit"],
                "decode_dispatches": b.decode_dispatches, "decode_steps": b.decode_steps}

    f32, q8 = shards["f32"], shards["int8"]
    out = {"plain": run("plain", f32, c["plain"]),
           "speculative": run("speculative", f32, c["rep"], speculative_k=4),
           "paged": run("paged", f32, c["paged"], serial=True, kv_page_tokens=8),
           "draft": run("draft", f32, c["rep"], draft=True, speculative_k=4),
           "block": run("block", f32, c["plain"], decode_block_steps=4),
           "int8": run("int8", q8, c["int8"])}
    errors = {}
    for what, make in (
            ("aot_cache", lambda: ContinuousBatcher(cfg, f32, max_batch=2, tp=tp,
                                                    aot_cache=object())),
            ("kv_heads", lambda: G.GPT(dataclasses.replace(cfg, num_kv_heads=1), tp))):
        try:
            make()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    out["shapes"] = {n: tuple(v.shape) for n, v in f32.items()}
    out["int8_q_shapes"] = {n: tuple(v.q.shape) for n, v in q8.items() if hasattr(v, "q")}
    return out


SUITES = {"pipeline": pipeline_suite, "moe": moe_suite, "wide_deep": wide_deep_suite,
          "serving": serving_suite}


def main(suite: str, rank: int, world: int, port: int, wd: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    deadline = time.monotonic() + 300       # the test draws the inputs meanwhile
    while not os.path.exists(f"{wd}/inputs.pkl"):
        if time.monotonic() > deadline:
            raise TimeoutError("no inputs.pkl")
        time.sleep(0.05)
    with open(f"{wd}/inputs.pkl", "rb") as f:
        cases = {**pickle.load(f), "wd": wd}
    out = SUITES[suite](cases)
    with open(f"{wd}/out.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        sys.stdout.flush()
        os._exit(0)             # skips the interpreter's teardown of torch (~1.5 s)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
