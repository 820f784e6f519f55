"""The continual loop on a GPT: fine-tune and publish, then gate offline.

The pieces a :class:`~tensorflowonspark_tpu_torch.continual.ContinualPipeline`
is handed for a causal LM served by the tier:

- :func:`trainer_fn` — the training ``map_fun``: loads the base version's
  state dict (``args["continual_base_builder"]``, the registry's own base
  builder), fine-tunes only the last block and the final norm on the "+1"
  corpus (``examples/gpt/gpt_tiny.py``'s rows) with Adam, bf16 compute on
  float32 parameters and the causal flash kernels, and saves the last
  step through a :class:`~tensorflowonspark_tpu_torch.checkpoint.
  CheckpointManager` whose :class:`~tensorflowonspark_tpu_torch.continual.
  CheckpointPublisher` ships the ADAPTER delta over the base (the frozen
  blocks' entries are exactly the base's, so they drop out of it);
- :func:`eval_model_builder` / :func:`eval_predict` — the offline gate's
  batch-plane hooks: each row's mean next-token loss under the base plus
  the candidate's delta (``trial_params["continual_candidate"]``), through
  the same bf16 forward and causal kernels;
- :func:`loss_scorer` — passes a candidate whose mean loss is at most a
  reference's plus a margin.

Both workers write their kernel launches to ``<stats_dir>`` as JSON, so a
driver reads what each process launched.  On the CPU the kernels' plain
versions run (no launches).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

#: the kernels' launch counters, as ``chip_smoke.py`` names them
KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")


def plus_one_rows(n: int, seq_len: int, vocab: int, seed: int) -> np.ndarray:
    """``n`` rows of the "+1" corpus, ``(t, t+1, ...) mod vocab`` from random
    starts drawn from ``seed``: int32 ``[n, seq_len]``."""
    start = np.random.default_rng(seed).integers(0, vocab, size=(n, 1))
    return ((start + np.arange(seq_len)[None, :]) % vocab).astype(np.int32)


def compute_config(cfg, dtype: str = "bfloat16"):
    """``cfg`` computing in ``dtype`` (bf16 by default, on float32
    parameters) with the flash kernels (causal) as its attention: the
    trainer's and the offline eval's forward."""
    import torch

    from tensorflowonspark_tpu_torch.ops import flash_attention

    return dataclasses.replace(cfg, dtype=getattr(torch, dtype), attention_fn=flash_attention)


def launch_counts() -> dict[str, int]:
    """This process's launches of each flash kernel so far."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                                 flash_attention_bwd)

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_dq": flash_attention_bwd.launches_dq,
            "flash_attention_dkv": flash_attention_bwd.launches_dkv}


def trainable_prefixes(cfg) -> tuple[str, ...]:
    """The state-dict prefixes that train: the last block and the final norm."""
    return (f"layers.{cfg.num_layers - 1}.", "ln_f.")


def finetune(cfg, base: dict, batches, lr: float, device, dtype: str = "bfloat16") -> dict:
    """Adam at ``lr`` over ``batches`` (int32 ``[B, T]`` arrays) from the
    float32 state dict ``base``, only :func:`trainable_prefixes` training,
    under :func:`compute_config` in ``dtype``.  ``base`` is left as it is.  Returns
    ``{"model", "losses", "step_ms", "launches"}`` (the launches a step)."""
    import torch

    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.parallel.strategy import adam

    model = gpt_tiny.build_model(compute_config(cfg, dtype), 0,
                                 {n: t.detach().to(device, copy=True)
                                  for n, t in base.items()})
    train = trainable_prefixes(cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(train))
    opt = adam(lr)([p for p in model.parameters() if p.requires_grad])
    losses, step_ms, launches = [], [], []
    for ids in batches:
        before = launch_counts()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = gpt_tiny.next_token_loss(model, torch.as_tensor(ids, device=device).long())
        loss.backward()
        opt.step()
        losses.append(float(loss))                     # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = launch_counts()
        launches.append({k: after[k] - before[k] for k in KERNELS})
    return {"model": model, "losses": losses, "step_ms": step_ms, "launches": launches}


def trainer_fn(args: dict, ctx) -> None:
    """The continual trainer ``map_fun`` (see module docstring).  ``args``:
    ``continual_base_builder`` (``(args) -> (cfg, state_dict)``, float32),
    ``model_id``, ``model_dir``, ``steps``, ``batch_size``, ``seq_len``,
    ``lr``, ``seed`` (the corpus), ``device``, ``stats_dir`` and
    optionally ``compute_dtype`` (``"bfloat16"``).  The chief
    saves step ``steps`` with ``{"model": state_dict, "step": steps}``; its
    publisher ships ``model`` less the base as version ``step-<steps>``."""
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import CheckpointManager
    from tensorflowonspark_tpu_torch.continual import CheckpointPublisher
    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    t0 = time.perf_counter()
    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    torch.empty(1, device=device).cpu()           # the process's CUDA context, timed apart
    t_cuda = time.perf_counter()
    cfg, base = args["continual_base_builder"](args)
    base = {n: t.to(device) for n, t in base.items()}
    load_s = {"cuda": t_cuda - t0, "load": time.perf_counter() - t_cuda}
    steps = int(args["steps"])
    rows = plus_one_rows(steps * int(args["batch_size"]), int(args["seq_len"]),
                         cfg.vocab_size, int(args["seed"]))
    batches = np.split(rows, steps)
    out = finetune(cfg, base, batches, float(args["lr"]), device,
                   args.get("compute_dtype", "bfloat16"))
    published = []
    t0 = time.perf_counter()
    with CheckpointManager(args["model_dir"]) as mngr:
        CheckpointPublisher(ctx, args["model_id"], base=base).attach(
            mngr, transform=lambda state: state["model"])
        # listeners run in order: this one once the publication is enqueued
        mngr.add_save_listener(lambda step, state: published.append(time.time()))
        mngr.save(steps, {"model": out["model"].state_dict(), "step": steps}, force=True)
    save_s = time.perf_counter() - t0
    stats = {k: out[k] for k in ("losses", "step_ms", "launches")}
    stats.update(load_s=load_s, save_and_publish_s=save_s, published_at=published[0],
                 device=str(device))
    with open(os.path.join(args["stats_dir"], f"trainer.{ctx.executor_id}.json"), "w") as f:
        json.dump(stats, f)


def eval_model_builder(args: dict) -> dict:
    """The offline gate's ``model_builder``: the base state dict
    (``args["continual_base_builder"]``) on ``args["device"]``, built once
    a worker; :func:`eval_predict` applies each candidate's delta over it
    and computes in ``args.get("compute_dtype", "bfloat16")``."""
    import torch

    from tensorflowonspark_tpu_torch.util import resolve_device, strict_matmul_precision

    t0 = time.perf_counter()
    device = resolve_device(args.get("device"))
    strict_matmul_precision()
    if device.type == "cpu":
        torch.set_num_threads(1)  # CPU workers share the host's cores
    torch.empty(1, device=device).cpu()           # the process's CUDA context, timed apart
    t_cuda = time.perf_counter()
    cfg, base = args["continual_base_builder"](args)
    base = {n: t.to(device) for n, t in base.items()}
    return {"cfg": cfg, "base": base, "device": device,
            "dtype": args.get("compute_dtype", "bfloat16"), "stats_dir": args.get("stats_dir"),
            "built": {}, "batches": 0, "launches": {k: 0 for k in KERNELS}, "batch_ms": [],
            "load_s": {"cuda": t_cuda - t0, "load": time.perf_counter() - t_cuda}}


def _candidate_model(model: dict, trial_params):
    """The forward module of the candidate in ``trial_params`` (the base
    when there is none), kept for the next batch of the same version."""
    from tensorflowonspark_tpu_torch.examples.gpt import gpt_tiny
    from tensorflowonspark_tpu_torch.serving.rollout import apply_adapter

    cand = (trial_params or {}).get("continual_candidate")
    key = None if cand is None else (cand["version"], cand.get("flavor"))
    net = model["built"].get(key)
    if net is None:
        params = model["base"]
        if cand is not None:
            if cand.get("flavor", "adapter") != "adapter":
                raise ValueError("eval_predict scores adapter candidates only")
            params = apply_adapter(params, cand["payload"])
        model["built"].clear()                      # one version held at a time
        net = model["built"][key] = gpt_tiny.build_model(
            compute_config(model["cfg"], model["dtype"]), 0, params).eval()
    return net


def eval_predict(model: dict, records, trial_params) -> list[bytes]:
    """The offline gate's ``predict_fn``: each row's mean next-token loss
    under the candidate of ``trial_params`` over the base, one float64
    record a row (:func:`row_losses` reads them back)."""
    import torch
    import torch.nn.functional as F

    t0 = time.perf_counter()
    net = _candidate_model(model, trial_params)
    before = launch_counts()
    ids = torch.as_tensor(np.asarray(records), device=model["device"]).long()
    with torch.inference_mode():
        logits = net(ids)[:, :-1].float()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1),
                               reduction="none").view(ids.shape[0], -1).mean(dim=1)
        out = [np.float64(x).tobytes() for x in loss.cpu().double().numpy()]
    after = launch_counts()
    model["batches"] += 1
    model["batch_ms"].append((time.perf_counter() - t0) * 1e3)
    for k in KERNELS:
        model["launches"][k] += after[k] - before[k]
    if model.get("stats_dir"):
        path = os.path.join(model["stats_dir"], f"eval_stats.{os.getpid()}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({k: model[k] for k in ("batches", "launches", "batch_ms", "load_s")}, f)
        os.replace(path + ".tmp", path)
    return out


def row_losses(results) -> np.ndarray:
    """The per-row losses of :func:`eval_predict`'s records."""
    return np.frombuffer(b"".join(results), np.float64)


def loss_scorer(reference: float, margin: float):
    """``scorer(results) -> (metrics, passed)`` for ``OfflineEval`` over
    :func:`eval_predict`'s records: the rows' mean loss must be at most
    ``reference + margin``."""
    def scorer(results):
        mean = float(np.mean(row_losses(results)))
        return ({"mean_loss": mean, "reference": float(reference), "margin": float(margin),
                 "rows": len(results)}, mean <= reference + margin)

    return scorer


def read_stats(stats_dir: str, prefix: str) -> list[dict]:
    """The JSON stats files ``<prefix>.*.json`` the workers left in
    ``stats_dir``."""
    out = []
    for name in sorted(os.listdir(stats_dir)):
        if name.startswith(prefix + ".") and name.endswith(".json"):
            with open(os.path.join(stats_dir, name)) as f:
                out.append(json.load(f))
    return out
