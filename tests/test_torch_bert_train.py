"""The port's second slice end to end on the CPU: driver-fed BERT SQuAD
fine-tuning through ``TPUCluster.run`` + ``cluster.train``.

Two CPU workers train a tiny BERT QA model (2 layers, hidden 64, float32,
dropout 0) on equal partitions of SQuAD-shaped rows, weights carried
across from the JAX package's flax module, with DDP over gloo and AdamW.
The chief's final weights must equal a single-process run of the port's
strategy over the same global batches (each worker's batch i side by
side), and the JAX reference: ``DataParallelStrategy`` on one CPU device
with ``optax.adamw``, dense attention, over the same global batches.

Tolerances (float32, lr 1e-3, 3 steps, so a weight moves by at most
~3e-3): per-step losses ``rtol=1e-5``; weights ``atol=5e-5`` (seen:
2e-5), except for the parameters whose gradient is zero in exact
arithmetic — the QA-head bias and the last LayerNorm bias (the start/end
softmax gradients sum to zero over positions) and the attention key
biases (softmax ignores a per-row shift).  Their gradients are rounding
noise on every side, which Adam scales up to full-size steps, so they
are held only to Adam's bound: ``|w - w_ref| <= 2 * lr * steps``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensorflowonspark_tpu.models.bert import BertConfig as JaxBertConfig
from tensorflowonspark_tpu.models.bert import \
    BertForQuestionAnswering as JaxBertQA
from tensorflowonspark_tpu.parallel.strategy import \
    DataParallelStrategy as JaxDataParallelStrategy
from tensorflowonspark_tpu_torch.bert_train import (adamw, build_train_model,
                                                    make_train_rows, pad_batch,
                                                    run_training, squad_loss)
from tensorflowonspark_tpu_torch.models.bert import params_from_flax
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

pytestmark = pytest.mark.integration

TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64)
T, BATCH, ROWS, LR = 40, 4, 24, 1e-3
WORKER_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _cols(rows):
    return [np.stack([r[i] for r in rows]) for i in range(5)]


def _noise_driven(name: str) -> bool:
    """Parameters whose exact gradient is zero (see the module docstring)."""
    last = TINY["num_layers"] - 1
    return (name in ("qa_head.bias", f"bert.layers.{last}.ln_mlp.bias")
            or name.endswith("attn.key.bias"))


def _jax_train(jcfg, params, batches):
    def loss_fn(p, batch):
        ids, mask, types, starts, ends, w = batch
        s, e = JaxBertQA(jcfg).apply({"params": p}, ids, mask, types)
        ce = (optax.softmax_cross_entropy_with_integer_labels(s, starts)
              + optax.softmax_cross_entropy_with_integer_labels(e, ends))
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0) / 2.0

    strategy = JaxDataParallelStrategy(devices=jax.devices()[:1])
    state = strategy.init_state(lambda: jax.tree_util.tree_map(jnp.asarray, params),
                                optax.adamw(LR, weight_decay=0.01))
    step = strategy.build_train_step(loss_fn)
    losses = []
    for b in batches:
        state, metrics = step(state, strategy.shard_batch(b))
        losses.append(float(metrics["loss"]))
    return params_from_flax(jax.tree_util.tree_map(np.asarray, state.params)), losses


def test_two_workers_train_like_one_process_and_like_jax(tmp_path):
    rows = make_train_rows(ROWS, T, TINY["vocab_size"], seed=3, min_len=12)
    jcfg = JaxBertConfig(**TINY, dropout_rate=0.0, dtype=jnp.float32)
    ids, mask, types = _cols(rows[:BATCH])[:3]
    params = jax.tree_util.tree_map(
        np.asarray, flax.core.meta.unbox(JaxBertQA(jcfg).init(
            jax.random.key(0), ids, mask, types)["params"]))
    state_dict = params_from_flax(params)
    config = {**TINY, "dtype": "float32"}

    stats, weights = run_training(
        rows, config, seed=0, batch_size=BATCH, lr=LR, dropout=0.0, num_workers=2,
        device="cpu", state_dict=state_dict, worker_env=WORKER_ENV,
        working_dir=str(tmp_path), timeout=120)
    steps = ROWS // 2 // BATCH
    assert [len(s["losses"]) for s in stats] == [steps, steps]
    assert [s["rows"] for s in stats] == [ROWS // 2] * 2
    assert all(n == 0 for s in stats for n in s["launches"].values())  # CPU: plain
    assert sorted(weights) == sorted(state_dict)

    # the same global batches in one process: worker 0's batch i beside worker 1's
    half = ROWS // 2
    batches = [pad_batch(_cols(rows[i:i + BATCH] + rows[half + i:half + i + BATCH]),
                         2 * BATCH) for i in range(0, half, BATCH)]
    strategy = DataParallelStrategy("cpu")
    state = strategy.init_state(build_train_model(
        {"config": config, "state_dict": state_dict}, torch.device("cpu")), adamw(LR))
    step = strategy.build_train_step(squad_loss)
    losses = []
    for b in batches:
        state, metrics = step(state, strategy.shard_batch(b))
        losses.append(float(metrics["loss"]))
    worker_mean = np.mean([s["losses"] for s in stats], axis=0)
    np.testing.assert_allclose(worker_mean, losses, rtol=1e-5)
    single = state.module.state_dict()

    jax_weights, jax_losses = _jax_train(jcfg, params, batches)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    for ref in (single, jax_weights):
        for name, w in weights.items():
            atol = 2 * LR * steps if _noise_driven(name) else 5e-5
            torch.testing.assert_close(w, ref[name], atol=atol, rtol=0, msg=name)
    # and the weights did move
    assert max((weights[k] - state_dict[k]).abs().max().item() for k in weights) > 1e-3


def test_train_map_fun_error_surfaces_at_shutdown(tmp_path):
    rows = make_train_rows(4, T, TINY["vocab_size"], seed=2, min_len=12)
    rows[1][0][3] = TINY["vocab_size"] + 7          # a token past the vocab
    with pytest.raises(RuntimeError, match="IndexError"):
        run_training(rows, {**TINY, "dtype": "float32"}, batch_size=4, dropout=0.0,
                     device="cpu", worker_env=WORKER_ENV, working_dir=str(tmp_path),
                     timeout=60)
