"""The port's BERT QA model against the JAX package's flax module.

A flax ``BertForQuestionAnswering`` at a tiny width (2 layers, hidden 64,
4 heads, vocab 100, T=40 with padding) is initialised by flax, its
parameters are carried across by ``params_from_flax``, and the same token
rows (numpy, from a seed) go through both.  The JAX flash path runs the
Pallas kernels in interpret mode (16x16 blocks); the port's flash path on
the CPU runs the kernels' plain versions.

Tolerances on the start/end logits: float32 ``atol=1e-4`` (same
arithmetic, other summation order; the seen error is ~1e-6); bfloat16
``atol=3e-2``, four bf16 steps at the logits' magnitude (~2) — the two
frameworks round bf16 at different places (a fused Dense+bias in PyTorch
against a bf16 dot then a bf16 add in XLA, GELU in f32 rounded once
against bf16 elementwise steps); the seen error is ~8e-3.

Tolerances on the gradients of the SQuAD loss, for every parameter:
``atol = a * max|g|`` over all parameters plus ``rtol``.  The absolute
floor is needed because some gradients are zero in exact arithmetic and
carry only rounding noise on both sides (the QA-head bias and the last
LayerNorm bias, as the start/end softmax gradients sum to zero over
positions; the key biases, as softmax ignores a per-row shift).  float32
``a = 1e-5, rtol = 1e-4`` (seen: 3e-7); bfloat16 ``a = 5e-2, rtol =
5e-2`` for the rounding places above, through two layers and back (seen:
1.3e-2 of max|g|).
"""

import functools

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
from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu_torch.bert_inference import make_rows
from tensorflowonspark_tpu_torch.bert_train import (adamw, make_train_rows,
                                                    pad_batch, squad_loss)
from tensorflowonspark_tpu_torch.models.bert import (BertConfig, build_qa_model,
                                                     init_params,
                                                     params_from_flax)
from tensorflowonspark_tpu_torch.ops import flash_attention as torch_flash

TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64)
T = 40


def _rows(seed=0, n=3):
    rows = make_rows(n, T, TINY["vocab_size"], seed, min_len=12)
    return [np.stack([r[i] for r in rows]) for i in range(3)]


def _flax_params(cfg, ids, mask, types):
    variables = JaxBertQA(cfg).init(jax.random.key(0), ids, mask, types)
    params = flax.core.meta.unbox(variables["params"])
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(dtype, attention, **extra):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jattn = (functools.partial(jax_flash, block_q=16, block_k=16, interpret=True)
             if attention == "flash" else None)
    tattn = torch_flash if attention == "flash" else None
    jcfg = JaxBertConfig(**TINY, dropout_rate=0.0, dtype=jdt,
                         attention_fn=jattn, **extra)
    tcfg = BertConfig(**TINY, dropout_rate=0.0, dtype=tdt,
                      attention_fn=tattn, **extra)
    return jcfg, tcfg


@pytest.mark.parametrize("dtype,attention,extra", [
    ("float32", "flash", {}),
    ("float32", "dense", {}),
    ("bfloat16", "flash", {}),
    ("bfloat16", "dense", {}),
    ("float32", "flash", {"gelu_exact": True, "norm_eps": 1e-12}),
], ids=["f32-flash", "f32-dense", "bf16-flash", "bf16-dense", "f32-flash-hf-numerics"])
def test_qa_logits_match_flax(dtype, attention, extra):
    ids, mask, types = _rows()
    jcfg, tcfg = _pair(dtype, attention, **extra)
    params = _flax_params(jcfg, ids, mask, types)
    j_start, j_end = JaxBertQA(jcfg).apply({"params": params}, ids, mask, types)

    model = build_qa_model(tcfg, params_from_flax(params), "cpu")
    launches = torch_flash.launches
    with torch.inference_mode():
        t_start, t_end = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                               torch.from_numpy(types).long())
    assert torch_flash.launches == launches  # CPU tensors: the plain version
    assert t_start.dtype == torch.float32 and t_start.shape == (3, T)
    atol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(t_start.numpy(), np.asarray(j_start), atol=atol, rtol=0)
    np.testing.assert_allclose(t_end.numpy(), np.asarray(j_end), atol=atol, rtol=0)


def test_params_from_flax_layout():
    ids, mask, types = _rows()
    jcfg, tcfg = _pair("float32", "dense")
    params = _flax_params(jcfg, ids, mask, types)
    sd = params_from_flax(params)
    want = build_qa_model(tcfg, init_params(tcfg, 0), "cpu").state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    kernel = params["bert"]["layer_1"]["attn"]["query"]["kernel"]
    np.testing.assert_array_equal(sd["bert.layers.1.attn.query.weight"].numpy(), kernel.T)


def test_init_params_is_seeded():
    cfg = BertConfig(**TINY)
    a, b, c = init_params(cfg, 3), init_params(cfg, 3), init_params(cfg, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bert.tok_emb.weight"], c["bert.tok_emb.weight"])
    assert torch.equal(a["bert.ln_emb.weight"], torch.ones(TINY["hidden_size"]))


def _train_batch(seed=5):
    """Three SQuAD training rows padded to a batch of 4 (the last has w=0)."""
    rows = make_train_rows(3, T, TINY["vocab_size"], seed, min_len=12)
    return pad_batch([np.stack([r[i] for r in rows]) for i in range(5)], 4)


def _jax_squad_loss(jcfg, params, batch):
    """``examples/bert/bert_squad.py``'s loss, with the mask and types fed."""
    ids, mask, types, starts, ends, w = batch
    s, e = JaxBertQA(jcfg).apply({"params": params}, ids, mask, types)
    ce = (optax.softmax_cross_entropy_with_integer_labels(s, starts)
          + optax.softmax_cross_entropy_with_integer_labels(e, ends))
    return (ce * w).sum() / jnp.maximum(w.sum(), 1.0) / 2.0


@pytest.mark.parametrize("dtype,attention", [
    ("float32", "dense"), ("float32", "flash"), ("bfloat16", "dense"), ("bfloat16", "flash"),
], ids=["f32-dense", "f32-flash", "bf16-dense", "bf16-flash"])
def test_qa_gradients_match_flax(dtype, attention):
    """``jax.grad`` of the SQuAD loss against the port's ``.backward()``,
    for every parameter (Dense kernels transposed back by
    ``params_from_flax``)."""
    batch = _train_batch()
    jcfg, tcfg = _pair(dtype, attention)
    params = _flax_params(jcfg, *batch[:3])
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        functools.partial(_jax_squad_loss, jcfg)))(params, batch)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads))

    model = build_qa_model(tcfg, params_from_flax(params), "cpu")
    loss = squad_loss(model, tuple(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert torch_flash.launches == 0
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5 if dtype == "float32" else 1e-3)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    scale = max(g.abs().max().item() for g in want.values())
    a, rtol = (1e-5, 1e-4) if dtype == "float32" else (5e-2, 5e-2)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, want[name], atol=a * scale, rtol=rtol, msg=name)


def test_adamw_step_matches_optax():
    """One ``torch.optim.AdamW`` step (the slice's optimizer) against one
    ``optax.adamw(lr, weight_decay=0.01)`` update, float32, from the same
    parameters and gradients."""
    rng = np.random.default_rng(0)
    params = {f"p{i}": rng.standard_normal(shape, dtype=np.float32)
              for i, shape in enumerate([(7, 5), (5,), (3, 4, 2)])}
    grads = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in params.items()}
    lr = 1e-3
    tx = optax.adamw(lr, weight_decay=0.01)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = adamw(lr)(list(tparams.values()))
    for k, p in tparams.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), atol=1e-7, rtol=1e-6)


def test_ids_only_flax_init_carries_over():
    """A flax model initialised from ids alone (as ``examples/bert/
    bert_squad.py:50`` does) has no ``type_emb``; ``build_qa_model`` fills
    a zero table and the logits match at ``token_type_ids=None``."""
    ids = _rows()[0]
    jcfg, tcfg = _pair("float32", "dense")
    variables = JaxBertQA(jcfg).init(jax.random.key(0), ids)
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(variables["params"]))
    assert "type_emb" not in params["bert"]
    sd = params_from_flax(params)
    assert "bert.type_emb.weight" not in sd
    model = build_qa_model(tcfg, sd, "cpu")
    assert torch.equal(model.bert.type_emb.weight, torch.zeros(2, TINY["hidden_size"]))
    j_start, j_end = JaxBertQA(jcfg).apply({"params": params}, ids)
    with torch.inference_mode():
        t_start, t_end = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(t_start.numpy(), np.asarray(j_start), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_end.numpy(), np.asarray(j_end), atol=1e-4, rtol=0)


def test_dropout_needs_a_generator_and_is_off_in_eval():
    cfg = BertConfig(**TINY, dropout_rate=0.1, dtype=torch.float32)
    model = build_qa_model(cfg, init_params(cfg, 0), "cpu")
    ids = torch.from_numpy(_rows()[0]).long()
    with pytest.raises(ValueError, match="rng"):
        model(ids, train=True)
    a, _ = model(ids)
    b, _ = model(ids, train=False, rng=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    c, _ = model(ids, train=True, rng=torch.Generator().manual_seed(0))
    assert not torch.equal(a, c)
