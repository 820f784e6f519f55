"""The port's BERT QA model against the JAX package's flax module.

A flax ``BertForQuestionAnswering`` at a tiny width (2 layers, hidden 64,
4 heads, vocab 100, T=40 with padding) is initialised by flax, its
parameters are carried across by ``params_from_flax``, and the same token
rows (numpy, from a seed) go through both.  The JAX flash path runs the
Pallas forward in interpret mode (16x16 blocks); the port's flash path on
the CPU runs the kernel's plain version.

Tolerances on the start/end logits: float32 ``atol=1e-4`` (same
arithmetic, other summation order; the seen error is ~1e-6); bfloat16
``atol=3e-2``, four bf16 steps at the logits' magnitude (~2) — the two
frameworks round bf16 at different places (a fused Dense+bias in PyTorch
against a bf16 dot then a bf16 add in XLA, GELU in f32 rounded once
against bf16 elementwise steps); the seen error is ~8e-3.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models.bert import BertConfig as JaxBertConfig
from tensorflowonspark_tpu.models.bert import \
    BertForQuestionAnswering as JaxBertQA
from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu_torch.bert_inference import make_rows
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
