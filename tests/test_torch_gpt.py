"""The port's GPT (``models/gpt.py``) against the JAX package's flax module.

Tiny configs (2 layers, hidden 32 over 4 heads, vocab 97, 32 positions, in
float32): a gpt2-class one (learned positions, LayerNorm, GELU) and a
llama-class one (RoPE, RMSNorm, SwiGLU, 2 K/V heads for 4 query heads),
with and without a sliding window.  The flax parameters are drawn with
numpy from a seed at a wider scale than flax's init (kernels and tables
N(0, 0.3²), norm scales 1 + N(0, 0.1²), biases N(0, 0.1²)), so greedy
rollouts do not settle on one repeated token, and carried across with
``params_from_flax``.

Tolerances: logits ``atol = 1e-5 · max|logit|`` (the same float32
arithmetic in another summation order; seen ~3e-7 relative); gradients of
the mean next-token cross-entropy ``atol = 1e-5 · max|g|`` over all
parameters plus ``rtol = 1e-4``.  The generation tests, on the same
configs and weights, are in ``tests/test_torch_gpt_decode.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from tensorflowonspark_tpu.models import gpt as J
from tensorflowonspark_tpu_torch.models import gpt as P
from tensorflowonspark_tpu_torch.ops import flash_attention_plain

KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
          intermediate_size=64, max_position_embeddings=32)
LLAMA = dict(pos_encoding="rope", norm="rmsnorm", mlp="swiglu", num_kv_heads=2,
             norm_eps=1e-5)
ARCHS = {"gpt2": {}, "llama": LLAMA, "llama_window": dict(LLAMA, sliding_window=5)}
LOGIT_RTOL = 1e-5
GRAD_A, GRAD_RTOL = 1e-5, 1e-4


def _cfgs(arch, **extra):
    kw = {**KW, **ARCHS[arch], **extra}
    return J.GPTConfig(**kw, dtype=jnp.float32), P.GPTConfig(**kw, dtype=torch.float32)


@functools.cache
def _flax_params(arch, scan_layers=False):
    jc, _ = _cfgs(arch, scan_layers=scan_layers)
    shapes = meta.unbox(jax.eval_shape(J.GPT(jc).init, jax.random.key(0),
                                       jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)

    def draw(path, a):
        name = path[-1].key
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape, np.float32))
        std = 0.1 if name == "bias" else 0.3
        return jnp.asarray(std * rng.standard_normal(a.shape, np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(arch, **extra):
    """``(port config, state dict)`` carried over from :func:`_flax_params`."""
    _, pc = _cfgs(arch, **extra)
    return pc, P.params_from_flax(_flax_params(arch), pc)


def _ids(B=2, T=12, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (B, T)).astype(np.int32)


#: the JAX side compiled whole, as its callers run it: run op by op, the
#: first call of each op compiles it, which took most of these tests' time
jit_apply = functools.partial(jax.jit, static_argnums=0)


@jit_apply
def _jax_value_and_grads(jc, params, ids):
    def loss(p):
        logits = J.GPT(jc).apply({"params": p}, ids)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], ids[:, 1:]).mean(), logits

    return jax.value_and_grad(loss, has_aux=True)(params)


def _jax_loss_and_grads(jc, params, ids):
    (value, logits), grads = _jax_value_and_grads(jc, params, ids)
    return float(value), np.asarray(logits), grads


def _port_loss_and_grads(pc, sd, ids):
    model = P.GPT(pc)
    model.load_state_dict(sd)
    t = torch.from_numpy(ids).long()
    logits = model(t)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, pc.vocab_size), t[:, 1:].reshape(-1))
    loss.backward()
    return loss.item(), logits.detach().numpy(), {
        n: p.grad.numpy() for n, p in model.named_parameters()}


def _assert_grads(got: dict, jax_grads, pc):
    want = {n: t.numpy() for n, t in P.params_from_flax(jax_grads, pc).items()}
    assert set(got) == set(want)
    a = GRAD_A * max(np.abs(g).max() for g in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=a, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_and_gradients_match_flax(arch):
    jc, pc = _cfgs(arch)
    ids = _ids()
    jloss, jlogits, jgrads = _jax_loss_and_grads(jc, _flax_params(arch), ids)
    pc, sd = _port(arch)
    ploss, plogits, pgrads = _port_loss_and_grads(pc, sd, ids)
    np.testing.assert_allclose(plogits, jlogits, atol=LOGIT_RTOL * np.abs(jlogits).max())
    assert abs(ploss - jloss) < 1e-5 * abs(jloss)
    _assert_grads(pgrads, jgrads, pc)


@pytest.mark.parametrize("arch", ["gpt2", "llama_window"])
def test_attention_fn_route_with_the_plain_flash_matches_the_dense_route(arch):
    """``attention_fn=flash_attention_plain`` (K/V repeated for GQA,
    ``causal=True``, ``window=``) against JAX's dense grouped route."""
    jc, _ = _cfgs(arch)
    ids = _ids()
    _, jlogits, jgrads = _jax_loss_and_grads(jc, _flax_params(arch), ids)
    pc, sd = _port(arch, attention_fn=flash_attention_plain)
    _, plogits, pgrads = _port_loss_and_grads(pc, sd, ids)
    np.testing.assert_allclose(plogits, jlogits, atol=LOGIT_RTOL * np.abs(jlogits).max())
    _assert_grads(pgrads, jgrads, pc)


def test_window_needs_an_attention_fn_that_takes_one():
    pc, sd = _port("llama_window", attention_fn=lambda q, k, v, causal: q)
    model = P.GPT(pc)
    model.load_state_dict(sd)
    with pytest.raises(ValueError, match="does not accept a window= kwarg"):
        model(torch.zeros((1, 4), dtype=torch.long))


def test_scan_layers_parameter_layout_carries_over():
    jc, pc = _cfgs("llama", scan_layers=True)
    params = _flax_params("llama", scan_layers=True)
    ids = _ids()
    want = np.asarray(jit_apply(lambda c, p, x: J.GPT(c).apply({"params": p}, x))(
        jc, params, ids))
    model = P.GPT(pc)
    model.load_state_dict(P.params_from_flax(params, pc))
    got = model(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("arch", sorted(ARCHS) + ["llama_rolling"])
def test_cached_prefill_and_decode_match_the_full_forward(arch):
    """The prefill's logits and each single-token step's against the full
    forward over the same ids (the JAX package's own invariant); with a
    rolling 5-slot ring the 6-token prefill is exact too."""
    extra = {"rolling_kv_cache": True} if arch == "llama_rolling" else {}
    pc, sd = _port("llama_window" if extra else arch, **extra)
    ids = torch.from_numpy(_ids(T=14)).long()
    model = P._model(pc, sd)
    with torch.no_grad():
        full = model(ids)
        cache = P.init_cache(pc, sd, 2)
        steps = [model(ids[:, :6], cache=cache)]
        steps += [model(ids[:, t:t + 1], cache=cache) for t in range(6, 14)]
    got = torch.cat(steps, dim=1)
    torch.testing.assert_close(got, full, atol=LOGIT_RTOL * full.abs().max().item(), rtol=0)


BAD_CONFIGS = [
    dict(pos_encoding="alibi"), dict(norm="batchnorm"), dict(mlp="relu"),
    dict(sliding_window=0), dict(rolling_kv_cache=True),
    dict(per_row_positions=True, rolling_kv_cache=True, sliding_window=4),
    dict(kv_page_tokens=3, kv_pool_pages=4, per_row_positions=True),
    dict(kv_page_tokens=64, kv_pool_pages=4, per_row_positions=True),
    dict(kv_page_tokens=4, per_row_positions=True),
    dict(kv_page_tokens=4, kv_pool_pages=4),
    dict(kv_page_tokens=4, kv_pool_pages=4, per_row_positions=True, rolling_kv_cache=True,
         sliding_window=4),
    dict(kv_page_tokens=4, kv_pool_pages=4, per_row_positions=True, kv_cache_int8=True),
    dict(kv_pool_pages=4), dict(pos_encoding="rope", hidden_size=36, num_heads=4),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: ",".join(sorted(d)))
def test_every_config_error_matches_jax(bad):
    kw = {**KW, **bad}
    with pytest.raises(ValueError) as jerr:
        J.GPTConfig(**kw)
    with pytest.raises(ValueError) as perr:
        P.GPTConfig(**kw)
    assert str(perr.value) == str(jerr.value)


def test_kv_heads_must_divide_heads():
    with pytest.raises(ValueError, match=r"num_heads \(4\) must be divisible by num_kv_heads"):
        P.GPT(P.GPTConfig(**KW, num_kv_heads=3))


def test_remat_with_dropout_gives_the_gradients_of_the_plain_blocks():
    """Checkpointed blocks redraw the forward's dropout masks on the
    recomputation: loss and gradients equal the unchecked model's."""
    out = []
    for remat in (False, True):
        pc, sd = _port("llama", remat=remat, dropout_rate=0.2)
        model = P.GPT(pc)
        model.load_state_dict(sd)
        ids = torch.from_numpy(_ids()).long()
        gen = torch.Generator().manual_seed(3)
        logits = model(ids, train=True, rng=gen)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, pc.vocab_size),
                                                 ids[:, 1:].reshape(-1))
        loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in model.named_parameters()},
                    torch.rand(1, generator=gen)))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, atol=1e-6, rtol=1e-5)
    assert out[0][2] == out[1][2]  # the generator continues where the forward left it


def test_init_params_draws_flax_init_statistics():
    pc = P.GPTConfig(**KW)
    sd = P.init_params(pc, 0)
    assert set(sd) == set(P.GPT(pc).state_dict())
    assert float(sd["ln_f.weight"].min()) == 1.0 and float(sd["layers.0.attn.out.bias"].abs().max()) == 0
    assert abs(float(sd["layers.1.mlp_up.weight"].std()) - 0.02) < 2e-3
    torch.testing.assert_close(P.init_params(pc, 0)["tok_emb.weight"], sd["tok_emb.weight"])
