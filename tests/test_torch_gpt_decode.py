"""The port's GPT decoding (``models/gpt.py``) against the JAX package's.

The configs and weights of ``tests/test_torch_gpt.py`` (tiny, float32,
flax parameters drawn wider than flax's init so rollouts move).  Token
streams must be equal: greedy, lookup (with its forward count) and beam
search, the rolling, int8-KV and per-row caches, and int8 weights against
JAX's; the paged pool's logits at every step within ``1e-5 · max|logit|``;
``nucleus_filter`` exactly.  Sampling cannot reproduce JAX's random
stream, so ``sample_generate`` is held to the properties the JAX tests
check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.models import gpt as J
from tensorflowonspark_tpu_torch.models import gpt as P
from tests.test_torch_gpt import KW, LOGIT_RTOL, _cfgs, _flax_params, _ids, _port

#: the JAX decoders compiled whole (config and lengths static), as its
#: callers run them: op by op they compile each op at its first call
greedy = jax.jit(J.greedy_generate, static_argnums=(0, 3))
lookup = jax.jit(J.lookup_generate, static_argnums=(0, 3),
                 static_argnames=("draft_len", "return_stats"))
beam = jax.jit(J.beam_generate, static_argnums=(0, 3),
               static_argnames=("num_beams", "eos_id", "length_penalty", "return_scores"))


@pytest.mark.parametrize("arch", ["gpt2", "llama_window"])
def test_greedy_lookup_and_beam_tokens_equal_jax(arch):
    jc, _ = _cfgs(arch)
    params = _flax_params(arch)
    pc, sd = _port(arch)
    prompt = _ids(T=6)
    want = np.asarray(greedy(jc, params, jnp.asarray(prompt), 10))
    got = P.greedy_generate(pc, sd, prompt, 10).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want[:, 6:].ravel())) > 2  # a rollout that moves

    jlk, jstats = lookup(jc, params, jnp.asarray(prompt), 10, draft_len=3,
                                    return_stats=True)
    plk, pstats = P.lookup_generate(pc, sd, prompt, 10, draft_len=3, return_stats=True)
    np.testing.assert_array_equal(plk.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jlk), want)
    assert pstats == {"forwards": int(jstats["forwards"])}

    jb, js = beam(jc, params, jnp.asarray(prompt), 6, num_beams=3, eos_id=5,
                             length_penalty=1.0, return_scores=True)
    pb, ps = P.beam_generate(pc, sd, prompt, 6, num_beams=3, eos_id=5, length_penalty=1.0,
                             return_scores=True)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_array_equal(P.beam_generate(pc, sd, prompt, 6, num_beams=1).numpy(),
                                  want[:, :12])


#: (arch, options, prompt length)
VARIANTS = {"rolling": ("llama_window", dict(rolling_kv_cache=True), 4),
            "int8_kv": ("llama", dict(kv_cache_int8=True), 7),
            "per_row": ("gpt2", dict(per_row_positions=True), 7)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cache_variants_decode_the_jax_tokens(variant):
    """Rolling window (a 4-token prompt into a 5-slot ring that the decode
    then wraps), int8 K/V and per-row positions: greedy tokens equal JAX's
    with the same option."""
    arch, extra, T0 = VARIANTS[variant]
    jc, _ = _cfgs(arch, **extra)
    pc, sd = _port(arch, **extra)
    prompt = _ids(T=T0, seed=3)
    want = np.asarray(greedy(jc, _flax_params(arch), jnp.asarray(prompt), 9))
    np.testing.assert_array_equal(P.greedy_generate(pc, sd, prompt, 9).numpy(), want)


def test_rolling_prefill_past_the_window_is_exact_where_the_reference_is_not():
    """A 7-token prompt into a 5-slot ring of a 2-layer model: the port's
    rolling decode gives the tokens of the windowed model decoded with the
    full cache (the JAX package's, which is exact), while the JAX
    package's rolling decode does not — its prefill writes the block
    before reading it, evicting keys the block's early positions need, and
    the second layer carries that into the last position (ROADMAP queue
    C)."""
    jc, _ = _cfgs("llama_window")
    jroll, _ = _cfgs("llama_window", rolling_kv_cache=True)
    pc, sd = _port("llama_window", rolling_kv_cache=True)
    params, prompt = _flax_params("llama_window"), _ids(T=7, seed=3)
    exact = np.asarray(greedy(jc, params, jnp.asarray(prompt), 9))
    np.testing.assert_array_equal(P.greedy_generate(pc, sd, prompt, 9).numpy(), exact)
    reference = np.asarray(greedy(jroll, params, jnp.asarray(prompt), 9))
    assert not np.array_equal(reference, exact)


def test_paged_decode_matches_jax_with_dropped_writes():
    """Paged pool (4-token pages, 6 pages), per-row positions: row 0 holds
    pages 0-2, row 1 pages 3-4 and decodes past them, so its writes at
    positions 8.. go to unallocated pages and are dropped (JAX
    ``mode="drop"``; the port's scratch row), and its reads of those
    positions see page 5 through the clamped sentinel.  Every step's
    logits equal JAX's."""
    extra = dict(per_row_positions=True, kv_page_tokens=4, kv_pool_pages=6)
    jc, _ = _cfgs("gpt2", **extra)
    pc, sd = _port("gpt2", **extra)
    params = _flax_params("gpt2")
    P_, npg = 6, KW["max_position_embeddings"] // 4
    bt = np.full((2, npg), P_, np.int32)
    bt[0, :3] = [0, 1, 2]
    bt[1, :2] = [3, 4]
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(bt) if path[-1].key == "block_table" else x,
        J.init_cache(jc, params, 2))
    cache = P.init_cache(pc, sd, 2)
    for lc in cache["layers"]:
        lc["block_table"].copy_(torch.from_numpy(bt))
    jstep = jax.jit(lambda p, c, x: J.GPT(jc, decode=True).apply(
        {"params": p, "cache": c}, x, mutable=["cache"]))
    model = P._model(pc, sd)
    ids = _ids(T=11, seed=4)
    blocks = [(0, 5)] + [(t, t + 1) for t in range(5, 11)]
    for a, b in blocks:
        jl, v = jstep(params, jcache, jnp.asarray(ids[:, a:b]))
        jcache = v["cache"]
        with torch.no_grad():
            pl = model(torch.from_numpy(ids[:, a:b]).long(), cache=cache)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   atol=LOGIT_RTOL * np.abs(np.asarray(jl)).max())


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9, 1.0])
def test_nucleus_filter_equals_jax(top_p):
    logits = np.random.default_rng(5).standard_normal((3, 50)).astype(np.float32) * 3
    logits[1, :10] = logits[1, 0]  # ties at the cutoff are all kept
    want = np.asarray(J.nucleus_filter(jnp.asarray(logits), top_p))
    got = P.nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_generate_limits_and_reproducibility():
    pc, sd = _port("gpt2")
    prompt = _ids(T=4, seed=6)
    greedy = P.greedy_generate(pc, sd, prompt, 4)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    # temperature 0 and top_k=1 are greedy
    torch.testing.assert_close(P.sample_generate(pc, sd, prompt, 4, gen(7), temperature=0.0),
                               greedy)
    torch.testing.assert_close(P.sample_generate(pc, sd, prompt, 4, gen(7), temperature=2.0,
                                                 top_k=1), greedy)
    # the same seed gives the same rollout, another seed another one
    a = P.sample_generate(pc, sd, prompt, 8, gen(7), temperature=5.0)
    b = P.sample_generate(pc, sd, prompt, 8, gen(7), temperature=5.0)
    c = P.sample_generate(pc, sd, prompt, 8, gen(8), temperature=5.0)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    # a tiny top_p keeps only the top token: greedy again
    torch.testing.assert_close(P.sample_generate(pc, sd, prompt, 4, gen(9), temperature=1.0,
                                                 top_p=1e-6), greedy)
    with pytest.raises(ValueError, match="temperature"):
        P.sample_generate(pc, sd, prompt, 4, gen(7), temperature=-1.0)
    with pytest.raises(ValueError, match="top_p"):
        P.sample_generate(pc, sd, prompt, 4, gen(7), top_p=0.0)


def test_generate_bounds_and_zero_tokens():
    pc, sd = _port("gpt2")
    prompt = np.ones((1, 4), np.int32)
    np.testing.assert_array_equal(P.greedy_generate(pc, sd, prompt, 0).numpy(), prompt)
    with pytest.raises(ValueError, match="exceeds max_position_embeddings"):
        P.greedy_generate(pc, sd, prompt, pc.max_position_embeddings)
    with pytest.raises(ValueError, match="draft_len slack"):
        P.lookup_generate(pc, sd, prompt, 26, draft_len=3)
    with pytest.raises(ValueError, match="rolling_kv_cache"):
        P.lookup_generate(P.GPTConfig(**KW, sliding_window=4, rolling_kv_cache=True), sd,
                          prompt, 4)
    with pytest.raises(ValueError, match="num_beams"):
        P.beam_generate(pc, sd, prompt, 4, num_beams=0)
    with pytest.raises(KeyError, match="missing"):
        P.greedy_generate(pc, {k: v for k, v in sd.items() if k != "ln_f.bias"}, prompt, 2)


def test_int8_weights_decode_the_jax_tokens():
    """``quantize_params`` on both sides (the same q and scales, transposed:
    ``tests/test_torch_quant.py``), then greedy decode: equal tokens."""
    from tensorflowonspark_tpu.ops import quantize_params as jax_quantize
    from tensorflowonspark_tpu_torch.ops import quantize_params

    jc, _ = _cfgs("llama")
    pc, sd = _port("llama")
    prompt = _ids(T=5, seed=7)
    want = np.asarray(greedy(jc, jax_quantize(_flax_params("llama")),
                                        jnp.asarray(prompt), 8))
    got = P.greedy_generate(pc, quantize_params(sd), prompt, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_int4_weights_decode_as_their_dequantized_weights():
    """Packed int4 weights, dequantized at each call, decode the tokens of
    the same weights dequantized up front (the unpack is exact: the JAX
    package's dequantized values, ``tests/test_torch_quant.py``)."""
    from tensorflowonspark_tpu_torch.ops import quantize_params
    from tensorflowonspark_tpu_torch.ops.quant import _QuantArray

    pc, sd = _port("llama")
    q4 = quantize_params(sd, bits=4)
    dense = {n: v.dequantize() if isinstance(v, _QuantArray) else v for n, v in q4.items()}
    prompt = _ids(T=5, seed=7)
    torch.testing.assert_close(P.greedy_generate(pc, q4, prompt, 8),
                               P.greedy_generate(pc, dense, prompt, 8))


def test_bench_gpt_decode_reports_every_variant_at_a_tiny_size():
    """``bench_gpt_decode.bench`` rehearsed on the CPU at a tiny config:
    the JSON line's keys, every variant measured (no key missing)."""
    from tensorflowonspark_tpu_torch import bench_gpt_decode

    cfg = bench_gpt_decode.decode_config(vocab_size=97, hidden_size=32, num_layers=2,
                                         num_heads=4, intermediate_size=64,
                                         max_position_embeddings=64)
    out = bench_gpt_decode.bench(cfg=cfg, device="cpu", batch=2, prompt_len=16, new_tokens=8,
                                 iters=1)
    for key in ("tokens_per_sec", "ms_per_token_batch", "int8_tokens_per_sec", "int8_vs_bf16",
                "int8_kv_tokens_per_sec", "lookup_tokens_per_sec",
                "lookup_vs_greedy_repetitive"):
        assert out[key] > 0, key
    assert out["device"] == "cpu" and 1 <= out["lookup_forwards"] <= 8
