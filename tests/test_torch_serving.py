"""The port's continuous batcher (``models/serving.py``): the JAX package's
token streams, and the output contract of ``tests/test_serving.py``.

Cross-package: flax weights carried over by ``params_from_flax``
(``tests/test_torch_gpt.py``'s tiny gpt2- and llama-class configs, float32),
one staggered schedule through the JAX ``ContinuousBatcher`` and the
port's, dense and paged with a prefix hit: equal token streams.

The contracts, against the port's own solo ``greedy_generate`` (the oracle
of every greedy request) on a tiny float32 model whose weights are drawn
wider than the init (kernels N(0, 0.3²)), so rollouts move: admission order,
slot reuse and batch company never change a request's tokens.  Sampling
cannot reproduce JAX's random stream; it is held to the JAX tests'
properties (deterministic, independent of company, greedy at a tiny
top_p).  The speculative, block, draft, paged and handoff cases are in
``tests/test_torch_serving_spec.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import gpt as P
from tensorflowonspark_tpu_torch.models import serving as S
from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher


def _params(cfg, seed=0):
    """A state dict drawn with numpy from ``seed``: kernels and tables
    N(0, 0.3²), norm scales 1 + N(0, 0.1²), biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in P.init_params(cfg, 0).items():
        if name.endswith("bias"):
            a = 0.1 * rng.standard_normal(t.shape)
        elif ".ln" in name or name.startswith("ln_f"):
            a = 1 + 0.1 * rng.standard_normal(t.shape)
        else:
            a = 0.3 * rng.standard_normal(t.shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _make(pos_encoding="rope", seed=0, **kw):
    cfg = P.GPTConfig(**{**dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
                                intermediate_size=64, max_position_embeddings=48,
                                dtype=torch.float32, pos_encoding=pos_encoding), **kw})
    return cfg, _params(cfg, seed)


def _oracle(cfg, params, prompt, n):
    out = P.greedy_generate(cfg, params, np.asarray(prompt)[None, :], n)
    return out.numpy()[0, len(prompt):]


def _rand(rng, cfg, t):
    return rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32)


def _drive(b, schedule):
    """Submit ``(at_step, prompt, budget)`` entries as the step count
    reaches them, step until all finish; returns the token streams in
    schedule order."""
    rids, steps, todo = [], 0, sorted(schedule, key=lambda e: e[0])
    while todo or b.load()["total"]:
        while todo and todo[0][0] <= steps:
            _, p, n = todo.pop(0)
            rids.append(b.submit(p, n))
        b.step()
        steps += 1
    res = b.run()
    return [np.asarray(res[r]) for r in rids]


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("arch", ["gpt2", "llama"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_token_streams_equal_the_jax_batcher(arch, paged):
    """The same schedule (staggered arrivals, several buckets, a shared
    16-token prefix that later admissions hit in paged mode) through the
    JAX batcher and the port's, on the same weights: equal streams."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models.serving import ContinuousBatcher as JaxBatcher
    from tests.test_torch_gpt import _cfgs, _flax_params, _port

    jc, _ = _cfgs(arch)
    pc, sd = _port(arch)
    params = _flax_params(arch)
    rng = np.random.default_rng(3)
    pre = _rand(rng, pc, 16)
    schedule = [(0, np.concatenate([pre, _rand(rng, pc, 3)]), 6),
                (0, _rand(rng, pc, 5), 9),
                (2, _rand(rng, pc, 3), 4),
                (6, np.concatenate([pre, _rand(rng, pc, 2)]), 7),
                (7, _rand(rng, pc, 6), 5)]
    kw = {"kv_page_tokens": 8} if paged else {}
    jb = JaxBatcher(jc, params, max_batch=2, **kw)
    pb = ContinuousBatcher(pc, sd, max_batch=2, **kw)
    want = _drive(jb, schedule)
    got = _drive(pb, schedule)
    assert jnp.asarray(want[0]).size == 6
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    if paged:
        assert pb.prefix_stats()["hit"] == jb.prefix_stats()["hit"] >= 1
    assert len(set(np.concatenate(want))) > 3          # rollouts that move


def test_rewind_cache_takes_per_row_positions_as_the_jax_one():
    """``rewind_cache`` on a per-row cache with a ``[B]`` position vector
    sets each row's counters, as the JAX package's ``jnp.full_like``."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import gpt as J
    from tests.test_torch_gpt import _cfgs, _flax_params, _port

    jc, _ = _cfgs("gpt2", per_row_positions=True)
    pc, sd = _port("gpt2", per_row_positions=True)
    want = J.rewind_cache(J.init_cache(jc, _flax_params("gpt2"), 2), jnp.asarray([3, 5]))
    got = P.rewind_cache(P.init_cache(pc, sd, 2), torch.tensor([3, 5]))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for i, lc in enumerate(got["layers"]):
        np.testing.assert_array_equal(
            lc["index"].numpy(), np.asarray(want[f"layer_{i}"]["attn"]["index"]))
    P.rewind_cache(got, np.asarray([7, 2]))
    assert got["pos"].tolist() == [7, 2]
    P.rewind_cache(got, 4)
    assert all(lc["index"].tolist() == [4, 4] for lc in got["layers"])


# ------------------------------------------------------------- contracts

@pytest.mark.parametrize("pos_encoding", ["rope", "learned"])
def test_staggered_requests_match_solo_greedy(pos_encoding):
    """More requests than slots, different prompt lengths and budgets:
    every request's tokens equal its solo greedy run."""
    cfg, params = _make(pos_encoding)
    rng = np.random.default_rng(0)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 7), (3, 12), (8, 4), (5, 9), (2, 6),
                                                  (6, 1))]
    b = ContinuousBatcher(cfg, params, max_batch=2)
    rids = [b.submit(p, n) for p, n in reqs]
    results = b.run()
    assert sorted(results) == sorted(rids)
    for rid, (prompt, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, prompt, n))


def test_unload_load_params_keeps_exactness():
    """The warm-standby posture: unload drops the weights and keeps the
    callables and the cache; a reloaded host (numpy) tree decodes the same
    tokens.  Submitting while weightless raises; unloading with live work
    refuses; a tree of another shape bounces."""
    cfg, params = _make()
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    b = ContinuousBatcher(cfg, params, max_batch=2)
    rid = b.submit(prompt, 6)
    with pytest.raises(RuntimeError, match="live requests"):
        b.unload_params()
    want = b.run()[rid]
    b.unload_params()
    assert b.params is None
    with pytest.raises(RuntimeError, match="no parameters"):
        b.submit(prompt, 2)
    with pytest.raises(ValueError):
        b.load_params(None)
    with pytest.raises(ValueError, match="shape/dtype"):
        b.load_params({**params, "ln_f.bias": torch.zeros(33)})
    with pytest.raises(ValueError, match="names differ"):
        b.load_params({k: v for k, v in params.items() if k != "ln_f.bias"})
    b.load_params({k: v.numpy() for k, v in params.items()})
    rid2 = b.submit(prompt, 6)
    np.testing.assert_array_equal(b.run()[rid2], want)
    np.testing.assert_array_equal(want, _oracle(cfg, params, prompt, 6))


def test_load_params_drops_stale_prefix_cache():
    """Paged mode: a parameter swap rebuilds the prefix index empty —
    cached pages hold K/V of the OLD weights."""
    cfg, params = _make()
    prompt = np.arange(1, 25, dtype=np.int32)
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    rid = b.submit(prompt, 4)
    b.run()
    b.result(rid, pop=True)
    assert b.prefix_stats()["cached_pages"] > 0
    b.unload_params()
    params2 = _params(cfg, seed=7)
    b.load_params(params2)
    assert b.prefix_stats()["cached_pages"] == 0
    rid2 = b.submit(prompt, 4)
    out = b.run()[rid2]
    assert b.prefix_stats()["hit"] == 0, "stale prefix page was reused"
    np.testing.assert_array_equal(out, _oracle(cfg, params2, prompt, 4))


def test_mid_flight_admission_does_not_disturb_running_slots():
    cfg, params = _make()
    rng = np.random.default_rng(1)
    p1, p2 = _rand(rng, cfg, 4), _rand(rng, cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=2)
    r1 = b.submit(p1, 10)
    for _ in range(4):
        b.step()
    r2 = b.submit(p2, 5)
    results = b.run()
    np.testing.assert_array_equal(results[r1], _oracle(cfg, params, p1, 10))
    np.testing.assert_array_equal(results[r2], _oracle(cfg, params, p2, 5))


def test_eos_frees_slot_early_and_slot_reuse_is_clean():
    """A request stopping at eos releases its slot; the slot's next tenant
    is unaffected by the leftover cache rows."""
    cfg, params = _make()
    rng = np.random.default_rng(2)
    p1 = _rand(rng, cfg, 5)
    oracle1 = _oracle(cfg, params, p1, 10)
    eos = int(oracle1[2])
    p2 = _rand(rng, cfg, 4)
    b = ContinuousBatcher(cfg, params, max_batch=1, eos_id=eos)
    r1 = b.submit(p1, 10)
    r2 = b.submit(p2, 6)
    results = b.run()
    first = list(oracle1).index(eos)
    np.testing.assert_array_equal(results[r1], oracle1[:first + 1])
    assert len(results[r1]) < len(oracle1), "eos did not stop early"
    want2 = _oracle(cfg, params, p2, 6)
    if eos in want2:
        want2 = want2[:list(want2).index(eos) + 1]
    np.testing.assert_array_equal(results[r2], want2)


def test_single_step_budget_and_validation():
    cfg, params = _make()
    with pytest.raises(ValueError, match="max_batch"):
        ContinuousBatcher(cfg, params, max_batch=0)
    with pytest.raises(ValueError, match="rolling_kv_cache"):
        ContinuousBatcher(dataclasses.replace(cfg, sliding_window=8, rolling_kv_cache=True),
                          params, max_batch=2)
    b = ContinuousBatcher(cfg, params, max_batch=2)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit(np.array([], np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit(np.array([1, 2], np.int32), 0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        b.submit(np.arange(40, dtype=np.int32), 20)
    rid = b.submit(np.array([1, 2, 3], np.int32), 1)  # 1-token budget
    assert b.step() == [rid]          # finished AT admission, still reported
    np.testing.assert_array_equal(b.run()[rid], _oracle(cfg, params, [1, 2, 3], 1))


def test_has_free_slot_counts_pending():
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=2)
    n = 0
    while b.has_free_slot():
        b.submit(np.array([1, 2], np.int32), 3)
        n += 1
        assert n <= 2, "has_free_slot ignored the pending queue"
    assert n == 2


def test_one_decode_callable_for_the_lifetime():
    """The decode step is built once and never rebuilt across admissions
    and retirements."""
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=2)
    step0 = b._step
    for p, n in (([1, 2], 3), ([3, 4, 5], 8), ([6], 4)):
        b.submit(np.asarray(p, np.int32), n)
    b.run()
    assert b._step is step0 and b._built[("step",)] == 1
    assert all(v == 1 for v in b._built.values()), b._built


def _variant(variant):
    kw = {"gqa": {"num_kv_heads": 2}, "window": {"sliding_window": 8}}.get(variant, {})
    cfg, params = _make("rope", **kw)
    if variant in ("int8", "int4"):
        from tensorflowonspark_tpu_torch.ops import quantize_params

        params = quantize_params(params, bits=4 if variant == "int4" else 8)
    return cfg, params


@pytest.mark.parametrize("variant", ["int8", "int4", "gqa", "window"])
def test_serving_composes_with_decode_features(variant):
    cfg, params = _variant(variant)
    rng = np.random.default_rng(3)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((4, 6), (7, 9), (3, 5))]
    b = ContinuousBatcher(cfg, params, max_batch=2)
    rids = [b.submit(p, n) for p, n in reqs]
    results = b.run()
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))


def test_sampling_deterministic_and_company_independent():
    """A sampled request's tokens are a pure function of (seed, temp,
    top_p) — the same alone or beside greedy neighbours after slot churn —
    and the neighbours stay greedy-exact; another seed changes them."""
    cfg, params = _make()
    rng = np.random.default_rng(5)
    p, pg = _rand(rng, cfg, 5), _rand(rng, cfg, 4)

    def sampled_run(extra_greedy, seed=123, max_batch=2):
        b = ContinuousBatcher(cfg, params, max_batch=max_batch)
        rid = b.submit(p, 9, temperature=0.8, top_p=0.9, seed=seed)
        gids = [b.submit(pg, n) for n in extra_greedy]
        res = b.run()
        return res[rid], [res[g] for g in gids]

    alone, _ = sampled_run([])
    with_company, greedy_outs = sampled_run([6, 3, 7])
    np.testing.assert_array_equal(alone, with_company)
    for g in greedy_outs:
        np.testing.assert_array_equal(g, _oracle(cfg, params, pg, len(g)))
    other, _ = sampled_run([], seed=124, max_batch=1)
    assert not np.array_equal(alone, other)
    assert not np.array_equal(alone, _oracle(cfg, params, p, 9))   # it does sample


def test_tiny_top_p_equals_greedy():
    cfg, params = _make()
    p = _rand(np.random.default_rng(6), cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=1)
    rid = b.submit(p, 8, temperature=1.3, top_p=1e-6, seed=7)
    np.testing.assert_array_equal(b.run()[rid], _oracle(cfg, params, p, 8))


@pytest.mark.parametrize("bad, match", [({"temperature": -0.1}, "temperature"),
                                        ({"top_p": 0.0}, "top_p"), ({"top_p": 1.5}, "top_p"),
                                        ({"temperature": 0.5, "seed": 2**35}, "seed")])
def test_sampling_validation(bad, match):
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=1)
    with pytest.raises(ValueError, match=match):
        b.submit(np.array([1], np.int32), 2, **bad)


def test_batcher_nucleus_is_sample_generates_filter():
    """The batcher and ``sample_generate`` share one ``nucleus_filter``;
    on a tied distribution it keeps the top token and both tied ones."""
    assert S.nucleus_filter is P.nucleus_filter
    out = S.nucleus_filter(torch.tensor([3.0, 2.0, 2.0, 0.0, -1.0]), 0.75)
    assert torch.isfinite(out[:3]).all() and torch.isneginf(out[3:]).all()


def test_gumbel_noise_is_a_pure_function_of_seed_and_step():
    """The sampler's noise: the same (seed, step) gives the same bits in
    any row and batch, another seed or step other bits; the uniforms it
    comes from lie in (0, 1) and spread."""
    seeds, steps = torch.tensor([5, 5, 6, -3]), torch.tensor([0, 0, 0, 2**31 - 1])
    g = S._gumbel(seeds, steps, 1000)
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.equal(S._gumbel(seeds[2:3], steps[2:3], 1000)[0], g[2])
    assert torch.isfinite(g).all()
    u = torch.exp(-torch.exp(-g))
    assert 0.4 < u.mean().item() < 0.6 and u.std().item() > 0.25


def test_prefill_bucketing_is_exact_and_bounds_the_registry():
    """Right-padded power-of-two buckets: every prompt length in 3..9 stays
    greedy-exact, and the prefill registry holds one entry per (bucket,
    group size): (3,4) -> bucket 4 group 2, (5,6) and (7,8) -> bucket 8
    group 2 (reused), 9 -> bucket 16 alone."""
    cfg, params = _make()
    rng = np.random.default_rng(8)
    b = ContinuousBatcher(cfg, params, max_batch=2)
    reqs = [(_rand(rng, cfg, t), 6) for t in range(3, 10)]
    rids = [b.submit(p, n) for p, n in reqs]
    results = b.run()
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))
    assert {k for k in b._prefill_jit if k[0] == "final"} \
        == {("final", 4, 2), ("final", 8, 2), ("final", 16, 1)}, sorted(map(str, b._prefill_jit))


@pytest.mark.parametrize("pos_encoding", ["rope", "learned"])
def test_chunked_prefill_matches_whole(pos_encoding):
    cfg, params = _make(pos_encoding)
    rng = np.random.default_rng(9)
    b = ContinuousBatcher(cfg, params, max_batch=2, prefill_chunk=6)
    reqs = [(_rand(rng, cfg, t), 5) for t in (20, 23, 4)]   # 4 <= chunk: whole
    rids = [b.submit(p, n) for p, n in reqs]
    results = b.run()
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))
    keys = set(b._prefill_jit)
    assert ("chunk", 6) in keys
    assert {k for k in keys if k[0] == "final"} \
        == {("final", 2, 1), ("final", 8, 1), ("final", 4, 1)}


def test_failed_step_poisons_the_batcher():
    """A failure mid-step leaves the in-place cache untrustworthy: the
    batcher refuses further use, naming the original failure."""
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=2)
    b.submit(np.asarray([1, 2, 3], np.int32), 5)
    b.step()

    def raising_step(cache, tokens):
        raise RuntimeError("CUDA error: synthetic device OOM")

    b._step = raising_step
    with pytest.raises(RuntimeError, match="synthetic device OOM"):
        b.step()
    for call in (b.step, b.run, lambda: b.submit([1], 1)):
        with pytest.raises(RuntimeError, match="unusable(.|\n)*synthetic"):
            call()


def test_burst_admission_shares_one_prefill_dispatch():
    cfg, params = _make()
    rng = np.random.default_rng(11)
    b = ContinuousBatcher(cfg, params, max_batch=8)
    calls = []
    orig = b._prefill_final
    b._prefill_final = lambda *a: calls.append(1) or orig(*a)
    reqs = [(_rand(rng, cfg, 5), n) for n in (4, 6, 3, 5, 7, 4, 6, 5)]
    rids = [b.submit(p, n) for p, n in reqs]
    results = b.run()
    assert len(calls) == 1, f"expected one batched prefill, got {len(calls)}"
    assert set(b._prefill_jit) >= {("final", 8, 8), ("scatter", 8)}
    assert b.prefill_dispatches == 1
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))


def test_group_padding_rows_never_land():
    """A group of 3 pads to 4 prefill rows beside a live slot: the
    admission writes the three target slots and nothing else (the pad row
    is copied nowhere, the live and idle rows keep their bits), and every
    request remains greedy-exact."""
    cfg, params = _make()
    rng = np.random.default_rng(12)
    b = ContinuousBatcher(cfg, params, max_batch=8)
    early_p = _rand(rng, cfg, 6)
    early = b.submit(early_p, 10)
    b.step()
    reqs = [(_rand(rng, cfg, 5), n) for n in (4, 5, 6)]
    rids = [b.submit(p, n) for p, n in reqs]
    before = [{n: t.clone() for n, t in lc.items()} for lc in b.cache["layers"]]
    with torch.no_grad():
        b._admit()
    assert ("final", 8, 4) in b._prefill_jit
    seated = {i for i, s in enumerate(b.slots) if s is not None and s.request_id in rids}
    assert len(seated) == 3
    for lc, old in zip(b.cache["layers"], before):
        for name, t in lc.items():
            for i in set(range(8)) - seated:
                assert torch.equal(t[i], old[name][i]), f"row {i} of {name} was written"
    results = b.run()
    np.testing.assert_array_equal(results[early], _oracle(cfg, params, early_p, 10))
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))


def test_chunked_admission_is_time_sliced():
    """A long (chunked) prompt does not stall running slots: each step
    advances it one chunk while active requests decode, its slot stays
    reserved until the final chunk lands, and both stay greedy-exact."""
    cfg, params = _make()
    rng = np.random.default_rng(13)
    b = ContinuousBatcher(cfg, params, max_batch=2, prefill_chunk=4)
    short = _rand(rng, cfg, 3)
    r1 = b.submit(short, 20)
    b.step()
    slot1 = next(i for i, s in enumerate(b.slots) if s is not None)
    long_p = _rand(rng, cfg, 18)
    r2 = b.submit(long_p, 5)                  # 18 > 4: 4 chunks + the final
    for _ in range(4):
        n_before = len(b.slots[slot1].tokens)
        b.step()
        assert b._inflight is not None and b._reserved
        assert len(b.slots[slot1].tokens) == n_before + 1, "running slot stalled"
    b.step()
    assert b._inflight is None and not b._reserved
    results = b.run()
    np.testing.assert_array_equal(results[r1], _oracle(cfg, params, short, 20))
    np.testing.assert_array_equal(results[r2], _oracle(cfg, params, long_p, 5))


def test_short_requests_bypass_blocked_chunked_head():
    cfg, params = _make()
    rng = np.random.default_rng(14)
    b = ContinuousBatcher(cfg, params, max_batch=3, prefill_chunk=4)
    longs = [_rand(rng, cfg, t) for t in (18, 14)]
    shorts = [_rand(rng, cfg, 3) for _ in range(2)]
    r_l = [b.submit(p, 5) for p in longs]
    r_s = [b.submit(p, 8) for p in shorts]
    b.step()
    assert b._inflight is not None
    assert set(r_s) <= {s.request_id for s in b.slots if s is not None}
    results = b.run()
    for rid, (p, n) in zip(r_l + r_s, [(p, 5) for p in longs] + [(p, 8) for p in shorts]):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n))


@pytest.mark.parametrize("kw", [{}, {"decode_block_steps": 8}, {"speculative_k": 3},
                                {"prefill_chunk": 4}, {"kv_page_tokens": 8}],
                         ids=["plain", "block", "speculative", "chunked", "paged"])
def test_on_token_streams_exactly_the_oracle(kw):
    """``submit(on_token=...)`` streams the solo oracle's tokens in order
    under every regime; discarded block/draft tokens never surface."""
    cfg, params = _make()
    rng = np.random.default_rng(30)
    streamed: dict = {}
    b = ContinuousBatcher(cfg, params, max_batch=2, **kw)
    reqs = [(np.tile(np.asarray([7, 11, 23], np.int32), 5), 10), (_rand(rng, cfg, 6), 7),
            (_rand(rng, cfg, 3), 1)]
    rids = [b.submit(p, n, on_token=lambda r, t: streamed.setdefault(r, []).append(t))
            for p, n in reqs]
    results = b.run()
    for rid, (p, n) in zip(rids, reqs):
        oracle = _oracle(cfg, params, p, n).tolist()
        assert streamed[rid] == oracle == results[rid].tolist(), f"stream diverged ({kw})"
    assert not b._on_token, "finished requests must drop their callbacks"


def test_on_token_fires_before_finish_and_with_eos():
    cfg, params = _make()
    p = _rand(np.random.default_rng(32), cfg, 5)
    oracle = _oracle(cfg, params, p, 6)
    streamed: list = []
    b = ContinuousBatcher(cfg, params, max_batch=1)
    rid = b.submit(p, 6, on_token=lambda r, t: streamed.append((r, t)))
    b.step()
    early = [t for r, t in streamed if r == rid]
    assert early == oracle[:len(early)].tolist() and 0 < len(early) < 6
    assert b.result(rid) is None, "tokens must stream BEFORE finish"
    results = b.run()
    assert [t for _, t in streamed] == results[rid].tolist() == oracle.tolist()
    eos = int(oracle[0])
    streamed2: list = []
    b2 = ContinuousBatcher(cfg, params, max_batch=1, eos_id=eos)
    rid2 = b2.submit(p, 10, on_token=lambda r, t: streamed2.append(t))
    res2 = b2.run()[rid2]
    want = _oracle(cfg, params, p, 10)
    assert streamed2 == res2.tolist() == want[:list(want).index(eos) + 1].tolist()


def test_load_counts_every_live_request_once():
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=2, prefill_chunk=4)
    idle = {"active": 0, "pending": 0, "reserved": 0, "total": 0, "free_pages": 0,
            "total_pages": 0}
    assert b.load() == idle
    rng = np.random.default_rng(31)
    for t, n in ((3, 6), (18, 5), (4, 6)):
        b.submit(_rand(rng, cfg, t), n)
    assert b.load() == {**idle, "pending": 3, "total": 3}
    b.step()
    load = b.load()
    assert load["total"] == 3 and load["active"] >= 1 and load["reserved"] == 1, load
    b.run()
    assert b.load() == idle


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_fuzz_random_schedules_stay_greedy_exact(seed):
    """Random submit/step interleavings, prompt lengths (short, bucketed,
    chunked), budgets, slot counts, speculation or blocks, dense or paged:
    every request equals its solo greedy oracle."""
    cfg, params = _make()
    rng = np.random.default_rng(seed)
    spec = int(rng.integers(0, 2))
    block = None if spec else [None, 4, 8][int(rng.integers(0, 3))]
    b = ContinuousBatcher(cfg, params, max_batch=int(rng.integers(1, 5)),
                          prefill_chunk=int(rng.integers(4, 9)),
                          speculative_k=3 if spec else None, decode_block_steps=block,
                          kv_page_tokens=8 if seed % 2 else None)
    reqs, rids = [], []
    n_req = int(rng.integers(4, 9))
    while len(reqs) < n_req:
        if rng.random() < 0.5:
            t = int(rng.integers(2, 20))
            p = (np.tile(_rand(rng, cfg, 2), (t + 1) // 2)[:t] if rng.random() < 0.4
                 else _rand(rng, cfg, t))
            n = int(rng.integers(1, 9))
            reqs.append((p, n))
            rids.append(b.submit(p, n))
        for _ in range(int(rng.integers(1, 4))):
            b.step()
    results = b.run()
    for rid, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(results[rid], _oracle(cfg, params, p, n),
                                      err_msg=f"seed={seed} spec={spec} rid={rid}")
