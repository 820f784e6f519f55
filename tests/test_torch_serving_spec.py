"""The port's continuous batcher beyond one token a step, and its paged and
handoff machinery (``models/serving.py``), held to the contracts of the JAX
package's ``tests/test_serving.py`` and ``tests/test_spec_draft.py``:
speculative verify (prompt lookup and ``DraftModel``), decode blocks, the
paged pool with its prefix cache (hits, exhaustion, eviction, oversize
rejection), and the serving tier's hooks (session handoff and adoption,
parameter unload/load, ``set_role``, prefix-cache export and import).

Every greedy request equals its solo ``greedy_generate``; sampled ones are
held to the plain batcher's tokens.  The compile-site cache (CUDA graphs)
is held in ``tests/test_torch_serving_aot.py``; the tp-sharded cases in
``tests/test_torch_sharded_serving.py``.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, DraftModel
from tests.test_torch_serving import _make, _oracle, _params, _rand, _variant


def _run(b, reqs):
    rids = [b.submit(p, n) for p, n in reqs]
    res = b.run()
    return [res[r] for r in rids]


def _assert_oracle(cfg, params, got, reqs):
    for g, (p, n) in zip(got, reqs):
        np.testing.assert_array_equal(g, _oracle(cfg, params, p, n))


# --------------------------------------------------------- speculative verify

def test_speculative_batcher_greedy_exact_and_accepts():
    """Repetitive prompts (lookup hits) and novel ones stay greedy-exact,
    per-row acceptance fires, and committed tokens outrun one a call."""
    cfg, params = _make()
    rng = np.random.default_rng(15)
    reqs = [(np.tile(np.asarray([7, 11, 23], np.int32), 5), 12), (_rand(rng, cfg, 6), 9)]
    b = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=4)
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    assert b.spec_proposed > 0 and b.spec_accepted > 0
    assert b.decode_dispatches < 21


@pytest.mark.parametrize("variant", ["plain", "int8", "int4", "gqa", "window"])
def test_speculative_matches_solo_under_decode_features(variant):
    """Staggered mixed-length repetitive requests through the verify path,
    also under quantized weights, grouped-query attention and a sliding
    window: equal to the solo oracle, with acceptance."""
    cfg, params = _variant(variant) if variant != "plain" else _make()
    rng = np.random.default_rng(24)
    reqs = [(np.tile(_rand(rng, cfg, 3), 4), n) for n in (12, 16, 10)]
    b = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=3)
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    assert b.spec_accepted > 0


def test_speculative_eos_truncation():
    """An accepted draft holding eos truncates where solo greedy stops."""
    cfg, params = _make()
    p = np.tile(_rand(np.random.default_rng(17), cfg, 3), 4)
    oracle = _oracle(cfg, params, p, 12)
    eos = int(oracle[4])
    b = ContinuousBatcher(cfg, params, max_batch=1, eos_id=eos, speculative_k=4)
    [got] = _run(b, [(p, 12)])
    np.testing.assert_array_equal(got, oracle[:list(oracle).index(eos) + 1])


@pytest.mark.parametrize("proposer", ["lookup", "draft"])
def test_speculative_composes_with_sampling(proposer):
    """Sampled slots draft nothing and give the plain sampling batcher's
    tokens (a pure function of their own parameters); greedy neighbours
    stay exact."""
    cfg, params = _make()
    rep = np.tile(np.asarray([5, 9], np.int32), 6)
    nov = _rand(np.random.default_rng(18), cfg, 5)

    def run(spec):
        b = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=4 if spec else None)
        if spec and proposer == "draft":
            b.set_draft(DraftModel(cfg, params, window=16))
        r_greedy = b.submit(rep, 10)
        r_samp = b.submit(nov, 8, temperature=0.9, top_p=0.8, seed=42)
        res = b.run()
        return res[r_greedy], res[r_samp]

    g_spec, s_spec = run(True)
    g_plain, s_plain = run(False)
    np.testing.assert_array_equal(g_spec, g_plain)
    np.testing.assert_array_equal(s_spec, s_plain)
    np.testing.assert_array_equal(g_plain, _oracle(cfg, params, rep, 10))


# ---------------------------------------------------------------- draft model

def test_draft_greedy_exact_and_accepts():
    """A same-weights draft agrees with the target: total acceptance,
    oracle-exact outputs, more than one token a decode call."""
    cfg, params = _make()
    rng = np.random.default_rng(30)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 12), (3, 10))]
    b = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=4)
    b.set_draft(DraftModel(cfg, params, window=16))
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    assert b.draft_dispatches > 0 and b.draft_dispatches == b._draft_model.dispatches
    assert b.spec_proposed > 0 and b.spec_accepted == b.spec_proposed
    assert b.decode_dispatches < 12


def test_divergent_draft_stays_oracle_exact_and_drains_accept_lens():
    """A 1-layer draft of other weights mispredicts; the verify corrects it
    token for token.  The per-row accepted lengths drain once."""
    cfg, params = _make()
    dcfg, dparams = _make(seed=2, num_layers=1)
    p = _rand(np.random.default_rng(31), cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=1, speculative_k=4)
    b.set_draft(DraftModel(dcfg, dparams, window=16))
    [got] = _run(b, [(p, 14)])
    np.testing.assert_array_equal(got, _oracle(cfg, params, p, 14))
    assert 0 < b.spec_proposed and b.spec_accepted < b.spec_proposed
    lens = b.take_spec_accept_lens()
    assert lens and all(isinstance(n, int) and 0 <= n <= 4 for n in lens)
    assert sum(lens) == b.spec_accepted and b.take_spec_accept_lens() == []


def test_draft_composes_with_paged_prefix_cache():
    cfg, params = _make()
    rng = np.random.default_rng(33)
    sys_p = _rand(rng, cfg, 8)
    reqs = [(np.concatenate([sys_p, _rand(rng, cfg, 3)]), 8) for _ in range(3)]
    b = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=4, kv_page_tokens=8)
    b.set_draft(DraftModel(cfg, params, window=16))
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    assert b.spec_accepted > 0 and b.prefix_stats()["hit"] >= 1


def test_set_draft_validation():
    cfg, params = _make()
    draft = DraftModel(cfg, params, window=16)
    with pytest.raises(ValueError, match="speculative_k"):
        ContinuousBatcher(cfg, params, max_batch=1).set_draft(draft)
    b = ContinuousBatcher(cfg, params, max_batch=1, speculative_k=4)
    with pytest.raises(TypeError):
        b.set_draft(object())
    cfg2, params2 = _make(vocab_size=37)
    with pytest.raises(ValueError, match="vocab"):
        b.set_draft(DraftModel(cfg2, params2, window=16))
    with pytest.raises(ValueError, match="window"):
        b.set_draft(DraftModel(cfg, params, window=46))      # 46 + 4 > 48
    with pytest.raises(ValueError):
        DraftModel(cfg, params, window=0)
    b.set_draft(draft)
    assert b._draft_model is draft
    b.set_draft(None)
    assert b._draft_model is None
    pf = ContinuousBatcher(cfg, params, max_batch=1, kv_page_tokens=8)
    pf.set_role("prefill")
    with pytest.raises(ValueError, match="prefill"):
        pf.set_draft(draft)


# -------------------------------------------------------------- decode blocks

def test_block_decode_matches_solo_and_amortizes():
    """``decode_block_steps``: the single steps' tokens across staggered
    budgets; one request of budget 33 decodes its 32 steps in a handful of
    calls."""
    cfg, params = _make()
    rng = np.random.default_rng(7)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 16), (3, 9), (8, 4), (2, 13))]
    b = ContinuousBatcher(cfg, params, max_batch=2, decode_block_steps=8)
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    p = np.arange(4, dtype=np.int32) + 1
    b = ContinuousBatcher(cfg, params, max_batch=2, decode_block_steps=8)
    [got] = _run(b, [(p, 33)])
    np.testing.assert_array_equal(got, _oracle(cfg, params, p, 33))
    assert b.decode_steps == 32 and b.decode_dispatches <= 6, b.decode_dispatches


def test_block_decode_sampled_rows_match_per_step():
    """Sampled requests under blocks: the per-step batcher's tokens (the
    in-block step counter lines up)."""
    cfg, params = _make()
    rng = np.random.default_rng(9)
    p1, p2 = _rand(rng, cfg, 5), _rand(rng, cfg, 3)

    def drive(block):
        b = ContinuousBatcher(cfg, params, max_batch=2, decode_block_steps=block)
        r1 = b.submit(p1, 12, temperature=0.8, top_p=0.9, seed=11)
        r2 = b.submit(p2, 7)
        out = b.run()
        return out[r1], out[r2]

    a1, a2 = drive(None)
    b1, b2 = drive(8)
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)
    np.testing.assert_array_equal(b2, _oracle(cfg, params, p2, 7))


def test_block_decode_eos_truncates_and_slot_reuses():
    cfg, params = _make()
    p = np.arange(5, dtype=np.int32) + 1
    ref = _oracle(cfg, params, p, 24)
    eos = int(ref[2])
    b = ContinuousBatcher(cfg, params, max_batch=1, eos_id=eos, decode_block_steps=8)
    [got] = _run(b, [(p, 24)])
    np.testing.assert_array_equal(got, ref[:int(np.flatnonzero(ref == eos)[0]) + 1])
    p2 = np.arange(4, dtype=np.int32) + 2
    [got2] = _run(b, [(p2, 6)])
    ref2 = _oracle(cfg, params, p2, 6)
    cut = np.flatnonzero(ref2 == eos)
    np.testing.assert_array_equal(got2, ref2[:int(cut[0]) + 1] if cut.size else ref2)


def test_block_decode_admission_latency_policy():
    """With ``eos_id`` set a request that cannot admit forces single steps
    (an eos can free a slot any step); without eos, blocks up to the
    minimum remaining budget delay it by zero steps and are taken."""
    cfg, params = _make()
    rng = np.random.default_rng(3)
    p1, p2 = _rand(rng, cfg, 4), _rand(rng, cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=1, decode_block_steps=8,
                          eos_id=cfg.vocab_size + 1)          # never fires
    r1 = b.submit(p1, 20)
    b.step()
    steps_before = b.decode_steps
    r2 = b.submit(p2, 5)
    b.step()
    assert b.decode_steps - steps_before == 1
    out = b.run()
    np.testing.assert_array_equal(out[r1], _oracle(cfg, params, p1, 20))
    np.testing.assert_array_equal(out[r2], _oracle(cfg, params, p2, 5))
    b2 = ContinuousBatcher(cfg, params, max_batch=1, decode_block_steps=8)
    q1 = b2.submit(p1, 20)
    b2.step()
    q2 = b2.submit(p2, 5)
    b2.step()
    assert b2.decode_steps > b2.decode_dispatches
    out2 = b2.run()
    np.testing.assert_array_equal(out2[q1], _oracle(cfg, params, p1, 20))
    np.testing.assert_array_equal(out2[q2], _oracle(cfg, params, p2, 5))
    assert b2.decode_steps == 23 and b2.decode_dispatches < 12


@pytest.mark.parametrize("kw, match", [
    ({"decode_block_steps": 1}, "decode_block_steps"),
    ({"decode_block_steps": 4, "speculative_k": 2}, "mutually exclusive"),
    ({"speculative_k": 0}, "speculative_k"), ({"prefill_chunk": 0}, "prefill_chunk"),
    ({"kv_page_tokens": 6}, "power of two"), ({"kv_page_tokens": 32}, "divide"),
    ({"kv_pool_pages": 8}, "kv_page_tokens"),
    ({"kv_page_tokens": 8, "kv_pool_pages": 0}, "kv_pool_pages"),
    ({"prefill_only": True}, "kv_page_tokens"),
    ({"kv_page_tokens": 8, "prefill_only": True, "speculative_k": 2}, "decode-time")])
def test_constructor_validation(kw, match):
    cfg, params = _make()
    with pytest.raises(ValueError, match=match):
        ContinuousBatcher(cfg, params, max_batch=2, **kw)


def test_paged_rejects_int8_kv_cache():
    cfg, params = _make(kv_cache_int8=True)
    with pytest.raises(ValueError, match="kv_cache_int8"):
        ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)


# ------------------------------------------------------------------ paged KV

@pytest.mark.parametrize("pos_encoding", ["rope", "learned"])
def test_paged_matches_solo_greedy(pos_encoding):
    """The block-table pool instead of the dense cache: exact, and every
    page returned (free + cached = the pool)."""
    cfg, params = _make(pos_encoding)
    rng = np.random.default_rng(40)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 7), (3, 12), (8, 4), (9, 9), (2, 6),
                                                  (6, 1))]
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    _assert_oracle(cfg, params, _run(b, reqs), reqs)
    st = b.prefix_stats()
    assert st["free_pages"] == st["total_pages"], st


def test_paged_prefix_hit_skips_reprefill_and_stays_exact():
    """The first admission misses and indexes its full prompt pages; a
    prompt diverging mid-page shares only the pages before (copy-on-write)
    and the original still hits afterwards."""
    cfg, params = _make()
    rng = np.random.default_rng(41)
    A = np.concatenate([_rand(rng, cfg, 17), _rand(rng, cfg, 3)])
    B = A.copy()
    B[11] = (B[11] + 1) % cfg.vocab_size
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    [ra] = _run(b, [(A, 5)])
    assert b.prefix_stats()["miss"] == 1
    [rb] = _run(b, [(B, 5)])
    np.testing.assert_array_equal(rb, _oracle(cfg, params, B, 5))
    assert b.prefix_stats()["partial"] == 1
    [ra2] = _run(b, [(A, 5)])
    np.testing.assert_array_equal(ra2, _oracle(cfg, params, A, 5))
    np.testing.assert_array_equal(ra, ra2)
    assert b.prefix_stats()["hit"] == 1, b.prefix_stats()


def test_paged_exhaustion_backpressures_then_drains_exact():
    """A pool too small for the queue: admission blocks on pages, not
    slots; every request completes exact and the pool leaks nothing."""
    cfg, params = _make()
    rng = np.random.default_rng(42)
    b = ContinuousBatcher(cfg, params, max_batch=4, kv_page_tokens=8, kv_pool_pages=6)
    reqs = [(_rand(rng, cfg, 10), 20) for _ in range(3)]    # 4 pages each
    rids = [b.submit(p, n) for p, n in reqs]
    b.step()
    assert sum(s is not None for s in b.slots) == 1
    load = b.load()
    assert load["pending"] == 2 and load["total_pages"] == 6, load
    res = b.run()
    _assert_oracle(cfg, params, [res[r] for r in rids], reqs)
    st = b.prefix_stats()
    assert st["free_pages"] == st["total_pages"] == 6, st
    assert all(s is None for s in b.slots)


def test_paged_submit_rejects_requests_larger_than_the_pool():
    cfg, params = _make()
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, kv_pool_pages=3)
    with pytest.raises(ValueError, match="KV pages"):
        b.submit(np.arange(20, dtype=np.int32) % cfg.vocab_size, 10)
    p = np.arange(10, dtype=np.int32) % cfg.vocab_size
    [got] = _run(b, [(p, 10)])
    np.testing.assert_array_equal(got, _oracle(cfg, params, p, 10))


def test_paged_eviction_under_pressure_then_reprefill_exact():
    cfg, params = _make()
    rng = np.random.default_rng(43)
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, kv_pool_pages=8)
    A = _rand(rng, cfg, 17)
    _run(b, [(A, 4)])
    for _ in range(3):          # churn: evicts A's cached pages
        _run(b, [(_rand(rng, cfg, 20), 20)])
    assert b.prefix_stats()["evictions"] > 0
    [got] = _run(b, [(A, 4)])
    np.testing.assert_array_equal(got, _oracle(cfg, params, A, 4))


def test_paged_mixed_greedy_sampled_hit_and_miss_paths():
    """Greedy requests stay exact and a sampled one is the same function
    of (seed, temp, top_p) whether its prefix hits, misses, or the batcher
    is dense."""
    cfg, params = _make()
    rng = np.random.default_rng(44)
    pre = _rand(rng, cfg, 16)
    samp_p = np.concatenate([pre, _rand(rng, cfg, 4)])
    greedy_p = np.concatenate([pre, _rand(rng, cfg, 3)])

    def run(paged, warm):
        b = ContinuousBatcher(cfg, params, max_batch=2,
                              **({"kv_page_tokens": 8} if paged else {}))
        if warm:
            _run(b, [(np.concatenate([pre, np.asarray([1], np.int32)]), 2)])
        rs = b.submit(samp_p, 8, temperature=0.8, top_p=0.9, seed=7)
        rg = b.submit(greedy_p, 8)
        res = b.run()
        if warm:
            assert b.prefix_stats()["hit"] >= 2, b.prefix_stats()
        return res[rs], res[rg]

    s_dense, g_dense = run(False, False)
    for paged, warm in ((True, True), (True, False)):
        s, g = run(paged, warm)
        np.testing.assert_array_equal(s, s_dense)
        np.testing.assert_array_equal(g, g_dense)
    np.testing.assert_array_equal(g_dense, _oracle(cfg, params, greedy_p, 8))


@pytest.mark.parametrize("kw", [{"prefill_chunk": 6}, {"decode_block_steps": 8},
                                {"speculative_k": 4}], ids=["chunked", "block", "speculative"])
def test_paged_composes_with_decode_regimes(kw):
    cfg, params = _make()
    rng = np.random.default_rng(45)
    pre = _rand(rng, cfg, 16)
    reqs = [(np.concatenate([pre, _rand(rng, cfg, k)]), n) for k, n in ((3, 8), (5, 6))]
    reqs.append((np.tile(np.asarray([7, 11, 23], np.int32), 5), 10))
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, **kw)
    _assert_oracle(cfg, params, _run(b, reqs), reqs)


# ------------------------------------------------------ the serving tier's hooks

def _drive_handoff(pre, max_steps=30):
    sessions = []
    for _ in range(max_steps):
        pre.step()
        sessions.extend(pre.take_sessions())
        if not pre.load()["total"]:
            break
    return sessions


def test_handoff_greedy_exact_on_miss_path():
    """Prefill-only export -> decode adopt: the stitched stream equals the
    solo oracle and the decode batcher never prefills."""
    cfg, params = _make()
    rng = np.random.default_rng(0)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 7), (11, 5), (16, 6), (3, 9))]
    pre = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, prefill_only=True)
    rids = [pre.submit(p, n) for p, n in reqs]
    sessions = dict(_drive_handoff(pre))
    assert sorted(sessions) == sorted(rids)
    assert pre.sessions_exported == len(reqs) and pre.decode_dispatches == 0
    dec = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    dmap = {dec.adopt_session(sessions[rid]): rid for rid in rids}
    results = dec.run()
    assert dec.prefill_dispatches == 0 and dec.sessions_adopted == len(reqs)
    for drid, prid in dmap.items():
        prompt, n = reqs[rids.index(prid)]
        np.testing.assert_array_equal(results[drid], _oracle(cfg, params, prompt, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_handoff_sampled_exact(dtype):
    """A sampled session hands off with its sampler state: the continuation
    equals an unsplit batcher run of the same request (bf16 pages cross as
    their raw bits)."""
    cfg, params = _make(dtype=dtype)
    prompt = np.asarray([7, 3, 9, 1, 4, 2, 8], np.int32)
    kw = dict(temperature=0.8, top_p=0.9, seed=123)
    pre = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, prefill_only=True)
    pre.submit(prompt, 9, **kw)
    [(_, sess)] = _drive_handoff(pre)
    dec = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    drid = dec.adopt_session(sess)
    got = dec.run()[drid]
    solo = ContinuousBatcher(cfg, params, max_batch=1, kv_page_tokens=8)
    srid = solo.submit(prompt, 9, **kw)
    np.testing.assert_array_equal(got, solo.run()[srid])


def test_handoff_prefix_hit_path_exact_and_composes_with_chunking():
    """A decode pool already holding the session's system prefix adopts
    without importing the matched pages; a long prompt streamed through the
    prefill pool's chunked admission hands off exact too."""
    cfg, params = _make()
    rng = np.random.default_rng(1)
    sysp = _rand(rng, cfg, 16)
    dec = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    _run(dec, [(np.concatenate([sysp, _rand(rng, cfg, 3)]), 4)])
    h0 = dec.prefix_stats()
    prompt = np.concatenate([sysp, _rand(rng, cfg, 5)])
    long_p = _rand(rng, cfg, 30)
    pre = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, prefill_chunk=8,
                            prefill_only=True)
    r1, r2 = pre.submit(prompt, 6), pre.submit(long_p, 6)
    sessions = dict(_drive_handoff(pre))
    d1 = dec.adopt_session(sessions[r1])
    d2 = dec.adopt_session(sessions[r2])
    res = dec.run()
    assert dec.prefix_stats()["hit"] == h0["hit"] + 1, "adopt missed the seeded prefix"
    np.testing.assert_array_equal(res[d1], _oracle(cfg, params, prompt, 6))
    np.testing.assert_array_equal(res[d2], _oracle(cfg, params, long_p, 6))


def test_adopt_rejects_corrupt_and_mismatched_sessions_loudly():
    """Bad hashes, page size, missing keys or layout raise ``ValueError``
    from ``adopt_session`` before any device write; the batcher still
    serves exactly afterwards."""
    cfg, params = _make()
    prompt = np.asarray([5, 4, 3, 2, 1, 6, 7, 8, 9], np.int32)
    pre = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, prefill_only=True)
    pre.submit(prompt, 5)
    [(_, sess)] = _drive_handoff(pre)
    dec = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    corrupt = dict(sess, kv=[np.array(a, copy=True) for a in sess["kv"]])
    corrupt["kv"][0].flat[5] += 1
    with pytest.raises(ValueError, match="content hash mismatch"):
        dec.adopt_session(corrupt)
    with pytest.raises(ValueError, match="page_tokens"):
        dec.adopt_session(dict(sess, page_tokens=16))
    with pytest.raises(ValueError, match="missing key"):
        dec.adopt_session({k: v for k, v in sess.items() if k != "page_hashes"})
    with pytest.raises(ValueError, match="layout mismatch"):
        dec.adopt_session(dict(sess, kv=[a[..., :-1] for a in sess["kv"]]))
    drid = dec.adopt_session(sess)
    np.testing.assert_array_equal(dec.run()[drid], _oracle(cfg, params, prompt, 5))


def test_prefill_only_adopt_refusal_and_direct_finish():
    cfg, params = _make()
    pre = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8, prefill_only=True)
    with pytest.raises(ValueError, match="prefill-only"):
        pre.adopt_session({"v": 1})
    with pytest.raises(ValueError, match="paged KV"):
        ContinuousBatcher(cfg, params, max_batch=2).adopt_session({"v": 1})
    prompt = np.asarray([1, 2, 3], np.int32)
    rid = pre.submit(prompt, 1)       # finishes AT the prefill: no session
    done = []
    for _ in range(5):
        done += pre.step()
        if done:
            break
    assert done == [rid] and not pre.take_sessions()
    np.testing.assert_array_equal(pre.result(rid), _oracle(cfg, params, prompt, 1))


def test_set_role_specializes_idle_engine_both_ways_and_validates():
    cfg, params = _make()
    prompt = _rand(np.random.default_rng(5), cfg, 10)
    b = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    with pytest.raises(ValueError, match="unknown role"):
        b.set_role("both")
    with pytest.raises(ValueError, match="paged KV"):
        ContinuousBatcher(cfg, params, max_batch=2).set_role("prefill")
    with pytest.raises(ValueError, match="decode-time"):
        ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8,
                          speculative_k=2).set_role("prefill")
    b.set_role("prefill")
    assert b.prefill_only
    b.submit(prompt, 5)
    sessions = _drive_handoff(b)
    assert len(sessions) == 1 and b.decode_dispatches == 0
    b.set_role("decode")
    drid = b.adopt_session(sessions[0][1])
    with pytest.raises(RuntimeError, match="live requests"):
        b.set_role("prefill")
    np.testing.assert_array_equal(b.run()[drid], _oracle(cfg, params, prompt, 5))
    assert b.prefill_dispatches == 1
    b.set_role("prefill")                # drained: legal again
    assert b.prefill_only


def test_export_import_prefix_cache_roundtrip_exact():
    """A donor's prefix-cache export imports into a fresh batcher as
    matchable cached pages; decoding against them is exact; a corrupt
    import is rejected; dense batchers export and import nothing."""
    cfg, params = _make()
    rng = np.random.default_rng(4)
    sysp = _rand(rng, cfg, 16)
    donor = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    _run(donor, [(np.concatenate([sysp, _rand(rng, cfg, 3)]), 4)])
    export = donor.export_prefix_cache()
    assert export is not None and export["pages"] >= 2
    imp = ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8)
    assert imp.import_prefix_cache(export) == export["pages"]
    probe = np.concatenate([sysp, _rand(rng, cfg, 4)])
    [got] = _run(imp, [(probe, 5)])
    assert imp.prefix_stats()["hit"] == 1, "imported pages never matched"
    np.testing.assert_array_equal(got, _oracle(cfg, params, probe, 5))
    bad = dict(export, kv=[np.array(a, copy=True) for a in export["kv"]])
    bad["kv"][0].flat[0] += 1
    with pytest.raises(ValueError, match="content hash mismatch"):
        ContinuousBatcher(cfg, params, max_batch=2, kv_page_tokens=8).import_prefix_cache(bad)
    other = ContinuousBatcher(cfg, _params(cfg), max_batch=2, kv_page_tokens=16)
    with pytest.raises(ValueError, match="layout mismatch"):
        other.import_prefix_cache(export)
    dense = ContinuousBatcher(cfg, params, max_batch=2)
    assert dense.export_prefix_cache() is None and dense.import_prefix_cache(export) == 0


def test_bench_batcher_reports_every_pattern_at_a_tiny_size():
    """``bench_batcher.bench`` rehearsed on the CPU at a tiny config: every
    pattern measured, the counters consistent with the traffic."""
    from tensorflowonspark_tpu_torch import bench_batcher

    cfg, _ = _make(max_position_embeddings=64)
    out = bench_batcher.bench(cfg=cfg, device="cpu", n_req=6, prompt_len=4, lo=3, hi=9,
                              slots=2, block=4, spec_k=3)
    for label in ("steady", "bursty", "blocked", "spec", "static"):
        assert out[f"{label}_tps"] > 0, label
    for label in ("steady", "bursty", "blocked"):
        assert 0 < out[f"{label}_occupancy"] <= 1 and out[f"{label}_prefill_dispatches"] >= 1
    assert out["steady_prefill_dispatches"] <= 6 and 0 < out["static_occupancy"] <= 1
    assert out["blocked_steps_per_dispatch"] > 1
    assert out["spec_tokens_per_dispatch"] > 0 and 0 <= out["spec_acceptance"] <= 1
    assert out["device"] == "cpu" and out["useful_tokens"] > 6
