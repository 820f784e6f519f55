"""The batcher's compile-site cache (``serving/aot.py``): each site of the
registry captured once as a CUDA graph and replayed.

CUDA graphs need a card, so these tests drive the cache through its
``capture=`` seam with a stand-in graph that records the function over the
static arguments and, at each replay, runs it again over their current
contents: what a replay reads is exactly what a graph would read.  So a
batcher whose sites replay must give the eager batcher's tokens in every
regime, with no error and one compile a site used; a replay whose token
buffer is not refilled must not.  The card's own captures are held in
``tests/test_torch_serving_cuda.py``.

The JAX package's executable cache writes to disk (its two AOT tests fail
under the installed jax); this one keeps nothing on disk, by design.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher, DraftModel
from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache
from tests.test_torch_serving import _make, _oracle, _params, _rand, _variant


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and a
    suite run in parallel processes does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: every registry key the batcher may capture (besides the two steps)
CAPTURE_SITES = {"final", "chunk", "scatter", "pfinal", "pchunk", "verify", "block"}


def replay_capture(fn, args, pool, stream):
    """The stand-in graph: nothing runs at capture; a replay runs ``fn``
    over the static arguments as they are then."""
    return lambda: fn(*args)


def _cache():
    return AOTExecutableCache("unused", capture=replay_capture)


def _sites(b):
    sites = [b._step, b._step_sample, *b._prefill_jit.values()]
    if b._draft_model is not None:
        sites += list(b._draft_model._propose.values())
    return [s for s in sites if getattr(s, "calls", 0)]


def _run(b, reqs, **kw):
    rids = [b.submit(p, n, **kw) for p, n in reqs]
    res = b.run()
    return [np.asarray(res[r]) for r in rids]


def _staggered(b, reqs):
    """The first half submitted at once, the rest one a step."""
    half = len(reqs) // 2
    rids = [b.submit(p, n) for p, n in reqs[:half]]
    for p, n in reqs[half:]:
        b.step()
        rids.append(b.submit(p, n))
    res = b.run()
    return [np.asarray(res[r]) for r in rids]


# ------------------------------------------------------------ the cache

def test_first_call_captures_later_calls_replay_and_count():
    cache = _cache()
    calls = []

    def fn(acc, x):
        calls.append(1)
        acc.add_(x)
        return acc * 2

    site = cache.wrap(("s",), fn, donate_argnums=(0,))
    acc = torch.zeros(3)
    np.testing.assert_array_equal(site(acc, torch.ones(3)).numpy(), [2, 2, 2])   # eager
    assert cache.stats() == {"dir": "unused", "loads": 0, "compiles": 1, "errors": 0}
    out = site(acc, torch.full((3,), 2.0))
    np.testing.assert_array_equal(out.numpy(), [6, 6, 6])
    np.testing.assert_array_equal(acc.numpy(), [3, 3, 3])    # donated: written in place
    out.add_(100)                                             # outputs are the caller's
    np.testing.assert_array_equal(site(acc, torch.zeros(3)).numpy(), [6, 6, 6])
    assert cache.compiles == 1 and cache.errors == 0 and site.calls == 3


def test_unreplayable_call_and_failed_capture_run_eagerly_and_count_errors():
    cache = _cache()
    site = cache.wrap("s", lambda acc, x: acc.add_(x).sum(), donate_argnums=(0,))
    acc = torch.zeros(2)
    site(acc, torch.ones(2))
    assert float(site(acc, torch.ones(3)[:2])) == 4.0          # same shape: replay
    assert float(site(torch.zeros(2), torch.ones(2))) == 2.0    # another donated tensor
    assert cache.errors == 1
    assert float(site(torch.zeros(4), torch.ones(4))) == 4.0    # eager from now on
    assert cache.errors == 1 and cache.compiles == 1

    def broken(fn, args, pool, stream):
        raise RuntimeError("operation not permitted when stream is capturing")

    bad = AOTExecutableCache(None, capture=broken)
    site = bad.wrap("t", lambda x: x + 1)
    assert float(site(torch.ones(()))) == 2.0
    assert float(site(torch.ones(()))) == 2.0
    assert bad.stats()["errors"] == 1 and bad.compiles == 0


def test_default_capture_refuses_a_cpu_batcher():
    cfg, params = _make()
    with pytest.raises(ValueError, match="nothing to capture"):
        ContinuousBatcher(cfg, params, max_batch=2, aot_cache=AOTExecutableCache(None))


# ---------------------------------------------------- the captured batcher

REGIMES = {
    "dense": {},
    "paged": {"kv_page_tokens": 8},
    "chunked": {"prefill_chunk": 6},
    "paged_chunked": {"kv_page_tokens": 8, "prefill_chunk": 6},
    "blocks": {"decode_block_steps": 8},
    "lookup": {"speculative_k": 3},
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_captured_batcher_equals_eager(regime):
    """The same staggered traffic through the eager batcher and a captured
    one: every stream equal (and equal to solo greedy), no error, one
    capture a site used, and the registry holds capture sites only."""
    cfg, params = _make()
    rng = np.random.default_rng(31)
    shared = _rand(rng, cfg, 16)
    reqs = [(np.concatenate([shared, _rand(rng, cfg, t)]), n) for t, n in ((3, 6), (9, 5))]
    reqs += [(np.tile(_rand(rng, cfg, 3), 5), 9), (_rand(rng, cfg, 20), 4), (_rand(rng, cfg, 5), 7)]
    kw = REGIMES[regime]
    eager = _staggered(ContinuousBatcher(cfg, params, max_batch=2, **kw), reqs)
    cache = _cache()
    b = ContinuousBatcher(cfg, params, max_batch=2, aot_cache=cache, **kw)
    got = _staggered(b, reqs)
    for g, e, (p, n) in zip(got, eager, reqs):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, _oracle(cfg, params, p, n))
    assert b.aot_stats() == {"dir": "unused", "loads": 0, "compiles": len(_sites(b)),
                             "errors": 0}
    assert {k if isinstance(k, str) else k[0] for k in b._prefill_jit} <= CAPTURE_SITES
    assert any(s.calls > 1 for s in _sites(b)), "no site was replayed"


def test_captured_sampling_and_draft_equal_eager():
    """Sampled rows (the sampling step) and a draft model's propose sites
    replay to the eager tokens."""
    cfg, params = _make()
    rng = np.random.default_rng(32)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 8), (7, 6), (4, 9))]
    out = {}
    for tag, cache in (("eager", None), ("captured", _cache())):
        b = ContinuousBatcher(cfg, params, max_batch=2, aot_cache=cache)
        out[tag, "sampled"] = _run(b, reqs, temperature=0.8, top_p=0.9, seed=5)
        d = ContinuousBatcher(cfg, params, max_batch=2, speculative_k=3, aot_cache=cache)
        d.set_draft(DraftModel(cfg, params, window=16))
        out[tag, "draft"] = _run(d, reqs)
        if cache is not None:
            assert cache.errors == 0 and d._draft_model._propose
            assert cache.compiles == len(_sites(b)) + len(_sites(d))
            assert d.spec_accepted == d.spec_proposed > 0     # the model drafts itself
    for kind in ("sampled", "draft"):
        for g, e in zip(out["captured", kind], out["eager", kind]):
            np.testing.assert_array_equal(g, e)


def test_quantized_weights_replay():
    cfg, params = _variant("int8")
    rng = np.random.default_rng(33)
    reqs = [(_rand(rng, cfg, t), n) for t, n in ((5, 6), (8, 5), (3, 7))]
    b = ContinuousBatcher(cfg, params, max_batch=2, aot_cache=_cache())
    for g, (p, n) in zip(_staggered(b, reqs), reqs):
        np.testing.assert_array_equal(g, _oracle(cfg, params, p, n))
    assert b.aot_stats()["errors"] == 0


def test_a_replay_without_refilled_tokens_is_caught():
    """The planted fault: the decode step's static token buffer is not
    refilled, so every replay decodes the tokens of the capture call."""
    cfg, params = _make()
    rng = np.random.default_rng(34)
    reqs = [(_rand(rng, cfg, t), 8) for t in (5, 9)]
    b = ContinuousBatcher(cfg, params, max_batch=2, aot_cache=_cache())
    b._step.refill = lambda leaves: None
    got = _run(b, reqs)
    assert any(not np.array_equal(g, _oracle(cfg, params, p, n))
               for g, (p, n) in zip(got, reqs))


# --------------------------------------------------------- weight swaps

def test_load_params_copies_in_place_and_keeps_every_pointer():
    """A swap writes the new weights into the storage the sites were
    captured over: every parameter's ``data_ptr()`` is unchanged, the
    captured batcher decodes with the new weights, a wrong shape bounces
    before anything is written, and the caller's tensors are the
    caller's (unload zeroes the batcher's own copy)."""
    cfg, params = _make()
    params2 = _params(cfg, seed=5)
    prompt = _rand(np.random.default_rng(35), cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=2, aot_cache=_cache())
    _run(b, [(prompt, 5)])
    ptrs = {n: t.data_ptr() for n, t in b._bound_params().items()}
    assert all(ptrs[n] != params[n].data_ptr() for n in ptrs)     # its own copy
    b.unload_params()
    assert all(float(t.abs().sum()) == 0 for t in b._bound_params().values())
    assert float(params["ln_f.weight"].abs().sum()) > 0
    with pytest.raises(ValueError, match="shape/dtype"):
        b.load_params({**params2, "ln_f.bias": torch.zeros(33)})
    b.load_params({n: t.numpy() for n, t in params2.items()})
    assert {n: t.data_ptr() for n, t in b._bound_params().items()} == ptrs
    [got] = _run(b, [(prompt, 5)])
    np.testing.assert_array_equal(got, _oracle(cfg, params2, prompt, 5))
    assert b.aot_stats()["errors"] == 0
    rid = b.submit(prompt, 3)
    with pytest.raises(RuntimeError, match="live requests"):
        b.load_params(params)
    b.run()
    b.result(rid, pop=True)


def test_an_eager_batcher_reads_the_callers_weights_and_unload_lets_go():
    """Without a capture cache nothing needs storage that stays put: the
    batcher reads the caller's tensors, ``unload_params`` keeps only their
    shapes and dtypes, and ``load_params`` binds the new tensors."""
    cfg, params = _make()
    params2 = _params(cfg, seed=5)
    prompt = _rand(np.random.default_rng(36), cfg, 6)
    b = ContinuousBatcher(cfg, params, max_batch=2)
    assert all(t.data_ptr() == params[n].data_ptr() for n, t in b._bound_params().items())
    b.unload_params()
    assert all(t.is_meta for t in b._bound_params().values())
    with pytest.raises(ValueError, match="shape/dtype"):
        b.load_params({**params2, "ln_f.bias": torch.zeros(33)})
    b.load_params(params2)
    assert all(t.data_ptr() == params2[n].data_ptr() for n, t in b._bound_params().items())
    [got] = _run(b, [(prompt, 5)])
    np.testing.assert_array_equal(got, _oracle(cfg, params2, prompt, 5))


def test_bf16_weights_cross_as_int16_bits():
    from tensorflowonspark_tpu_torch.models.serving import host_params

    cfg, params = _make(dtype=torch.bfloat16)
    params = {n: t.to(torch.bfloat16) for n, t in params.items()}
    b = ContinuousBatcher(cfg, params, max_batch=1)
    host = host_params(params)
    assert host["ln_f.weight"].dtype == np.int16
    b.unload_params()
    b.load_params(host)
    assert all(torch.equal(b._bound_params()[n], params[n]) for n in params)
