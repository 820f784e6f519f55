"""The port's continuous batcher on the card.

Every test needs a CUDA card (marker ``cuda``) and skips without one.  The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

A small GPT (2 layers, hidden 256 over 4 heads, vocab 512, 256 positions)
with weights from ``init_params`` at seed 0.  In float32 with TF32 off
every stream must equal a solo ``greedy_generate`` on the card, token for
token, dense, paged, in decode blocks and under speculation.  In bf16 the
prefill's padded group and the solo run's batch of 1 may round apart, so
each bf16 stream's first divergence from the solo bf16 run must come where
the float32 full forward's top two logits lie within :data:`TIE` (a
near-tie), and the serving path launches no kernel of the repo.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.models import gpt
from tensorflowonspark_tpu_torch.models.serving import ContinuousBatcher
from tensorflowonspark_tpu_torch.ops import flash_attention

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=256)
#: the bf16 tie margin (absolute, on logits of std ~0.3 at this width)
TIE = 0.05


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this file holds the batcher on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _setup(dtype):
    cfg = gpt.GPTConfig(**SMALL, dtype=dtype)
    params = {n: t.cuda() for n, t in gpt.init_params(cfg, 0).items()}
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (t,)).astype(np.int32), n)
            for t, n in ((5, 20), (37, 12), (9, 30), (64, 8), (17, 16), (100, 24))]
    return cfg, params, reqs


def _solo(cfg, params, p, n):
    return gpt.greedy_generate(cfg, params, p[None, :], n)[0, len(p):].cpu().numpy()


def _serve(cfg, params, reqs, **kw):
    b = ContinuousBatcher(cfg, params, max_batch=4, **kw)
    rids = [b.submit(p, n) for p, n in reqs]
    res = b.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kw", [{}, {"kv_page_tokens": 16}, {"decode_block_steps": 8},
                                {"speculative_k": 4}, {"prefill_chunk": 32}],
                         ids=["dense", "paged", "block", "speculative", "chunked"])
def test_float32_streams_equal_solo_greedy_on_the_card(kw):
    cfg, params, reqs = _setup(torch.float32)
    for got, (p, n) in zip(_serve(cfg, params, reqs, **kw), reqs):
        np.testing.assert_array_equal(got, _solo(cfg, params, p, n))


@pytest.mark.parametrize("kw", [{}, {"kv_page_tokens": 16}], ids=["dense", "paged"])
def test_bf16_streams_diverge_only_at_near_ties(kw):
    cfg, params, reqs = _setup(torch.bfloat16)
    model32 = gpt._model(dataclasses.replace(cfg, dtype=torch.float32), params)
    before = flash_attention.launches
    streams = _serve(cfg, params, reqs, **kw)
    assert flash_attention.launches == before
    for got, (p, n) in zip(streams, reqs):
        want = _solo(cfg, params, p, n)
        diff = np.flatnonzero(got != want)
        if diff.size:
            j = int(diff[0])
            ids = torch.from_numpy(np.concatenate([p, want[:j]]).astype(np.int64)).cuda()
            with torch.no_grad():
                top = torch.topk(model32(ids[None])[0, -1], 2).values
            assert (top[0] - top[1]).item() <= TIE, (j, top)


@pytest.mark.parametrize("kw", [{}, {"kv_page_tokens": 16}, {"decode_block_steps": 8},
                                {"speculative_k": 4}, {"prefill_chunk": 32}],
                         ids=["dense", "paged", "block", "speculative", "chunked"])
def test_captured_sites_replay_the_eager_tokens(kw):
    """Every site captured as a CUDA graph (``serving/aot.py``): float32
    streams equal the eager batcher's, no capture fails, one capture a
    site used, and the registry holds capture sites only."""
    from tensorflowonspark_tpu_torch.serving.aot import AOTExecutableCache

    cfg, params, reqs = _setup(torch.float32)
    eager = _serve(cfg, params, reqs, **kw)
    cache = AOTExecutableCache(None)
    b = ContinuousBatcher(cfg, params, max_batch=4, aot_cache=cache, **kw)
    rids = [b.submit(p, n) for p, n in reqs]
    res = b.run()
    for rid, want in zip(rids, eager):
        np.testing.assert_array_equal(res[rid], want)
    used = [s for s in (b._step, b._step_sample, *b._prefill_jit.values()) if s.calls]
    assert cache.stats() == {"dir": None, "loads": 0, "compiles": len(used), "errors": 0}
    assert {k if isinstance(k, str) else k[0] for k in b._prefill_jit} \
        <= {"final", "chunk", "scatter", "pfinal", "pchunk", "verify", "block"}
