"""The port's GPT on the card: the causal flash kernels inside a decoder
that trains, decoding on the card against the CPU, and the int8 export.

Every test needs a CUDA card (marker ``cuda``) and skips without one.  The
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_gpt_cuda.py

A small GPT (2 layers, hidden 256 over 4 heads: head dim 64, vocab 512,
T = 192) in bf16 with float32 parameters.  Tolerances: the kernels' loss
against the plain attention's ``1e-2`` (bf16 rounding of ``p`` in the
kernels, as ``chip_smoke.py``'s BERT gradient gate), each gradient's
``||g - g_plain|| / ||g_plain|| <= 0.1`` (the BERT gate's max); float32
decoding on the card must give the CPU's tokens; the int8 export must
give the eager int8 logits bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.checkpoint import ExportedModel, export_model
from tensorflowonspark_tpu_torch.models import gpt
from tensorflowonspark_tpu_torch.ops import (flash_attention, flash_attention_plain,
                                             quantize_params, tied_softmax_xent)
from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention_bwd

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=256)
ARCHS = {"gpt2": {}, "llama_window": dict(pos_encoding="rope", norm="rmsnorm", mlp="swiglu",
                                          num_kv_heads=2, sliding_window=64)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _counts():
    return (flash_attention.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv)


def _ids(B=4, T=192, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(0, SMALL["vocab_size"], (B, 1))
                             + np.arange(T)[None, :]) % SMALL["vocab_size"]).cuda()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_training_step_through_the_causal_kernels_matches_the_plain_attention(arch):
    sd = gpt.init_params(gpt.GPTConfig(**SMALL, **ARCHS[arch]), 0)
    ids = _ids()
    out = {}
    for name, fn in (("kernels", flash_attention), ("plain", flash_attention_plain)):
        cfg = gpt.GPTConfig(**SMALL, **ARCHS[arch], attention_fn=fn)
        model = gpt.GPT(cfg).cuda()
        model.load_state_dict(sd)
        before = _counts()
        logits = model(ids)
        loss = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, cfg.vocab_size).float(), ids[:, 1:].reshape(-1))
        loss.backward()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(_counts(), before))
        assert launched == ((2, 2, 2) if name == "kernels" else (0, 0, 0))
        out[name] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
    assert abs(out["kernels"][0] - out["plain"][0]) <= 1e-2
    for n, g in out["plain"][1].items():
        if n.endswith("attn.key.bias") and arch == "gpt2":
            continue  # zero in exact arithmetic: rounding noise on both sides
        assert ((out["kernels"][1][n] - g).norm() / g.norm()).item() <= 0.1, n


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_float32_decoding_on_the_card_gives_the_cpu_tokens(arch):
    cfg = gpt.GPTConfig(**SMALL, **ARCHS[arch], dtype=torch.float32)
    sd = {n: t * 10 if t.dim() > 1 else t for n, t in gpt.init_params(cfg, 1).items()}
    prompt = _ids(B=2, T=12, seed=2)
    want = gpt.greedy_generate(cfg, sd, prompt.cpu(), 16)
    on_card = {n: t.cuda() for n, t in sd.items()}
    assert torch.equal(gpt.greedy_generate(cfg, on_card, prompt, 16).cpu(), want)
    assert torch.equal(gpt.lookup_generate(cfg, on_card, prompt, 16, draft_len=4).cpu(), want)
    int8kv = gpt.greedy_generate(dataclasses.replace(cfg, kv_cache_int8=True), on_card,
                                 prompt, 16).cpu()
    assert int8kv.shape == want.shape


def test_int8_export_on_the_card_is_bit_identical_to_eager():
    cfg = gpt.GPTConfig(**SMALL, attention_fn=flash_attention)
    q = quantize_params(gpt.init_params(cfg, 3))
    ids = _ids(B=2, T=64)
    with torch.device("meta"):
        skeleton = gpt.GPT(cfg)
    with torch.no_grad():
        eager = gpt._model(cfg, {n: v.to("cuda") for n, v in q.items()})(ids)

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        export_model(d, lambda p, x: gpt.bind(skeleton, p)(x), q, [ids.cpu()])
        before = _counts()
        got = next(iter(ExportedModel.load(d, device="cuda")(ids).values()))
        assert _counts()[0] - before[0] == cfg.num_layers
    assert torch.equal(got, eager)


def test_chunked_xent_on_the_card_matches_the_dense_loss():
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(3, 100, 64, device="cuda", generator=g, requires_grad=True)
    table = torch.randn(1000, 64, device="cuda", generator=g, requires_grad=True)
    labels = torch.randint(0, 1000, (3, 100), device="cuda", generator=g)
    got = tied_softmax_xent(h, table, labels, chunk_size=256).mean()
    gh, gt = torch.autograd.grad(got, (h, table))
    want = torch.nn.functional.cross_entropy((h @ table.T).reshape(-1, 1000), labels.reshape(-1))
    wh, wt = torch.autograd.grad(want, (h, table))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gh, wh, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-6)
