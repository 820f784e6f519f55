"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a hand-written kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Forward tolerances: float32 ``atol=2e-5, rtol=1e-5`` (the same f32
products summed in another order); bfloat16 ``atol=2e-2`` (``p`` is
rounded to bf16 against the running max in the kernel and the final max in
the plain version, a relative 2^-8 either way).

Backward tolerances, relative to each gradient's largest magnitude:
float32 ``1e-5`` (the float32 kernels keep every value in f32, as the
plain version does; another summation order); bfloat16 ``2e-2``: the dK/dV
kernel rounds ``p`` and ``ds`` to bf16 before its tensor-core products
where the plain version (and the TPU kernel) keeps them in f32, a relative
2^-9 a term, and every gradient is rounded to bf16 on output (2^-8).
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention, flash_attention_plain
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_dkv,
    flash_attention_dq, flash_attention_dq_reference, flash_attention_fwd,
    flash_attention_reference)

pytestmark = pytest.mark.cuda

# (B, Tq, Tk, H, D, mask_lens, causal, window)
CASES = {
    "no_mask": (2, 64, 64, 2, 64, None, False, None),
    "padding_mask": (2, 48, 48, 2, 64, [30, 48], False, None),
    "fully_masked_row": (2, 32, 32, 2, 64, [0, 19], False, None),
    "causal": (1, 200, 200, 2, 64, None, True, None),
    "causal_window": (1, 200, 200, 2, 128, None, True, 70),
    "ragged_37": (2, 37, 37, 2, 64, [37, 21], False, None),
    "tq_ne_tk": (2, 24, 140, 2, 64, [140, 33], False, None),
    "tq_gt_tk_window": (1, 150, 40, 2, 128, None, True, 16),
    "bert": (2, 384, 384, 12, 64, [384, 100], False, None),
    # one TMA tile each way, and boxes that overhang both ragged edges
    "single_tile": (1, 64, 64, 1, 64, None, False, None),
    "single_tile_d128": (1, 64, 64, 1, 128, None, False, None),
    "ragged_129_257": (3, 129, 257, 2, 64, [257, 0, 130], False, None),
    "d128_padding": (2, 256, 256, 4, 128, [256, 77], False, None),
    # rings of K/V (dQ, forward) or Q/dO (dK/dV) tiles: a window whose first
    # key tile is not tile 0, over 5 key tiles; causal Tq != Tk with 7 key
    # tiles for the last query tile, so the 3-stage ring wraps twice
    "window_ring": (1, 640, 640, 2, 64, None, True, 200),
    "causal_tq_ne_tk_ring": (2, 448, 512, 2, 128, [512, 300], True, None),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_matches_plain(case, dtype):
    _card()
    B, Tq, Tk, H, D, lens, causal, window = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32))
               .to("cuda", dtype) for T in (Tq, Tk, Tk))
    mask = None
    if lens is not None:
        mask = torch.from_numpy(np.arange(Tk)[None, :] < np.asarray(lens)[:, None]).cuda()
    launches = flash_attention.launches
    out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    want, want_lse = flash_attention_reference(q, k, v, mask=mask, causal=causal,
                                               window=window)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_reads_strided_inputs(dtype):
    """q/k/v sliced out of one fused [B, T, 3, H, D] projection are read
    through their strides, with no copy."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(2, 96, 3, 4, 64, device="cuda", generator=g).to(dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v)
    want, want_lse = flash_attention_reference(q, k, v)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=1e-5)


def test_flash_rejects_what_the_kernel_cannot_take():
    _card()
    x = torch.zeros(1, 8, 1, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x, x)
    y = torch.zeros(1, 8, 1, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(y, y, y)
    z = torch.zeros(1, 8, 1, 65, device="cuda", dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(z, z, z)


def test_flash_rejects_a_batch_stride_off_16_bytes():
    """TMA reads bf16 rows through a tensor map whose strides must be whole
    16 bytes: a batch stride of 516 elements (1032 bytes) is refused."""
    _card()
    buf = torch.zeros(2 * 516, device="cuda", dtype=torch.bfloat16)
    x = buf.as_strided((2, 8, 1, 64), (516, 64, 64, 1))
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention_fwd(x, x, x)


def _bwd_inputs(case, dtype):
    B, Tq, Tk, H, D, lens, causal, window = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32))
               .to("cuda", dtype) for T in (Tq, Tk, Tk))
    g = torch.from_numpy(rng.standard_normal((B, Tq, H, D), dtype=np.float32)).to("cuda", dtype)
    mask = None
    if lens is not None:
        mask = torch.from_numpy(np.arange(Tk)[None, :] < np.asarray(lens)[:, None]).cuda()
    return q, k, v, g, mask, causal, window


def _check_grads(got, want, dtype):
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a.float(), b.float(), rtol=0, msg=name,
                                   atol=rel * max(b.float().abs().max().item(), 1e-6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_plain(case, dtype):
    _card()
    q, k, v, g, mask, causal, window = _bwd_inputs(case, dtype)
    out, lse = flash_attention_fwd(q, k, v, mask=mask, causal=causal, window=window)
    counts = (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv)
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv) == (
        counts[0] + 1, counts[1] + 1)
    want = flash_attention_bwd_reference(q, k, v, mask, out, lse, g, causal=causal,
                                         window=window)
    _check_grads(got, want, dtype)
    lens = CASES[case][5]
    if lens is not None and 0 in lens:
        b = lens.index(0)
        for a in got:
            assert (a[b] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_dq_matches_plain(case, dtype):
    """The dQ kernel alone against its plain version, fed the plain
    forward's ``lse`` and ``delta``; a fully masked row's dq is exactly 0."""
    _card()
    q, k, v, g, mask, causal, window = _bwd_inputs(case, dtype)
    out, lse = flash_attention_reference(q, k, v, mask=mask, causal=causal, window=window)
    delta = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()
    launches = flash_attention_bwd.launches_dq
    got = flash_attention_dq(q, k, v, mask, g, lse, delta, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches_dq == launches + 1
    want = flash_attention_dq_reference(q, k, v, mask, g, lse, delta, causal=causal,
                                        window=window)
    _check_grads((got,), (want,), dtype)
    lens = CASES[case][5]
    if lens is not None and 0 in lens:
        assert (got[lens.index(0)] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_reads_strided_inputs_and_grad_out(dtype):
    """q/k/v sliced out of one fused projection and a transposed
    ``grad_out``, through the autograd node, against the plain node on
    contiguous copies."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 96, 3, 4, 64, device="cuda", generator=g).to(dtype)
    dout = torch.randn(2, 4, 96, 64, device="cuda", generator=g).to(dtype).transpose(1, 2)
    assert not dout.is_contiguous()
    leaf = qkv.clone().requires_grad_()
    q, k, v = leaf.unbind(2)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True), leaf, dout)[0]
    leaf2 = qkv.clone().requires_grad_()
    q2, k2, v2 = (x.contiguous() for x in leaf2.unbind(2))
    want = torch.autograd.grad(flash_attention_plain(q2, k2, v2, causal=True), leaf2,
                               dout.contiguous())[0]
    _check_grads(got.unbind(2), want.unbind(2), dtype)


def test_flash_backward_rejects_what_the_kernels_cannot_take():
    _card()
    q = torch.zeros(1, 8, 1, 64, device="cuda")
    _, lse = flash_attention_fwd(q, q, q)
    delta = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_dq(q, q, q, None, torch.zeros(1, 8, 1, 32, device="cuda"), lse, delta)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_dkv(q, q, q, None, q.to(torch.bfloat16), lse, delta)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_dq(q, q, q, None, q, lse[:, :, :4], delta)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_dkv(q, q, q, None, q, lse, delta.double())
    x = torch.zeros(1, 8, 1, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_dq(x, x, x, None, x, lse, delta)
