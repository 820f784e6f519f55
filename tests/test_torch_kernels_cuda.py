"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without one:
a hand-written kernel has no CPU mode.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 ``atol=2e-5, rtol=1e-5`` (the same f32 products summed
in another order); bfloat16 ``atol=2e-2`` (``p`` is rounded to bf16
against the running max in the kernel and the final max in the plain
version, a relative 2^-8 either way).
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import flash_attention
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention_fwd, flash_attention_reference)

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
