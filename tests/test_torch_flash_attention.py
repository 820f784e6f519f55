"""The port's flash-attention forward against the JAX package's Pallas kernel.

The JAX side runs ``tensorflowonspark_tpu.ops.flash_attention`` as
``tests/test_ops.py`` does on the CPU (Pallas interpret mode, 16x16 blocks),
and ``_fwd_impl`` directly for ``lse``.  The port's ``flash_attention`` on
CPU tensors is its plain PyTorch version (the CUDA kernel itself is held
against that plain version on the card by ``test_torch_kernels_cuda.py``).
Inputs are made with numpy from a seed and handed to both.

Tolerances: float32 ``atol=2e-5, rtol=1e-5`` (the two sum the same f32
products in another order); bfloat16 ``atol=2e-2`` (``p`` is rounded to
bf16 against the running max in the kernel and the final max in the plain
version, a relative 2^-8 either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu.ops.flash_attention import NEG_INF as JAX_NEG_INF
from tensorflowonspark_tpu.ops.flash_attention import _fwd_impl, _pick_block
from tensorflowonspark_tpu_torch.ops import flash_attention as torch_flash
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention_fwd, flash_attention_reference)

BLOCK = 16


def _inputs(seed, B, Tq, Tk, H, D, dtype, mask_lens=None):
    """q/k/v (and a key-padding mask) as (jax arrays, torch tensors) of
    identical values: bf16 is rounded once, in numpy, for both."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, T, H, D), dtype=np.float32)
            for T in (Tq, Tk, Tk)]
    if dtype == "bfloat16":
        arrs = [np.asarray(a, dtype=jnp.bfloat16) for a in arrs]
        jx = [jnp.asarray(a) for a in arrs]
        tx = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in arrs]
    else:
        jx = [jnp.asarray(a) for a in arrs]
        tx = [torch.from_numpy(a) for a in arrs]
    jm = tm = None
    if mask_lens is not None:
        m = np.arange(Tk)[None, :] < np.asarray(mask_lens)[:, None]
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    return jx, tx, jm, tm


def _jax_fwd(q, k, v, mask, causal, window):
    """``(out [B,Tq,H,D], lse [B,H,Tq])`` from the Pallas kernel in
    interpret mode, padded the way the JAX wrapper pads."""
    out = jax_flash(q, k, v, mask=mask, causal=causal, window=window,
                    block_q=BLOCK, block_k=BLOCK, interpret=True)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bq, Tq_p = _pick_block(Tq, BLOCK)
    bk, Tk_p = _pick_block(Tk, BLOCK)
    qt, kt, vt = (jnp.transpose(x, (0, 2, 1, 3)) for x in (q, k, v))
    qt = jnp.pad(qt, ((0, 0), (0, 0), (0, Tq_p - Tq), (0, 0)))
    kt = jnp.pad(kt, ((0, 0), (0, 0), (0, Tk_p - Tk), (0, 0)))
    vt = jnp.pad(vt, ((0, 0), (0, 0), (0, Tk_p - Tk), (0, 0)))
    if mask is not None:
        bias = jnp.where(mask, 0.0, JAX_NEG_INF).astype(jnp.float32)
        bias = jnp.pad(bias, ((0, 0), (0, Tk_p - Tk)), constant_values=JAX_NEG_INF)
    elif Tk_p != Tk:
        bias = jnp.zeros((B, Tk_p), jnp.float32).at[:, Tk:].set(JAX_NEG_INF)
    else:
        bias = None
    if bias is not None:
        bias = bias[:, None, :]
    _, lse = _fwd_impl(qt, kt, vt, bias, causal, 1.0 / np.sqrt(D), bq, bk,
                       True, window)
    return np.asarray(out, np.float32), np.asarray(lse[:, :, :Tq, 0])


# (B, Tq, Tk, H, D, mask_lens, causal, window)
CASES = {
    "no_mask": (2, 64, 64, 2, 64, None, False, None),
    "padding_mask": (2, 48, 48, 2, 64, [30, 48], False, None),
    "fully_masked_row": (2, 32, 32, 2, 64, [0, 19], False, None),
    "causal": (1, 64, 64, 2, 64, None, True, None),
    "causal_window": (1, 64, 64, 2, 64, None, True, 5),
    "ragged_37": (2, 37, 37, 2, 64, [37, 21], False, None),
    "tq_ne_tk": (2, 24, 40, 2, 64, [40, 33], False, None),
    "d128": (1, 32, 32, 2, 128, None, False, None),
    "d128_causal": (1, 48, 48, 2, 128, [48], True, None),
}


#: bf16 runs on a subset that covers every masking path and both head dims
BF16_CASES = ("fully_masked_row", "causal_window", "tq_ne_tk", "d128_causal")


@pytest.mark.parametrize("case,dtype",
                         [(c, "float32") for c in sorted(CASES)]
                         + [(c, "bfloat16") for c in BF16_CASES])
def test_plain_matches_pallas_forward(case, dtype):
    B, Tq, Tk, H, D, lens, causal, window = CASES[case]
    (jq, jk, jv), (tq, tk, tv), jm, tm = _inputs(
        sum(map(ord, case)), B, Tq, Tk, H, D, dtype, lens)
    want_out, want_lse = _jax_fwd(jq, jk, jv, jm, causal, window)
    launches = torch_flash.launches
    got = torch_flash(tq, tk, tv, mask=tm, causal=causal, window=window)
    _, got_lse = flash_attention_fwd(tq, tk, tv, mask=tm, causal=causal,
                                     window=window)
    assert torch_flash.launches == launches == 0  # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == (B, Tq, H, D)
    assert got_lse.shape == (B, H, Tq) and got_lse.dtype == torch.float32
    got = got.float().numpy()
    assert np.isfinite(got).all()
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(got, want_out, **tol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=2e-5 if dtype == "float32" else 2e-2,
                               rtol=1e-5)
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert (got[b] == 0).all()
        assert (got_lse[b] == 1e30).all()


def test_rejects_window_without_causal():
    x = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="requires causal"):
        torch_flash(x, x, x, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        torch_flash(x, x, x, causal=True, window=0)


def test_backward_raises_until_ported():
    q = torch.randn(1, 8, 1, 64, requires_grad=True)
    out = torch_flash(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="K2/K3"):
        out.sum().backward()


def test_reference_matches_sdpa_on_rows_with_keys():
    """The plain version agrees with PyTorch's own attention where SDPA
    is defined (no fully masked row), causal and padded."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 33, 3, 64), dtype=np.float32))
               for _ in range(3))
    mask = torch.from_numpy(np.arange(33)[None, :] < np.array([[33], [20]]))
    out, _ = flash_attention_reference(q, k, v, mask=mask)
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :]).transpose(1, 2)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-5)
