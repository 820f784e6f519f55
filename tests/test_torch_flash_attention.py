"""The port's flash attention, forward and backward, against the JAX
package's Pallas kernels.

The JAX side runs ``tensorflowonspark_tpu.ops.flash_attention`` as
``tests/test_ops.py`` does on the CPU (Pallas interpret mode, 16x16 blocks),
``_fwd_impl`` directly for ``lse``, and ``jax.vjp`` through the wrapper for
the gradients.  The port's ``flash_attention`` on CPU tensors runs its plain
PyTorch versions (the CUDA kernels themselves are held against those plain
versions on the card by ``test_torch_kernels_cuda.py``).  Inputs are made
with numpy from a seed and handed to both.

Forward tolerances: float32 ``atol=2e-5, rtol=1e-5`` (the two sum the same
f32 products in another order); bfloat16 ``atol=2e-2`` (``p`` is rounded to
bf16 against the running max in the kernel and the final max in the plain
version, a relative 2^-8 either way).

Backward tolerances: float32 ``atol=2e-5, rtol=1e-5`` on gradients of
magnitude ~1 (same arithmetic, another summation order).  bfloat16
``atol = 2e-2 * max|g|``: each side's gradients are rounded to bf16 (2^-8
relative), and dQ rounds ``ds`` to bf16 before ``ds.K`` on both sides,
where a one-ulp difference in the bf16 forward output (through ``delta``)
can move a rounding.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.ops import flash_attention as jax_flash
from tensorflowonspark_tpu.ops.flash_attention import NEG_INF as JAX_NEG_INF
from tensorflowonspark_tpu.ops.flash_attention import _fwd_impl, _pick_block
from tensorflowonspark_tpu_torch.ops import flash_attention as torch_flash
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)

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
    # head dims the card's kernels take zero-padded to 64 or 128
    "d8": (2, 40, 40, 2, 8, [40, 0], False, None),
    "d16_causal": (2, 33, 33, 2, 16, [33, 20], True, None),
    "d96": (1, 48, 48, 2, 96, [30], False, None),
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


def _jax_grads(q, k, v, mask, causal, window, g):
    """``(dq, dk, dv)`` of ``sum(out * g)`` by ``jax.vjp`` through the
    Pallas kernels in interpret mode."""
    def f(q, k, v):
        return jax_flash(q, k, v, mask=mask, causal=causal, window=window,
                         block_q=BLOCK, block_k=BLOCK, interpret=True)
    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x, np.float32) for x in vjp(g)]


#: the backward's cases: every masking path, both head dims, f32 and bf16
BWD_CASES = [(c, "float32") for c in sorted(CASES)] + [
    ("fully_masked_row", "bfloat16"), ("causal_window", "bfloat16"),
    ("tq_ne_tk", "bfloat16"), ("d128_causal", "bfloat16")]


@pytest.mark.parametrize("case,dtype", BWD_CASES)
def test_backward_matches_pallas(case, dtype):
    B, Tq, Tk, H, D, lens, causal, window = CASES[case]
    (jq, jk, jv), (tq, tk, tv), jm, tm = _inputs(
        sum(map(ord, case)) + 1, B, Tq, Tk, H, D, dtype, lens)
    g = np.random.default_rng(len(case)).standard_normal((B, Tq, H, D), dtype=np.float32)
    if dtype == "bfloat16":
        g = np.asarray(g, dtype=jnp.bfloat16)
        tg = torch.from_numpy(g.astype(np.float32)).to(torch.bfloat16)
    else:
        tg = torch.from_numpy(g)
    want = _jax_grads(jq, jk, jv, jm, causal, window, jnp.asarray(g))

    # the autograd node, and the plain backward called directly
    tq, tk, tv = (x.requires_grad_() for x in (tq, tk, tv))
    launches = (torch_flash.launches, flash_attention_bwd.launches_dq,
                flash_attention_bwd.launches_dkv)
    out = torch_flash(tq, tk, tv, mask=tm, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    o, lse = flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(), mask=tm,
                                 causal=causal, window=window)
    direct = flash_attention_bwd_reference(tq.detach(), tk.detach(), tv.detach(), tm,
                                           o, lse, tg, causal=causal, window=window)
    assert (torch_flash.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv) == launches == (0, 0, 0)  # CPU: no kernel
    for name, a, b, w, x in zip("qkv", got, direct, want, (tq, tk, tv)):
        assert a.dtype == x.dtype and a.shape == x.shape, name
        assert torch.equal(a, b), name  # the node runs exactly the plain backward
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(a, w, atol=2e-5, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(a, w, atol=2e-2 * np.abs(w).max(), rtol=0,
                                       err_msg=name)
    if lens is not None and 0 in lens:
        b = lens.index(0)
        # a fully masked row: no gradient reaches its queries, keys or values
        for a in got:
            assert (a[b] == 0).all()


def test_backward_takes_a_strided_grad_out():
    """A non-contiguous ``grad_out`` (a transposed view) gives the same
    gradients as its contiguous copy."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, 3, 64), dtype=np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 3, 24, 64), dtype=np.float32)).transpose(1, 2)
    assert not g.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    want = flash_attention_bwd(q, k, v, None, out, lse, g.contiguous(), causal=True)
    got = flash_attention_bwd(q, k, v, None, out, lse, g, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


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


def _bf16_layout(kind):
    """A bf16 [2, 40, 4, 64] view of one buffer, laid out as ``kind``."""
    buf = torch.zeros(2 * 40 * 3 * 4 * 64 + 64, dtype=torch.bfloat16)
    n = 2 * 40 * 4 * 64
    if kind == "contiguous":
        return buf[:n].view(2, 40, 4, 64)
    if kind == "fused_qkv":                      # k of a fused [B, T, 3, H, D] projection
        return buf[:3 * n].view(2, 40, 3, 4, 64)[:, :, 1]
    if kind == "offset_8_bytes":
        return buf[4:4 + n].view(2, 40, 4, 64)
    # rows 4 elements (8 bytes) longer than a head's: a row stride off 16 bytes
    return buf.as_strided((2, 40, 4, 64), (40 * 260, 260, 64, 1))


@pytest.mark.parametrize("kind,ok", [("contiguous", True), ("fused_qkv", True),
                                     ("offset_8_bytes", False), ("row_stride_plus_4", False)])
def test_tma_layout_rule(kind, ok):
    """The host-side rule that lets a bf16 tensor into the TMA kernels: a
    16-byte-aligned base and strides of whole 16 bytes (TMA's own rule for
    a tensor map); anything else raises before a launch."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import _rows_staged_ok

    t = _bf16_layout(kind)
    assert t.stride(3) == 1
    assert _rows_staged_ok(t) is ok


def _module():
    """The module ``ops/flash_attention.py`` (``ops.flash_attention`` is
    the function it exports)."""
    return importlib.import_module("tensorflowonspark_tpu_torch.ops.flash_attention")


def _padded_launches(monkeypatch, widths):
    """Stand in for the ctypes launches with the plain versions, recording
    the head dim each launch was given."""
    fa = _module()

    def fwd(q, k, v, mask, causal, scale, window):
        widths.append(q.shape[3])
        return flash_attention_reference(q, k, v, mask, causal, scale, window or None)

    def bwd(entry, outputs, q, k, v, mask, dout, lse, delta, causal, scale, window):
        widths.append(q.shape[3])
        ref = (fa.flash_attention_dq_reference if entry.endswith("_dq")
               else fa.flash_attention_dkv_reference)
        got = ref(q, k, v, mask, dout, lse, delta, causal, scale, window or None)
        for o, r in zip(outputs, (got,) if torch.is_tensor(got) else got):
            o.copy_(r)

    monkeypatch.setattr(fa, "_fwd_launch", fwd)
    monkeypatch.setattr(fa, "_bwd_launch", bwd)
    return fa


@pytest.mark.parametrize("D,width", [(8, 64), (16, 64), (64, 64), (96, 128), (128, 128)])
def test_card_route_pads_the_head_dim_exactly(monkeypatch, D, width):
    """The custom ops' card implementations zero-pad q, k, v (and dO) to
    the kernels' head dim, keep the scale of the true ``D`` and cut the
    outputs back: the same values as the plain versions at ``D`` (run here
    with the plain versions standing in for the kernels at the padded
    width), and one launch counted per kernel."""
    widths = []
    fa = _padded_launches(monkeypatch, widths)
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 37, 3, D), dtype=np.float32))
                  for _ in range(4))
    mask = torch.from_numpy(np.arange(37)[None, :] < np.array([[37], [0]]))
    scale = 1.0 / np.sqrt(D)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches_dq,
              fa.flash_attention_bwd.launches_dkv)
    out, lse = fa._fwd_padded(q, k, v, mask, True, scale, 0)
    want, want_lse = flash_attention_reference(q, k, v, mask, causal=True)
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    delta = fa._delta(out, g)
    dq = fa._dq_padded(q, k, v, mask, g, lse, delta, True, scale, 0)
    dk, dv = fa._dkv_padded(q, k, v, mask, g, lse, delta, True, scale, 0)
    for a, b in zip((dq, dk, dv), flash_attention_bwd_reference(q, k, v, mask, want, want_lse,
                                                                 g, causal=True)):
        assert a.shape == q.shape and a.is_contiguous()
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert widths == [width] * 3
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches_dq,
            fa.flash_attention_bwd.launches_dkv) == tuple(n + 1 for n in before)


def test_card_route_refuses_head_dims_over_128():
    fa = _module()

    x = torch.zeros(1, 8, 1, 160)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        fa._fwd_padded(x, x, x, None, False, 1.0, 0)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        fa._dq_padded(x, x, x, None, x, torch.zeros(1, 1, 8), torch.zeros(1, 1, 8),
                      False, 1.0, 0)
