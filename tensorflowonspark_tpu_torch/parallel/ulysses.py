"""Ulysses-style sequence parallelism: an all-to-all head/sequence exchange.

Port of ``tensorflowonspark_tpu/parallel/ulysses.py``.  Where the ring
rotates K/V blocks around ``sp`` and computes attention blockwise, Ulysses
re-shards: one all-to-all turns the sequence-cut ``[B, T/sp, H, D]`` q, k
and v (stacked, one exchange for the three) into head-cut ``[B, T,
H/sp, D]``, each rank runs full-sequence attention over its heads, and a
second all-to-all restores the sequence cut.  The key-padding mask is
all-gathered.

Because every rank sees the whole sequence, the attention inside is any
single-device kernel: pass ``attn_fn=ops.flash_attention`` and each rank
runs the hand-written flash kernels (K1 forward, K2/K3 backward) on its
heads.  The exchanges are :func:`~.comm.all_to_all_exchange`, whose
backward is the inverse exchange.  ``num_heads`` must divide by the
``sp`` size.
"""

from __future__ import annotations

import torch

from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel.mesh import axis_group
from tensorflowonspark_tpu_torch.parallel.ring_attention import (_self_attention,
                                                                 reference_attention)


def _seq_to_heads(qkv, group):
    """``[3, B, T/n, H, D]`` (this rank's sequence block) → ``[3, B, T,
    H/n, D]`` (this rank's heads)."""
    return comm.all_to_all_exchange(qkv, group, split_dim=3, concat_dim=2)


def _heads_to_seq(out, group):
    """``[B, T, H/n, D]`` → ``[B, T/n, H, D]``."""
    return comm.all_to_all_exchange(out, group, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mask=None, axis_name: str = "sp", causal: bool = False,
                      attn_fn=None, mesh=None):
    """Attention over a sequence cut on ``mesh``'s ``axis_name`` via
    all-to-all.

    Args:
      q, k, v: this rank's blocks ``[batch, seq_local, heads, head_dim]``;
        ``heads`` must divide by the ``sp`` size.
      mask: optional LOCAL key-padding mask block ``[batch, seq_local]``
        (True = attend); all-gathered so every head shard masks the full
        sequence.
      causal: causal masking (positions are global — each rank holds the
        whole sequence after the exchange).
      attn_fn: full-sequence attention ``(q, k, v, mask=, causal=) -> out``
        on ``[B, T, h_local, D]``; default the dense reference (pass
        ``ops.flash_attention`` on the card).
      mesh: the :func:`~.mesh.make_mesh` mesh.  Without one (a world of
        one) the call falls through to ``attn_fn``; a mesh without
        ``axis_name`` raises ``NameError`` rather than attend locally.
    Returns:
      ``[batch, seq_local, heads, head_dim]`` — this rank's output block.
    """
    attn = attn_fn or reference_attention
    if mesh is None:
        return attn(q, k, v, mask=mask, causal=causal)
    group = axis_group(mesh, axis_name)            # NameError here = real misuse
    n = comm.group_size(group)
    if n == 1:
        return attn(q, k, v, mask=mask, causal=causal)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(f"num_heads {heads} must divide by {axis_name}={n}")
    qkv = _seq_to_heads(torch.stack([q, k, v]), group)
    full_mask = None if mask is None else comm.all_gather(mask, group, dim=1)
    out = attn(qkv[0], qkv[1], qkv[2], mask=full_mask, causal=causal)
    return _heads_to_seq(out, group)


def ulysses_self_attention(mesh, q, k, v, mask=None, causal: bool = False,
                           sp_axis: str = "sp", batch_axes=("dp", "fsdp"), attn_fn=None):
    """Global-tensor entry point, the same signature as
    :func:`~.ring_attention.ring_self_attention`: every rank passes the
    whole tensors, the sequence is cut over ``sp_axis`` and the batch over
    ``batch_axes``, :func:`ulysses_attention` runs on the blocks, and every
    rank gets the whole output back."""
    def attn(q, k, v, mask):
        return ulysses_attention(q, k, v, mask, axis_name=sp_axis, causal=causal,
                                 attn_fn=attn_fn, mesh=mesh)

    return _self_attention(attn, mesh, q, k, v, mask, sp_axis, batch_axes)
