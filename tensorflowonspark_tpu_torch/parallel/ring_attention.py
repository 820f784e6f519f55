"""Ring attention: sequence/context parallelism over a mesh axis.

Port of ``tensorflowonspark_tpu/parallel/ring_attention.py``.  The
sequence is cut over the ``sp`` axis of a mesh; each rank holds its
Q/K/V block, and the K/V blocks (with their padding mask) travel around
the ring, one hop a step, while a numerically stable online softmax
accumulates partial attention (the Ring Attention / blockwise-attention
construction).  Causal masking uses *global* positions: a rank's queries
start at ``rank * T_local``.

The online softmax is plain PyTorch, in float32, as the JAX package's is
XLA-lowered (not a Pallas kernel).  The hop is
:func:`~.comm.ring_shift`, an autograd node whose backward is the
reverse hop, the transpose JAX takes of ``lax.ppermute``; so the
gradients of a rank's K/V block come home from every rank that attended
to it.  Every rank attends to every block, even one that causal masking
hides entirely (as the reference does): a rank that skipped one would
leave its hop's output unused, its backward would never run the reverse
hop, and the rank that sent the block would wait for it forever.

Memory a rank: the autograd graph keeps each visited block's float32
scores and probabilities, ``[B, H, T_local, T_local]`` a hop.
"""

from __future__ import annotations

import math

import torch

from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel.mesh import axis_group

NEG_INF = -1e30  # large-negative mask value (avoids -inf − -inf = nan)


def _global_positions(block: int, length: int) -> torch.Tensor:
    """The global positions of block ``block`` of ``length`` tokens."""
    return block * length + torch.arange(length)


def _ring(mesh, axis_name: str):
    """``(group, size, rank)`` of ``axis_name``: a world of one without a
    mesh (the reference outside ``shard_map``)."""
    if mesh is None:
        return None, 1, 0
    group = axis_group(mesh, axis_name)
    return group, comm.group_size(group), comm.group_rank(group)


def ring_attention(q, k, v, mask=None, axis_name: str = "sp", causal: bool = False,
                   scale: float | None = None, mesh=None):
    """Attention over a sequence cut on ``mesh``'s ``axis_name``.

    Args:
      q, k, v: this rank's blocks ``[batch, seq_local, heads, head_dim]``.
      mask: optional key-padding mask block ``[batch, seq_local]`` (True =
        attend); it travels around the ring with its k/v block.
      causal: apply a causal mask using *global* positions.
      mesh: the :func:`~.mesh.make_mesh` mesh; ``None`` is a world of one.
        A mesh without ``axis_name`` raises ``NameError``.
    Returns:
      ``[batch, seq_local, heads, head_dim]`` — this rank's output block.
    """
    group, n, my = _ring(mesh, axis_name)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    q32 = q.float()
    q_pos = _global_positions(my, Tq)
    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    k_cur, v_cur, mask_cur = k, v, mask
    for i in range(n):
        # after i hops this rank holds the block that started at (my - i) % n
        src = (my - i) % n
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k_cur.float()) * scale
        if causal:
            k_pos = _global_positions(src, Tk)
            visible = (q_pos[:, None] >= k_pos[None, :]).to(q.device, non_blocking=True)
            s = torch.where(visible[None, None], s, NEG_INF)
        if mask_cur is not None:
            s = torch.where(mask_cur[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        o = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_cur.float()))
        m = m_new
        if i < n - 1:
            k_cur = comm.ring_shift(k_cur, group)
            v_cur = comm.ring_shift(v_cur, group)
            if mask_cur is not None:
                mask_cur = comm.shift(mask_cur, group)
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _self_attention(attn, mesh, q, k, v, mask, sp_axis, batch_axes):
    """Cut global ``q, k, v`` (every rank holds them whole) into this
    rank's batch and sequence block, run ``attn`` on the blocks and gather
    the output back; the gradients of ``q, k, v`` come back whole on every
    rank (:func:`~.comm.scatter_to_group` / :func:`~.comm.gather_from_group`)."""
    seq = axis_group(mesh, sp_axis)
    batch = [axis_group(mesh, a) for a in batch_axes]

    def scatter(x, seq_dim=1):
        for g in batch:
            x = comm.scatter_to_group(x, g, 0)
        return comm.scatter_to_group(x, seq, seq_dim)

    qs, ks, vs = (scatter(x) for x in (q, k, v))
    ms = None if mask is None else scatter(mask)
    out = comm.gather_from_group(attn(qs, ks, vs, ms), seq, 1)
    for g in reversed(batch):
        out = comm.gather_from_group(out, g, 0)
    return out


def ring_self_attention(mesh, q, k, v, mask=None, causal: bool = False,
                        sp_axis: str = "sp", batch_axes=("dp", "fsdp")):
    """Global-tensor entry point: every rank passes the whole ``q, k, v``
    ``[batch, seq, heads, head_dim]`` (and ``[batch, seq]`` ``mask``); the
    sequence is cut over ``sp_axis`` and the batch over ``batch_axes``,
    :func:`ring_attention` runs on the blocks, and every rank gets the
    whole output back (the JAX package's ``shard_map`` over global
    arrays)."""
    def attn(q, k, v, mask):
        return ring_attention(q, k, v, mask, axis_name=sp_axis, causal=causal, mesh=mesh)

    return _self_attention(attn, mesh, q, k, v, mask, sp_axis, batch_axes)


def reference_attention(q, k, v, mask=None, causal: bool = False,
                        scale: float | None = None):
    """Dense single-device attention, the numerical oracle."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(T, device=q.device)
        s = torch.where((pos[:, None] >= pos[None, :])[None, None], s, NEG_INF)
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
