"""Manual-SPMD transformer stage: Megatron tensor parallelism + sequence
parallelism (ring or Ulysses attention).

Port of ``tensorflowonspark_tpu/parallel/transformer.py``.  One rank a
(``tp``, ``sp``) cell of the mesh runs :func:`make_transformer_stage`'s
``stage_fn`` on its block:

- ``tp`` cuts attention heads and MLP hidden units Megatron-style —
  column-parallel in, row-parallel out, one all-reduce a sublayer;
- ``sp`` cuts the sequence, attention running over the whole of it
  through :func:`~.ring_attention.ring_attention` or
  :func:`~.ulysses.ulysses_attention`;
- ``dp``/``fsdp`` cut the batch (their gradient sum is the strategy's).

JAX gets the gradients of this right for free: ``lax.psum`` under
``shard_map`` transposes to the identity, and the replicated input of a
column-parallel product gets the sum of its ranks' cotangents.  Eager
PyTorch needs Megatron's conjugate pair written out
(:func:`~.comm.copy_to_group` before the column-parallel weights: identity
forward, all-reduce backward; :func:`~.comm.reduce_from_group` after the
row-parallel ones: all-reduce forward, identity backward).  Without the
first, the gradients of ``x`` and of the LayerNorm parameters would be one
rank's partial sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel.mesh import axis_group
from tensorflowonspark_tpu_torch.parallel.ring_attention import ring_attention
from tensorflowonspark_tpu_torch.parallel.sharding import P


def _layer_norm(x, scale, bias, eps: float = 1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def make_transformer_stage(hidden: int, num_heads: int, ffn: int, *, tp: int = 1,
                           head_dim: int | None = None, causal: bool = False,
                           tp_axis: str = "tp", sp_axis: str = "sp", sp_impl: str = "ring",
                           dtype=torch.float32, mesh=None):
    """Build a transformer stage (pre-LN attention + MLP).

    Returns ``(stage_fn, init_fn, param_specs)``:

    - ``stage_fn(params, x)`` — ``params`` this rank's shards (see
      ``param_specs``), ``x`` its block ``[batch_local, seq_local,
      hidden]``; heads and MLP units on ``1/tp`` shards with one
      all-reduce a sublayer over ``mesh``'s ``tp_axis``, attention over the
      whole ``sp_axis``-cut sequence;
    - ``init_fn(seed)`` — one stage's parameters at FULL shapes, drawn with
      numpy (as torch tensors; cut each with
      :func:`~.sharding.local_block` by its spec);
    - ``param_specs`` — the specs of the parameters (column-parallel
      weights' head or unit axis over ``tp``, row-parallel weights' input
      axis over ``tp``, norms replicated).

    ``num_heads`` must divide by ``tp`` (each tp rank owns whole heads).
    ``sp_impl`` picks the sequence-parallel attention: ``"ring"`` or
    ``"ulysses"`` (which needs ``num_heads/tp`` divisible by the ``sp``
    size).  Without ``mesh`` the stage runs on one rank.
    """
    head_dim = head_dim or hidden // num_heads
    if num_heads % tp:
        raise ValueError(f"num_heads {num_heads} must divide by tp {tp}")
    if ffn % tp:
        raise ValueError(f"ffn {ffn} must divide by tp {tp}")
    if sp_impl == "ring":
        def sp_attn(q, k, v):
            return ring_attention(q, k, v, axis_name=sp_axis, causal=causal, mesh=mesh)
    elif sp_impl == "ulysses":
        from tensorflowonspark_tpu_torch.parallel.ulysses import ulysses_attention

        def sp_attn(q, k, v):
            return ulysses_attention(q, k, v, axis_name=sp_axis, causal=causal, mesh=mesh)
    else:
        raise ValueError(f"unknown sp_impl {sp_impl!r} "
                         "(expected 'ring' or 'ulysses')")
    tp_group = None if mesh is None else axis_group(mesh, tp_axis)

    def copy_in(h):
        return h if tp_group is None else comm.copy_to_group(h, tp_group)

    def reduce_out(h):
        return h if tp_group is None else comm.reduce_from_group(h, tp_group)

    def init_fn(seed: int):
        rng = np.random.default_rng(seed)
        sd = 1.0 / math.sqrt(hidden)

        def normal(shape, scale):
            return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                    * np.float32(scale)).to(dtype)
        return {
            "ln1": {"scale": torch.ones(hidden), "bias": torch.zeros(hidden)},
            # [hidden, 3, heads, head_dim] so the HEAD axis cuts over tp
            "wqkv": normal((hidden, 3, num_heads, head_dim), sd),
            "wo": normal((num_heads, head_dim, hidden), sd),
            "ln2": {"scale": torch.ones(hidden), "bias": torch.zeros(hidden)},
            "wup": normal((hidden, ffn), sd),
            "wdown": normal((ffn, hidden), 1.0 / math.sqrt(ffn)),
        }

    param_specs = {
        "ln1": {"scale": P(), "bias": P()},
        "wqkv": P(None, None, tp_axis, None),
        "wo": P(tp_axis, None, None),
        "ln2": {"scale": P(), "bias": P()},
        "wup": P(None, tp_axis),
        "wdown": P(tp_axis, None),
    }

    def stage_fn(params, x):
        # ---- attention sublayer (pre-LN, residual) ----
        h = copy_in(_layer_norm(x, **params["ln1"]))
        # wqkv local block: [hidden, 3, heads/tp, head_dim]
        qkv = torch.einsum("bth,hkjd->btkjd", h, params["wqkv"])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o = sp_attn(q, k, v)
        attn = reduce_out(torch.einsum("btjd,jdm->btm", o, params["wo"]))
        x = x + attn.to(x.dtype)
        # ---- MLP sublayer ----
        h = copy_in(_layer_norm(x, **params["ln2"]))
        up = F.gelu(h @ params["wup"], approximate="tanh")   # [b, t, ffn/tp]
        down = reduce_out(up @ params["wdown"])
        return x + down.to(x.dtype)

    return stage_fn, init_fn, param_specs
