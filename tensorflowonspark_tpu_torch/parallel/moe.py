"""Mixture-of-experts with expert parallelism over the ``ep`` mesh axis.

Port of ``tensorflowonspark_tpu/parallel/moe.py``: a GShard/Switch-style
MoE FFN where each ``ep`` rank owns ``num_experts / ep`` expert FFNs and
tokens travel to their experts and back by two all-to-all exchanges over
the ``ep`` group (:func:`~.comm.all_to_all_exchange`, whose backward is the
inverse exchange).  Capacity is fixed, so every tensor's shape is static.

The layer keeps the JAX layer's semantics exactly:

1. router logits in float32 → softmax → top-k experts a token, ties to
   the lower expert index (``lax.top_k``'s order);
2. slots by priority, a cumulative sum over the flattened (token, choice)
   order; choices past an expert's capacity ``C`` are dropped (zero
   combine weight; the residual path carries them);
3. the GShard load-balancing loss;
4. dispatch into ``[experts, C, hidden]`` buffers, the exchange, the
   expert FFNs (tanh GELU, ``jax.nn.gelu``'s default), the return
   exchange, and the gate-weighted combine.

The JAX layer dispatches and combines with one-hot einsums over ``[tokens,
experts, C]``; here each kept (token, choice) is an index into the ``E x C``
slots — one gather in, one gather out — which moves the same rows with
the same drops.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.parallel import comm
from tensorflowonspark_tpu_torch.parallel.mesh import axis_group, group_over
from tensorflowonspark_tpu_torch.parallel.sharding import P


def _from_experts(x, group):
    """The return exchange: ``[n, experts_local, C, H]`` (outputs by source
    rank) → ``[n, experts_local, C, H]`` (this rank's slots by owner).  A
    function of its own so that a check can replace it with a faulty one."""
    return comm.all_to_all_exchange(x, group, split_dim=0, concat_dim=0)


def _top_k(probs, k: int):
    """``lax.top_k``: the ``k`` largest values of the last dim and their
    indices, equal values in index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def make_moe_layer(hidden: int, ffn: int, num_experts: int, *, top_k: int = 2,
                   capacity_factor: float = 1.25, ep: int = 1, ep_axis: str = "ep",
                   dtype=torch.float32, mesh=None):
    """Build an expert-parallel MoE FFN layer.

    Returns ``(moe_fn, init_fn, param_specs)``:

    - ``moe_fn(params, x)`` — ``x`` is this rank's tokens ``[tokens_local,
      hidden]``; ``params`` its blocks (router whole, expert stacks
      ``[num_experts / ep, ...]``); returns ``(y, aux_loss)``, the
      load-balancing loss of this rank's tokens;
    - ``init_fn(seed)`` — FULL parameter shapes drawn with numpy (router
      ``[hidden, num_experts]`` float32, expert stacks ``[num_experts, ...]``
      in ``dtype``); cut each with :func:`~.sharding.local_block` by its spec;
    - ``param_specs`` — router ``P()``, expert stacks ``P(ep_axis, None,
      None)``.

    ``num_experts`` must divide by ``ep``, the size of ``mesh``'s
    ``ep_axis``; without ``mesh`` every expert is local (the JAX layer
    outside ``shard_map``).
    """
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} must divide by ep {ep}")
    experts_local = num_experts // ep
    group = None if mesh is None else axis_group(mesh, ep_axis)
    n_ep = 1 if group is None else comm.group_size(group)
    if n_ep not in (1, ep):
        raise ValueError(f"the mesh's {ep_axis!r} axis has {n_ep} ranks, the layer ep={ep}")

    def init_fn(seed: int):
        rng = np.random.default_rng(seed)

        def normal(shape, scale, dt):
            return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                    * np.float32(scale)).to(dt)
        return {"router": normal((hidden, num_experts), 0.02, torch.float32),
                "win": normal((num_experts, hidden, ffn), 1.0 / math.sqrt(hidden), dtype),
                "wout": normal((num_experts, ffn, hidden), 1.0 / math.sqrt(ffn), dtype)}

    param_specs = {"router": P(), "win": P(ep_axis, None, None),
                   "wout": P(ep_axis, None, None)}

    def moe_fn(params, x):
        t_local = x.shape[0]
        capacity = max(1, int(capacity_factor * t_local * top_k / num_experts))

        # ---- routing (float32 for a stable softmax) ----
        probs = torch.softmax(x.float() @ params["router"], dim=-1)       # [T, E]
        gate_vals, gate_idx = _top_k(probs, top_k)                        # [T, k]

        # ---- capacity-bounded slots: earlier tokens, then earlier choices ----
        mask = F.one_hot(gate_idx, num_experts).float()                   # [T, k, E]
        flat = mask.reshape(t_local * top_k, num_experts)
        pos = (torch.cumsum(flat, dim=0) - flat).reshape(mask.shape)      # slot a choice
        keep = mask * (pos < capacity)                                     # dropped -> 0

        # GShard aux loss: fraction of tokens x mean probability, by expert
        frac_tokens = keep.sum((0, 1)) / keep.sum().clamp(min=1.0)
        aux_loss = num_experts * torch.sum(frac_tokens * probs.mean(0))

        # each choice's slot e * C + c; kept choices hold distinct slots
        slot_pos = (pos * mask).sum(-1).long()                            # [T, k]
        kept = keep.sum(-1)                                                # [T, k] 0/1
        slot = torch.where(kept > 0, gate_idx * capacity + slot_pos, 0)

        # ---- dispatch: [E * C, H] buffers, empty slots zero ----
        tokens = torch.arange(t_local, device=x.device)[:, None].expand(-1, top_k)
        sel = kept.reshape(-1) > 0
        src = torch.zeros(num_experts * capacity, dtype=torch.long, device=x.device)
        filled = torch.zeros(num_experts * capacity, dtype=torch.bool, device=x.device)
        src[slot.reshape(-1)[sel]] = tokens.reshape(-1)[sel]
        filled[slot.reshape(-1)[sel]] = True
        expert_in = torch.where(filled[:, None], x.float()[src], 0.0)
        expert_in = expert_in.reshape(num_experts, capacity, hidden)

        # ---- to the experts' owners ----
        if n_ep > 1:
            expert_in = comm.all_to_all_exchange(
                expert_in.reshape(n_ep, experts_local, capacity, hidden), group,
                split_dim=0, concat_dim=0)
            expert_in = expert_in.transpose(0, 1).reshape(experts_local, n_ep * capacity,
                                                          hidden)
        h = F.gelu(torch.bmm(expert_in.to(dtype), params["win"]), approximate="tanh")
        expert_out = torch.bmm(h, params["wout"]).float()                  # [e_l, n*C, H]
        if n_ep > 1:
            expert_out = expert_out.reshape(experts_local, n_ep, capacity, hidden)
            expert_out = _from_experts(expert_out.transpose(0, 1), group)
        expert_out = expert_out.reshape(num_experts * capacity, hidden)

        # ---- combine: each kept choice's output, weighted by its gate ----
        weight = gate_vals.float() * kept                                  # [T, k]
        y = (weight[..., None] * expert_out[slot]).sum(1)
        return y.to(x.dtype), aux_loss.to(x.dtype)

    return moe_fn, init_fn, param_specs


class _MeanOverGroup(torch.autograd.Function):
    """Mean over ``group`` whose backward is the same mean: every rank's
    loss counts the averaged value once, and the strategy averages the
    ranks' losses, so each rank's input receives the mean of the ranks'
    cotangents (``lax.pmean``'s transpose under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = comm.group_size(group)
        return comm.all_reduce(x.clone(), group) / n

    @staticmethod
    def backward(ctx, grad):
        n = comm.group_size(ctx.group)
        return comm.all_reduce(grad.clone(), ctx.group) / n, None


def moe_apply(mesh, moe_fn, params, x, *, param_specs, data_axes=("dp", "fsdp"),
              ep_axis: str = "ep"):
    """``moe_fn`` on this rank's tokens, the aux loss averaged over every
    token axis.

    ``x``: this rank's tokens ``[tokens_local, hidden]`` (flatten ``[B, T,
    H]`` first), its block over ``data_axes`` and ``ep_axis``: the ``ep``
    ranks act as extra data parallelism outside the expert FFNs, each
    routing its own tokens, and the two exchanges move them to and from
    the experts' owners.  ``params``: this rank's blocks under
    ``param_specs``.  Returns ``(y, aux_loss)``, ``y`` this rank's rows and
    ``aux_loss`` the mean over the token shards (the same on every rank).
    With :class:`~.strategy.MeshStrategy` the replicated router's gradient
    is summed over the token axes and the expert stacks' over the data
    axes: the gradients of the JAX layer's global mean."""
    del param_specs                               # the blocks are already cut
    y, aux = moe_fn(params, x)
    group = group_over(mesh, (*data_axes, ep_axis))
    if comm.group_size(group) > 1:
        aux = _MeanOverGroup.apply(aux, group)
    return y, aux
