"""GPT-style causal decoder, its KV-cache decoding and generation loops.

Port of ``tensorflowonspark_tpu/models/gpt.py``.  Numerics follow the flax
module:

- parameters are float32; Dense layers cast input, weight and bias to
  ``cfg.dtype`` (``models.bert._dense``, which also dequantizes an
  ``ops.quant`` weight at the call);
- LayerNorm and RMSNorm run in float32 at ``cfg.norm_eps`` (flax's 1e-6,
  not torch's 1e-5) and are cast to ``cfg.dtype``; ``ln_f``'s output stays
  float32;
- GELU is the tanh approximation; SwiGLU is ``silu(gate) * up``;
- the logits are a float32 product of the float32 final hidden states and
  the float32 ``tok_emb`` table (the tied head);
- the dense attention route (``grouped_attention``) computes in float32
  with ``where(mask, s, -1e30)``, query heads attending in groups of G per
  K/V head without materialising the repeated K/V;
- ``attention_fn`` (e.g. ``ops.flash_attention``, whose CUDA kernels then
  run causal) gets K/V repeated G times on the head axis
  (``repeat_interleave``, as ``jnp.repeat``), ``causal=True``, and
  ``window=`` when ``sliding_window`` is set.

Decoding: :func:`init_cache` preallocates the static-shape KV cache (a dict
of tensors: ``{"pos": ..., "layers": [{"index", "k", "v"}, ...]}``, the
flax ``cache`` collection's leaves) and ``model(ids, cache=cache)`` writes
it in place.  The JAX loop is one ``lax.scan`` program; here it is a Python
loop over fixed shapes whose cache positions stay on the device, so it can
later be captured in a CUDA graph.  A write the JAX package drops
(``mode="drop"``: an unallocated page, a position past the cache) is routed
here to one scratch row that is never read.

Under ``rolling_kv_cache`` a block of several positions (a prefill)
attends over the ring as it was and the whole block, so every position of
it, and every later token, is exact: the JAX package writes the block
first, which evicts keys the block's early positions need, so past the
window its multi-layer prefill (and the tokens after it) is not (ROADMAP
queue C).

Tensor parallelism: ``GPT(cfg, tp=TensorParallel(group))`` is the module
over one rank's Megatron shards (``parallel.sharding.gpt_partition_rules``,
in ``nn.Linear``'s ``[out, in]`` layout): ``num_heads/tp`` query heads and
``num_kv_heads/tp`` K/V heads (the cache and the paged pool hold those
only), ``intermediate_size/tp`` MLP units and ``vocab_size/tp`` rows of the
tied table.  The biases are held whole, as the JAX package annotates only
kernels: a column-parallel rank adds its slice, a row-parallel bias is
added once after the all-reduce.  The lookup masks the ids outside this
rank's rows and all-reduces; the tied head's ``[B, T, V/tp]`` logits are
all-gathered.  The collectives are Megatron's pair from ``parallel/comm.py``
(``copy_to_group`` before a column-parallel product, ``reduce_from_group``
after a row-parallel one).  Without ``tp`` the module is the whole model.

``remat=True`` checkpoints each block (``torch.utils.checkpoint``);
``scan_layers`` is a parameter layout of the JAX package only
(:func:`params_from_flax` reads both).  Generation functions take the
config and a state dict (tensors, or ``ops.quant`` arrays from
``quantize_params``) and run on the state dict's device; a quantized
``tok_emb`` (a custom predicate) is dequantized whole, for the lookup and
the tied head alike.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.bert import _dropout, _remat
from tensorflowonspark_tpu_torch.ops.quant import _QuantArray
from tensorflowonspark_tpu_torch.parallel import comm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    # Grouped-query attention: number of K/V heads (None = num_heads, plain
    # MHA; 1 = MQA).  The decode and dense paths attend in groups; a custom
    # attention_fn gets K/V repeated to num_heads.
    num_kv_heads: int | None = None
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # "learned" (GPT-2 position table) or "rope" (rotary q/k, rotate-half
    # pairing; K is cached after rotation)
    pos_encoding: str = "learned"
    rope_base: float = 10000.0
    # "layernorm" (GPT-2) or "rmsnorm" (Llama-class)
    norm: str = "layernorm"
    norm_eps: float = 1e-6
    # "gelu" (2-matmul MLP) or "swiglu" (gate/up/down)
    mlp: str = "gelu"
    # attention override for the full-sequence path, signature
    # ``(q, k, v, mask=None, causal=..., [window=...]) -> out`` over
    # [B, T, H, D]; the decode path always uses the dense route
    attention_fn: Callable | None = None
    # a parameter layout of the JAX package (stacked ``layers`` axis)
    scan_layers: bool = False
    # activation checkpointing around each block
    remat: bool = False
    # each token attends to its last ``sliding_window`` positions only
    sliding_window: int | None = None
    # keep only the window in the decode cache (slot = position mod W)
    rolling_kv_cache: bool = False
    # int8 decode cache with a float32 scale per (row, position, head)
    kv_cache_int8: bool = False
    # cache positions per row (``index``/``pos`` are [B] vectors)
    per_row_positions: bool = False
    # paged decode cache: a pool of kv_pool_pages pages of kv_page_tokens
    # tokens a layer and a per-row block table (sentinel kv_pool_pages =
    # unallocated); page accounting is host-side (models.kv_pages)
    kv_page_tokens: int | None = None
    kv_pool_pages: int | None = None

    def __post_init__(self):
        if self.pos_encoding not in ("learned", "rope"):
            raise ValueError(
                f"pos_encoding must be 'learned' or 'rope', "
                f"got {self.pos_encoding!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"norm must be 'layernorm' or 'rmsnorm', got {self.norm!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(
                f"mlp must be 'gelu' or 'swiglu', got {self.mlp!r}")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}")
        if self.rolling_kv_cache and self.sliding_window is None:
            raise ValueError(
                "rolling_kv_cache requires sliding_window to be set")
        if self.per_row_positions and self.rolling_kv_cache:
            raise ValueError(
                "per_row_positions is incompatible with rolling_kv_cache "
                "(rolling slot arithmetic assumes one shared position)")
        if self.kv_page_tokens is not None:
            pt = self.kv_page_tokens
            if pt < 1 or pt & (pt - 1):
                raise ValueError(f"kv_page_tokens must be a positive "
                                 f"power of two, got {pt}")
            if self.max_position_embeddings % pt:
                raise ValueError(
                    f"kv_page_tokens ({pt}) must divide "
                    f"max_position_embeddings "
                    f"({self.max_position_embeddings}) — the block table "
                    "covers whole pages")
            if self.kv_pool_pages is None or self.kv_pool_pages < 1:
                raise ValueError(
                    f"kv_page_tokens needs kv_pool_pages >= 1, got "
                    f"{self.kv_pool_pages!r}")
            if not self.per_row_positions:
                raise ValueError(
                    "kv_page_tokens needs per_row_positions (the block "
                    "table is per-row; ContinuousBatcher sets both)")
            if self.rolling_kv_cache:
                raise ValueError("kv_page_tokens is incompatible with "
                                 "rolling_kv_cache")
            if self.kv_cache_int8:
                raise ValueError(
                    "kv_page_tokens is incompatible with kv_cache_int8 "
                    "(the paged pool stores full-precision K/V; drop one "
                    "of the two)")
        elif self.kv_pool_pages is not None:
            raise ValueError("kv_pool_pages needs kv_page_tokens")
        if self.pos_encoding == "rope" and self.head_dim % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {self.head_dim} "
                f"(hidden_size {self.hidden_size} / num_heads {self.num_heads})")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class TensorParallel:
    """The tensor-parallel group a :class:`GPT` runs over: its process
    group, size and this rank's index in it.  Every rank of the group runs
    the same calls in the same order (the collectives pair up by order)."""

    def __init__(self, group):
        self.group = group
        self.size = comm.group_size(group)
        self.rank = comm.group_rank(group)

    def local(self, n: int, what: str) -> int:
        """This rank's share of ``n`` (heads, units, rows); raises when the
        group does not divide it."""
        if n % self.size:
            raise ValueError(f"{what} ({n}) does not divide over tp={self.size}")
        return n // self.size


def _local(n: int, tp: TensorParallel | None, what: str) -> int:
    return n if tp is None else tp.local(n, what)


def _weight(layer: nn.Linear, dtype):
    """A Dense weight in ``dtype``; an ``ops.quant`` weight is dequantized
    here, at the call."""
    w = layer.weight
    return w.dequantize(dtype) if isinstance(w, _QuantArray) else w.to(dtype)


def _column(layer: nn.Linear, x, dtype, tp: TensorParallel | None):
    """flax ``nn.Dense(dtype=...)`` (input, weight and bias in ``dtype``);
    under ``tp`` column-parallel: this rank's output units, and its slice
    of the whole bias."""
    b = layer.bias
    if tp is not None:
        x = comm.copy_to_group(x, tp.group)
        b = b.chunk(tp.size)[tp.rank]
    return F.linear(x.to(dtype), _weight(layer, dtype), b.to(dtype))


def _row(layer: nn.Linear, x, dtype, tp: TensorParallel | None):
    """flax ``nn.Dense(dtype=...)``; under ``tp`` row-parallel: this rank's
    partial product over its input units, summed over the group, then the
    bias once."""
    if tp is None:
        return F.linear(x.to(dtype), _weight(layer, dtype), layer.bias.to(dtype))
    y = comm.reduce_from_group(F.linear(x.to(dtype), _weight(layer, dtype)), tp.group)
    return y + layer.bias.to(dtype)


def _rope(x, positions, base: float):
    """Rotary embedding: rotate feature pairs (rotate-half) of ``x [B, T,
    H, D]`` by position-dependent angles (``positions [T]``, or ``[B, T]``
    when rows decode at their own offsets).  float32 trig, result in
    ``x.dtype``."""
    half = x.shape[-1] // 2
    freq = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None]                                  # [1, T]
    angles = pos[:, :, None] * freq[None, None, :]       # [B|1, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class _Norm(nn.Module):
    """flax ``LayerNorm``/``RMSNorm(epsilon=cfg.norm_eps, dtype=float32)``:
    float32 in and out (the caller casts)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.rms = cfg.norm == "rmsnorm"
        self.eps = cfg.norm_eps
        self.weight = nn.Parameter(torch.ones(cfg.hidden_size))
        self.bias = None if self.rms else nn.Parameter(torch.zeros(cfg.hidden_size))

    def forward(self, x):
        x, w = x.float(), self.weight.float()
        if self.rms:
            return x * (torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w)
        return F.layer_norm(x, x.shape[-1:], w, self.bias.float(), self.eps)


def _cache_rows(cfg: GPTConfig) -> int:
    """Cache slots a row: the window under ``rolling_kv_cache``, else
    ``max_position_embeddings``."""
    L = cfg.max_position_embeddings
    return min(L, cfg.sliding_window) if cfg.rolling_kv_cache else L


def _store(cfg: GPTConfig, cache: dict, name: str, x, idx, per_row: bool):
    """Write ``x [B, Tw, ...]`` at positions ``idx..idx+Tw-1`` of cache
    leaf ``name`` in place and return the cache's full view ``[B, C, ...]``.

    Dense: one shared position (the start clamped so the block fits, as
    ``dynamic_update_slice``), per-row positions (a position past the cache
    goes to the scratch slot ``C``), or the rolling window (slot = position
    mod C, only the last C of a longer block).  Paged: each position goes
    through the block table to its pool row, or to the scratch row ``P*pt``
    when its page is unallocated or it lies past the cache; the row's
    logical view is read back with one page gather (the sentinel reads page
    ``P-1``, as JAX's clamped gather, hidden by the positional mask)."""
    buf = cache[name]
    x = x.to(buf.dtype)
    Tw = x.shape[1]
    C = _cache_rows(cfg)
    ar = torch.arange(Tw, device=x.device)
    if cfg.kv_page_tokens is not None:
        pt, P = cfg.kv_page_tokens, cfg.kv_pool_pages
        bt = cache["block_table"]
        pos = idx[:, None] + ar[None, :]                          # [B, Tw]
        page = bt.gather(1, (pos // pt).clamp(0, C // pt - 1))
        phys = torch.where((pos < C) & (page < P), page * pt + pos % pt, P * pt)
        buf.index_put_((phys.reshape(-1),), x.reshape(-1, *x.shape[2:]))
        pool = buf[:P * pt].view(P, pt, *buf.shape[1:])
        return pool[bt.clamp(max=P - 1)].reshape(bt.shape[0], C, *buf.shape[1:])
    if per_row:
        slots = idx[:, None] + ar[None, :]
        slots = torch.where(slots < C, slots, C)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        buf[rows, slots] = x
        return buf[:, :C]
    if not cfg.rolling_kv_cache:
        buf.index_copy_(1, idx.clamp(0, C - Tw) + ar, x)
        return buf
    # a block of several positions attends over the ring as it was before
    # the block and the whole block (its early positions need keys that its
    # own write evicts); one position reads the ring after the write
    view = torch.cat([buf, x], dim=1) if Tw > 1 else buf
    if Tw > C:
        x = x[:, Tw - C:]
        slots = (idx + Tw - C + torch.arange(C, device=x.device)) % C
    else:
        slots = (idx + ar) % C
    buf.index_copy_(1, slots, x)
    return view


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        H, D = cfg.num_heads, cfg.head_dim
        Hkv = cfg.num_kv_heads or H
        if H % Hkv:
            raise ValueError(
                f"num_heads ({H}) must be divisible by num_kv_heads ({Hkv})")
        # this rank's heads: whole K/V groups, so query head h still reads
        # K/V head h // G
        self.heads = _local(H, tp, "num_heads")
        self.kv_heads = _local(Hkv, tp, "num_kv_heads")
        self.query = nn.Linear(cfg.hidden_size, self.heads * D)
        self.key = nn.Linear(cfg.hidden_size, self.kv_heads * D)
        self.value = nn.Linear(cfg.hidden_size, self.kv_heads * D)
        self.out = nn.Linear(self.heads * D, cfg.hidden_size)

    def forward(self, x, *, train: bool = False, rng=None, cache: dict | None = None):
        cfg, tp = self.cfg, self.tp
        B, T, _ = x.shape
        H, Hkv, D = self.heads, self.kv_heads, cfg.head_dim
        G = H // Hkv  # query heads per K/V head (1 = MHA, H = MQA)
        decode = cache is not None
        q = _column(self.query, x, cfg.dtype, tp).view(B, T, H, D)
        k = _column(self.key, x, cfg.dtype, tp).view(B, T, Hkv, D)
        v = _column(self.value, x, cfg.dtype, tp).view(B, T, Hkv, D)

        per_row = cfg.per_row_positions and decode
        idx = cache["index"] if decode else None
        ar = torch.arange(T, device=x.device)
        if cfg.pos_encoding == "rope":
            # K is cached after rotation: decode sees the full forward's keys
            if per_row:
                positions = idx[:, None] + ar[None, :]
            else:
                positions = (idx if decode else 0) + ar
            q = _rope(q, positions, cfg.rope_base)
            k = _rope(k, positions, cfg.rope_base)

        def grouped_attention(q, k_all, v_all, mask):
            """``q [B,T,H,D]`` against ``k/v [B,S,Hkv,D]`` in groups of G
            query heads a K/V head; ``mask`` is [T, S] or [B, T, S]."""
            qg = q.reshape(B, T, Hkv, G, D).float()
            s = torch.einsum("btkgd,bskd->bkgts", qg, k_all.float()) * (D ** -0.5)
            m = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
            s = torch.where(m, s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            if not decode:
                p = _dropout(p, cfg.dropout_rate, train, rng)
            ctx = torch.einsum("bkgts,bskd->btkgd", p, v_all.float())
            return ctx.reshape(B, T, H, D)

        if decode:
            L = cfg.max_position_embeddings
            C = _cache_rows(cfg)
            if cfg.kv_cache_int8:
                # int8 values and a float32 scale per (row, position, head),
                # symmetric over D
                def write(name, t):
                    s = t.abs().amax(-1, keepdim=True).float() / 127.0 + 1e-12
                    q8 = torch.round(t.float() / s).to(torch.int8)
                    return (_store(cfg, cache, f"{name}_q", q8, idx, per_row).float()
                            * _store(cfg, cache, f"{name}_s", s, idx, per_row))

                k_all, v_all = write("k", k), write("v", v)
            else:
                k_all = _store(cfg, cache, "k", k, idx, per_row)
                v_all = _store(cfg, cache, "v", v, idx, per_row)
            if per_row:
                q_pos = idx[:, None] + ar[None, :]                   # [B, T]
                k_pos = torch.arange(L, device=x.device)
                visible = k_pos[None, None, :] <= q_pos[:, :, None]  # [B, T, L]
                if cfg.sliding_window is not None:
                    visible &= k_pos[None, None, :] > q_pos[:, :, None] - cfg.sliding_window
            elif cfg.rolling_kv_cache:
                # slot s holds the latest position p(s) = s (mod C) written
                # before the block's end (one position) or its start (a
                # block, whose own positions follow the ring); visible iff
                # written, causal and inside the window
                q_pos = (idx + ar)[:, None]                          # [T, 1]
                p_end = idx + (T - 1 if T == 1 else -1)
                slots = torch.arange(C, device=x.device)
                k_pos = p_end - ((p_end - slots) % C)
                if T > 1:
                    k_pos = torch.cat([k_pos, idx + ar])
                k_pos = k_pos[None, :]
                visible = ((k_pos >= 0) & (k_pos <= q_pos)
                           & (k_pos > q_pos - cfg.sliding_window))
            else:
                q_pos = (idx + ar)[:, None]                          # [T, 1]
                k_pos = torch.arange(L, device=x.device)
                visible = k_pos[None, :] <= q_pos                    # [T, L]
                if cfg.sliding_window is not None:
                    visible &= k_pos[None, :] > q_pos - cfg.sliding_window
            ctx = grouped_attention(q, k_all, v_all, visible)
            idx.add_(T)
        elif cfg.attention_fn is not None:
            if G > 1:  # the kernels take equal head counts: repeat K/V once
                k = k.repeat_interleave(G, dim=2)
                v = v.repeat_interleave(G, dim=2)
            if cfg.sliding_window is None:
                ctx = cfg.attention_fn(q, k, v, causal=True)
            else:
                sig = inspect.signature(cfg.attention_fn).parameters
                if "window" not in sig and not any(
                        p.kind == p.VAR_KEYWORD for p in sig.values()):
                    raise ValueError(
                        "sliding_window is set but attention_fn does not "
                        "accept a window= kwarg (the ring/ulysses wrappers "
                        "don't take one — for ulysses, pass "
                        "attn_fn=partial(flash_attention, window=W) to the "
                        "wrapper instead, or drop sliding_window)")
                ctx = cfg.attention_fn(q, k, v, causal=True, window=cfg.sliding_window)
        else:
            causal = ar[:, None] >= ar[None, :]
            if cfg.sliding_window is not None:
                causal &= ar[None, :] > ar[:, None] - cfg.sliding_window
            ctx = grouped_attention(q, k, v, causal)
        ctx = ctx.to(cfg.dtype).reshape(B, T, H * D)
        return _row(self.out, ctx, cfg.dtype, tp)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.ln1 = _Norm(cfg)
        self.attn = CausalSelfAttention(cfg, tp)
        self.ln2 = _Norm(cfg)
        units = _local(cfg.intermediate_size, tp, "intermediate_size")
        if cfg.mlp == "swiglu":
            self.mlp_gate = nn.Linear(cfg.hidden_size, units)
        self.mlp_up = nn.Linear(cfg.hidden_size, units)
        self.mlp_down = nn.Linear(units, cfg.hidden_size)

    def forward(self, x, *, train: bool = False, rng=None, cache: dict | None = None):
        cfg, tp = self.cfg, self.tp
        y = self.ln1(x).to(cfg.dtype)
        y = self.attn(y, train=train, rng=rng, cache=cache)
        x = x + _dropout(y, cfg.dropout_rate, train, rng)
        y = self.ln2(x).to(cfg.dtype)
        if cfg.mlp == "swiglu":
            y = (F.silu(_column(self.mlp_gate, y, cfg.dtype, tp))
                 * _column(self.mlp_up, y, cfg.dtype, tp))
        else:
            y = F.gelu(_column(self.mlp_up, y, cfg.dtype, tp), approximate="tanh")
        y = _row(self.mlp_down, y, cfg.dtype, tp)
        return x + _dropout(y, cfg.dropout_rate, train, rng)


class GPT(nn.Module):
    """Causal LM: ``input_ids [B, T] -> logits [B, T, V]`` (tied head).

    ``cache=`` (from :func:`init_cache`) runs the incremental path: the call
    consumes the next token(s), writes the cache in place, and positions
    continue from the cache's counters.  ``tp`` (a :class:`TensorParallel`)
    builds the module over this rank's shards (module docstring); the
    logits are whole on every rank."""

    def __init__(self, cfg: GPTConfig, tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.tok_emb = nn.Embedding(_local(cfg.vocab_size, tp, "vocab_size"), cfg.hidden_size)
        if cfg.pos_encoding == "learned":
            self.pos_emb = nn.Parameter(torch.zeros(cfg.max_position_embeddings,
                                                    cfg.hidden_size))
        self.layers = nn.ModuleList(DecoderBlock(cfg, tp) for _ in range(cfg.num_layers))
        self.ln_f = _Norm(cfg)

    def hidden(self, input_ids, *, train: bool = False, rng=None, cache: dict | None = None):
        """Trunk only: ``[B, T] -> [B, T, H]`` final hidden states (after
        ``ln_f``, float32).  Pair with ``ops.tied_softmax_xent(h, table,
        labels)`` to train without materialising ``[B, T, V]`` logits."""
        cfg = self.cfg
        T = input_ids.shape[1]
        x = self._lookup(input_ids).to(cfg.dtype)
        if cfg.pos_encoding == "learned":
            positions = torch.arange(T, device=input_ids.device)
            if cache is not None:
                start = cache["pos"]
                positions = (start[:, None] + positions[None, :] if cfg.per_row_positions
                             else start + positions)
                start.add_(T)
            # a position past the table reads its last row, as JAX's clamped
            # gather does (a parked row of a per-row batch)
            positions = positions.clamp(max=cfg.max_position_embeddings - 1)
            x = x + self.pos_emb[positions].to(cfg.dtype)
        x = _dropout(x, cfg.dropout_rate, train, rng)
        for i, layer in enumerate(self.layers):
            if cache is not None:
                x = layer(x, cache=cache["layers"][i])
            elif cfg.remat and torch.is_grad_enabled():
                x = _remat(layer, x, train, rng)
            else:
                x = layer(x, train=train, rng=rng)
        return self.ln_f(x)

    def forward(self, input_ids, *, train: bool = False, rng=None, cache: dict | None = None):
        x = self.hidden(input_ids, train=train, rng=rng, cache=cache)
        return self.gather_vocab(torch.einsum("bth,vh->btv", x.float(), self._table().float()))

    def _table(self):
        """The tied table (this rank's rows under ``tp``), dequantized when a
        custom predicate quantized it."""
        table = self.tok_emb.weight
        return table.dequantize() if isinstance(table, _QuantArray) else table

    def _lookup(self, ids):
        """Embedding rows of ``ids``; under ``tp`` each rank looks up the
        ids in its rows (zeros elsewhere) and the group sums them."""
        table = self._table()
        if self.tp is None:
            return F.embedding(ids, table)
        rows = table.shape[0]
        local = ids - self.tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = torch.where(mine[..., None], F.embedding(local.clamp(0, rows - 1), table), 0.0)
        return comm.reduce_from_group(x, self.tp.group)

    def gather_vocab(self, logits):
        """Logits over this rank's vocab rows ``[..., V/tp]`` as the whole
        ``[..., V]`` (every rank's block, in rank order); the identity
        without ``tp``."""
        return logits if self.tp is None else comm.gather_from_group(logits, self.tp.group, -1)


# ------------------------------------------------------------------ weights

def _leaf(a) -> np.ndarray:
    """A flax leaf (boxed ``Partitioned`` or not) as a float32 array."""
    return np.array(getattr(a, "value", a), dtype=np.float32)


def params_from_flax(flax_params, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """The JAX package's ``GPT`` parameters (nested dicts of numpy or JAX
    arrays, boxed or not) as this module's ``state_dict``.

    Reads the ``layer_{i}`` layout and the ``scan_layers`` one (a
    ``layers`` subtree whose leaves carry a leading layer axis).  Dense
    kernels ``[in, out]`` become ``nn.Linear`` weights ``[out, in]``;
    tables, norm scales and biases carry over as they are."""
    sd: dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def norm(prefix, p):
        put(f"{prefix}.weight", _leaf(p["scale"]))
        if cfg.norm == "layernorm":
            put(f"{prefix}.bias", _leaf(p["bias"]))

    def dense(prefix, p):
        put(f"{prefix}.weight", _leaf(p["kernel"]).T)
        put(f"{prefix}.bias", _leaf(p["bias"]))

    put("tok_emb.weight", _leaf(flax_params["tok_emb"]["embedding"]))
    if cfg.pos_encoding == "learned":
        put("pos_emb", _leaf(flax_params["pos_emb"]))
    norm("ln_f", flax_params["ln_f"])
    for i in range(cfg.num_layers):
        if f"layer_{i}" in flax_params:
            layer = flax_params[f"layer_{i}"]
            pick = _leaf
        else:
            layer = flax_params["layers"]
            pick = lambda a, i=i: _leaf(a)[i]  # noqa: E731
        sub = lambda p: {k: pick(v) for k, v in p.items()}  # noqa: E731
        norm(f"layers.{i}.ln1", sub(layer["ln1"]))
        norm(f"layers.{i}.ln2", sub(layer["ln2"]))
        for name in ("query", "key", "value", "out"):
            dense(f"layers.{i}.attn.{name}", sub(layer["attn"][name]))
        for name in ("mlp_gate", "mlp_up", "mlp_down"):
            if name in layer:
                dense(f"layers.{i}.{name}", sub(layer[name]))
    return sd


#: flax path -> state-dict name, at the top level and inside a layer
_FLAX_TOP = {"tok_emb/embedding": "tok_emb.weight", "pos_emb": "pos_emb",
             "ln_f/scale": "ln_f.weight", "ln_f/bias": "ln_f.bias"}
_FLAX_LAYER = {f"{m}/{p}": f"{m.replace('/', '.')}.{'bias' if p == 'bias' else 'weight'}"
               for m, ps in [("ln1", ("scale", "bias")), ("ln2", ("scale", "bias"))]
               + [(n, ("kernel", "bias")) for n in ("attn/query", "attn/key", "attn/value",
                                                     "attn/out", "mlp_gate", "mlp_up",
                                                     "mlp_down")]
               for p in ps}


def adapter_from_flax(delta: dict, cfg: GPTConfig) -> dict[str, np.ndarray]:
    """An adapter delta written for the JAX package — keyed by ``"/"``-joined
    flax paths as its ``serving.rollout.apply_adapter`` names them
    (``"layer_0/attn/query/kernel"``, a boxed leaf's ``"/.value"`` suffix
    optional) — as a delta over this module's ``state_dict``, with the
    transposes and per-layer splits of :func:`params_from_flax`: a dense
    kernel ``[in, out]`` becomes ``[out, in]``, a ``scan_layers`` path
    (``"layers/..."``, leading layer axis) one entry per layer.  An unknown
    path raises ``ValueError`` naming it."""
    out: dict[str, np.ndarray] = {}
    for path, value in dict(delta).items():
        arr = np.asarray(_leaf(value))
        key = path.removesuffix("/.value")
        head, _, rest = key.partition("/")
        if key in _FLAX_TOP:
            out[_FLAX_TOP[key]] = np.ascontiguousarray(arr)
            continue
        if rest not in _FLAX_LAYER:
            raise ValueError(f"adapter delta names unknown flax parameter path {path!r}")
        if head == "layers" and arr.shape[:1] == (cfg.num_layers,):   # scan_layers
            per_layer = list(enumerate(arr))
        elif head.removeprefix("layer_").isdigit() \
                and int(head.removeprefix("layer_")) < cfg.num_layers:
            per_layer = [(int(head.removeprefix("layer_")), arr)]
        else:
            raise ValueError(f"adapter delta names unknown flax parameter path {path!r} "
                             f"(shape {arr.shape}, {cfg.num_layers} layers)")
        for i, a in per_layer:
            out[f"layers.{i}.{_FLAX_LAYER[rest]}"] = np.ascontiguousarray(
                a.T if rest.endswith("/kernel") else a)
    return out


def init_params(cfg: GPTConfig, seed: int) -> dict[str, torch.Tensor]:
    """Random ``GPT`` weights drawn with numpy from ``seed`` as the flax
    module initialises them: normal(0, 0.02) kernels and tables, zero
    biases, unit norm scales."""
    rng = np.random.default_rng(seed)
    sd: dict[str, torch.Tensor] = {}
    with torch.device("meta"):  # shapes only, nothing allocated
        shapes = GPT(cfg).state_dict()
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        elif ".ln" in name or name.startswith("ln_f"):
            arr = np.ones(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        sd[name] = torch.from_numpy(arr)
    return sd


def bind(model: GPT, params) -> GPT:
    """``model`` with its weights replaced by ``params``' entries, shared
    rather than copied: tensors, or ``ops.quant`` arrays that the Dense
    layers dequantize at the call.  Every name of the model's state dict
    must be given, and no other."""
    want = {f"{owner}.{attr}" if owner else attr
            for owner, module in model.named_modules() for attr in module._parameters}
    got = set(params)
    if want != got:
        raise KeyError(f"params do not match the model: missing {sorted(want - got)}, "
                       f"unexpected {sorted(got - want)}")
    for name, value in params.items():
        owner, _, attr = name.rpartition(".")
        model.get_submodule(owner)._parameters[attr] = value
    return model


def _device_of(params) -> torch.device:
    leaf = next(iter(params.values()))
    return leaf.device


def _model(cfg: GPTConfig, params, tp: TensorParallel | None = None) -> GPT:
    """An inference ``GPT(cfg, tp)`` over ``params`` (no weights allocated;
    under ``tp`` this rank's shards)."""
    with torch.device("meta"):
        model = GPT(cfg, tp)
    return bind(model, params).eval()


# ------------------------------------------------------------------ decoding

def init_cache(cfg: GPTConfig, params, batch: int, tp: TensorParallel | None = None) -> dict:
    """Allocate the static KV cache for ``batch`` rows on ``params``'
    device, zeroed; under ``kv_page_tokens`` the block tables start at the
    unallocated sentinel (``kv_pool_pages``) — zeros would alias every row
    onto physical page 0.  A per-row cache has one scratch slot a row past
    the end, and a paged pool one scratch row, for the dropped writes.
    Under ``tp`` it holds this rank's K/V heads only."""
    dev = _device_of(params)
    per_row = cfg.per_row_positions
    Hkv, D = _local(cfg.num_kv_heads or cfg.num_heads, tp, "num_kv_heads"), cfg.head_dim
    C = _cache_rows(cfg) + (1 if per_row else 0)

    def counter():
        return torch.zeros((batch,) if per_row else (), dtype=torch.long, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        lc = {"index": counter()}
        if cfg.kv_page_tokens is not None:
            pt, P = cfg.kv_page_tokens, cfg.kv_pool_pages
            lc["block_table"] = torch.full((batch, cfg.max_position_embeddings // pt), P,
                                           dtype=torch.long, device=dev)
            for name in ("k", "v"):
                lc[name] = torch.zeros((P * pt + 1, Hkv, D), dtype=cfg.dtype, device=dev)
        elif cfg.kv_cache_int8:
            for name in ("k", "v"):
                lc[f"{name}_q"] = torch.zeros((batch, C, Hkv, D), dtype=torch.int8, device=dev)
                lc[f"{name}_s"] = torch.zeros((batch, C, Hkv, 1), dtype=torch.float32,
                                              device=dev)
        else:
            for name in ("k", "v"):
                lc[name] = torch.zeros((batch, C, Hkv, D), dtype=cfg.dtype, device=dev)
        layers.append(lc)
    cache = {"layers": layers}
    if cfg.pos_encoding == "learned":
        cache["pos"] = counter()
    return cache


def rewind_cache(cache: dict, position) -> dict:
    """Set every position counter (each layer's write ``index`` and the
    learned-position ``pos``) to ``position``, in place; K/V are untouched
    — by-position causal masking plus the next block's write retire the
    entries past it (:func:`lookup_generate`).  ``position`` is a scalar,
    or a ``[B]`` tensor or array that rewinds each row of a per-row cache
    to its own position (the continuous batcher's padded prefill)."""
    counters = [lc["index"] for lc in cache["layers"]]
    if "pos" in cache:
        counters.append(cache["pos"])
    if not torch.is_tensor(position) and np.ndim(position) == 0:
        for c in counters:
            c.fill_(position)
    else:
        position = torch.as_tensor(position)
        for c in counters:
            c.copy_(position)
    return cache


def _check_length(cfg: GPTConfig, T0: int, max_new_tokens: int) -> None:
    total = T0 + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds max_position_embeddings ({cfg.max_position_embeddings});"
            " the static cache/position table cannot hold the sequence")


def _prompt(prompt_ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompt_ids) if not torch.is_tensor(prompt_ids)
                           else prompt_ids).to(device=device, dtype=torch.long)


@torch.no_grad()
def _generate(cfg: GPTConfig, params, prompt_ids, max_new_tokens: int, next_token_fn,
              tp: TensorParallel | None = None):
    """Shared decode loop: prefill once, then single-token steps against
    the KV cache; ``next_token_fn(logits [B, V], step) -> [B]`` picks each
    next token.  Returns ``[B, T0 + max_new_tokens]`` ids."""
    prompt = _prompt(prompt_ids, _device_of(params))
    B, T0 = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    _check_length(cfg, T0, max_new_tokens)
    model = _model(cfg, params, tp)
    cache = init_cache(cfg, params, B, tp)
    out = torch.empty((B, max_new_tokens), dtype=prompt.dtype, device=prompt.device)
    tok = next_token_fn(model(prompt, cache=cache)[:, -1], 0)
    out[:, 0] = tok
    for i in range(1, max_new_tokens):
        tok = next_token_fn(model(tok[:, None], cache=cache)[:, -1], i)
        out[:, i] = tok
    return torch.cat([prompt, out], dim=1)


def greedy_generate(cfg: GPTConfig, params, prompt_ids, max_new_tokens: int, *,
                    tp: TensorParallel | None = None):
    """Greedy decode (argmax each step); see :func:`_generate`.  Under
    ``tp`` every rank of the group calls it on its shards and gets the
    whole ids."""
    return _generate(cfg, params, prompt_ids, max_new_tokens,
                     lambda logits, i: torch.argmax(logits, dim=-1), tp)


@torch.no_grad()
def lookup_generate(cfg: GPTConfig, params, prompt_ids, max_new_tokens: int, *,
                    ngram: int = 3, draft_len: int = 8, return_stats: bool = False):
    """Prompt-lookup speculative decoding: the tokens of
    :func:`greedy_generate` in fewer sequential forwards.

    Each step drafts ``draft_len`` tokens (the continuation of the most
    recent earlier match of the last ``ngram`` tokens), verifies them in
    one cached forward over ``draft_len + 1`` positions, keeps the agreed
    prefix (the batch minimum) and rewinds the cache counters to the
    committed length.  Returns ``[B, T0 + max_new_tokens]`` ids (and
    ``{"forwards": n}``, the verify steps after the prefill, with
    ``return_stats=True``)."""
    prompt = _prompt(prompt_ids, _device_of(params))
    B, T0 = prompt.shape
    if max_new_tokens <= 0:
        return (prompt, {"forwards": 0}) if return_stats else prompt
    if ngram < 1 or draft_len < 1:
        raise ValueError(f"ngram ({ngram}) and draft_len ({draft_len}) "
                         "must be >= 1")
    if cfg.rolling_kv_cache:
        raise ValueError("lookup_generate does not support "
                         "rolling_kv_cache (the rewind protocol assumes "
                         "absolute cache slots)")
    total = T0 + max_new_tokens
    k, g = draft_len, ngram
    if total + k > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt + max_new_tokens + draft_len = {total + k} exceeds "
            f"max_position_embeddings ({cfg.max_position_embeddings}); "
            "the verify block needs draft_len slack past the sequence")
    dev = prompt.device
    Lbuf = total + k  # committed tokens + scratch for one verify block
    starts = torch.arange(Lbuf - g, device=dev)
    windows = starts[:, None] + torch.arange(g, device=dev)[None, :]
    offsets = torch.arange(k, device=dev)[None, :]

    def draft(toks, p: int):
        """Most recent window of the last ``g`` tokens inside ``toks[:, :p+1]``
        whose continuation ends at or before ``p``; its continuation is the
        draft, repeating the final token past the known prefix.  Before ``g``
        tokens are committed the suffix window starts at 0."""
        win = toks[:, windows]                                   # [B, S, g]
        lo = max(p + 1 - g, 0)
        hit = (win == toks[:, None, lo:lo + g]).all(-1)
        hit &= (starts + g <= p)[None, :]
        best = torch.argmax(hit * (starts + 1)[None, :], dim=-1)  # [B]
        src = best[:, None] + g + offsets
        src = torch.where(hit.any(-1)[:, None], src.clamp(max=p), p)
        return toks.gather(1, src)                               # [B, k]

    model = _model(cfg, params)
    cache = init_cache(cfg, params, B)
    toks = torch.zeros((B, Lbuf), dtype=prompt.dtype, device=dev)
    toks[:, :T0] = prompt
    pending = torch.argmax(model(prompt, cache=cache)[:, -1], dim=-1)
    p, n_fwd = T0, 0
    while p < total:
        toks[:, p] = pending
        drafts = draft(toks, p)
        preds = torch.argmax(model(torch.cat([pending[:, None], drafts], 1), cache=cache),
                             dim=-1)                             # [B, k+1]
        agree = torch.cumprod((preds[:, :-1] == drafts).long(), dim=1)
        a = int(agree.sum(1).min())  # batch-min acceptance
        toks[:, p + 1:p + 1 + k] = drafts
        pending = preds[:, a]
        p += 1 + a
        rewind_cache(cache, p)
        n_fwd += 1
    out = toks[:, :total]
    return (out, {"forwards": n_fwd}) if return_stats else out


def _select_beam(scores, lengths, length_penalty: float):
    """argmax over beams of ``score / generated_len**length_penalty``
    (modern HF's normalisation); raw-score argmax when the penalty is 0."""
    sel = scores if length_penalty == 0.0 else scores / lengths.float() ** length_penalty
    return torch.argmax(sel, dim=-1)


def _map_cache_batch(cache: dict, batch: int, fn) -> dict:
    """``fn(x)`` over every cache leaf whose leading axis is ``batch`` (the
    JAX package's rule; the shared scalar counters fall through)."""
    def visit(x):
        return fn(x) if x.dim() > 0 and x.shape[0] == batch else x
    out = {k: visit(v) for k, v in cache.items() if k != "layers"}
    out["layers"] = [{k: visit(v) for k, v in lc.items()} for lc in cache["layers"]]
    return out


@torch.no_grad()
def beam_generate(cfg: GPTConfig, params, prompt_ids, max_new_tokens: int, *,
                  num_beams: int = 4, eos_id: int | None = None,
                  length_penalty: float = 0.0, return_scores: bool = False):
    """Beam-search decode.  Beams ride the batch axis (``B·K`` rows): the
    prompt is prefilled once at batch ``B`` and the cache tiled to ``B·K``;
    each step's beam reorder gathers the cache rows by beam parent.  With
    ``eos_id`` a finished beam is frozen (only its EOS continuation
    survives, score unchanged).  Returns the best beam ``[B, T0 +
    max_new_tokens]`` (and its raw log-prob sum ``[B]`` when
    ``return_scores``); ``length_penalty`` selects by ``score /
    generated_len**length_penalty``."""
    prompt = _prompt(prompt_ids, _device_of(params))
    B, T0 = prompt.shape
    K = int(num_beams)
    if K < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} out of range for vocab_size {cfg.vocab_size}")
    if max_new_tokens <= 0:
        return (prompt, torch.zeros(B, device=prompt.device)) if return_scores else prompt
    total = T0 + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds max_position_embeddings ({cfg.max_position_embeddings})")
    dev = prompt.device
    V, N = cfg.vocab_size, max_new_tokens
    model = _model(cfg, params)
    cache = init_cache(cfg, params, B)
    logp0 = torch.log_softmax(model(prompt, cache=cache)[:, -1].float(), dim=-1)
    cache = _map_cache_batch(cache, B, lambda x: x.repeat_interleave(K, dim=0))
    frozen = None
    if eos_id is not None:
        frozen = torch.full((V,), NEG_INF, device=dev)
        frozen[eos_id] = 0.0

    # beam 0 holds the top-1, beams 1.. the runners-up; all live
    scores, tok = torch.topk(logp0, K, dim=-1)                  # [B, K] each
    seqs = torch.zeros((B, K, N), dtype=torch.long, device=dev)
    seqs[:, :, 0] = tok
    finished = (tok == eos_id) if eos_id is not None else torch.zeros_like(tok, dtype=torch.bool)
    lengths = torch.ones((B, K), dtype=torch.long, device=dev)  # generated incl. EOS
    rows = torch.arange(B, device=dev)[:, None] * K
    for i in range(1, N):
        logits = model(tok.reshape(B * K)[:, None], cache=cache)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)
        if frozen is not None:
            logp = torch.where(finished[:, :, None], frozen[None, None], logp)
        scores, idx = torch.topk((scores[:, :, None] + logp).reshape(B, K * V), K, dim=-1)
        parent, tok = idx // V, idx % V
        seqs = seqs.gather(1, parent[:, :, None].expand(B, K, N)).clone()
        seqs[:, :, i] = tok
        was_finished = finished.gather(1, parent)
        finished = was_finished | (tok == eos_id) if eos_id is not None else was_finished
        # a beam not finished BEFORE this token grew to i+1 tokens
        lengths = torch.where(was_finished, lengths.gather(1, parent), i + 1)
        flat_parent = (rows + parent).reshape(B * K)
        cache = _map_cache_batch(cache, B * K, lambda x: x.index_select(0, flat_parent))
    best = _select_beam(scores, lengths, length_penalty)       # [B]
    out = torch.cat([prompt, seqs[torch.arange(B, device=dev), best]], dim=1)
    if return_scores:
        return out, scores.gather(1, best[:, None])[:, 0]
    return out


def nucleus_filter(logits, top_p):
    """Top-p (nucleus) truncation of (temperature-scaled) logits: keep the
    smallest descending-sorted prefix whose mass reaches ``top_p`` (the top
    token always survives), the rest to ``-inf``; tokens tied at the cutoff
    logit are all kept.  Works on ``[..., V]``."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p  # mass BEFORE this token
    kept_min = torch.where(keep_sorted, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < kept_min, -math.inf, logits)


def sample_generate(cfg: GPTConfig, params, prompt_ids, max_new_tokens: int,
                    generator: torch.Generator, *, temperature: float = 1.0,
                    top_k: int | None = None, top_p: float | None = None):
    """Stochastic decode: temperature-scaled categorical sampling with
    optional top-k and/or top-p truncation (top-k first, the HF order).
    ``generator`` (a ``torch.Generator`` on the params' device) draws every
    step's Gumbel noise, so one seed gives one rollout; it cannot
    reproduce JAX's token stream."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def next_token(logits, i):
        if top_k is not None:  # rank-invariant: before or after temperature
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, -math.inf, logits)
        if temperature == 0.0:  # the greedy limit
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_p is not None and top_p < 1.0:
            logits = nucleus_filter(logits, top_p)
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits + gumbel, dim=-1)

    return _generate(cfg, params, prompt_ids, max_new_tokens, next_token)
