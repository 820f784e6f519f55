"""Int8 and int4 weight-only quantization for memory-bound decoding.

Port of ``tensorflowonspark_tpu/ops/quant.py``.  Decoding reads
every weight once a token, so its speed is bounded by the bytes of the
weights; int8 halves them against bf16, int4 quarters them.

PyTorch has no ``__jax_array__`` hook and no int4 dtype, so the wrappers
here are plain objects holding ``q`` and ``scale`` tensors, and the
consumer dequantizes them at the call: ``models.bert._dense`` (which the
GPT port uses too) calls :meth:`_QuantArray.dequantize` on a quantized
weight.  In eager PyTorch the dequantized bf16 copy is materialised at
every call; XLA fuses it into the matmul's operand read.

Layout: ``torch.nn.Linear`` stores ``[out, in]`` where a flax kernel is
``[in, out]``, so the contraction axis is the last one here (``-1``) and
the per-output-channel scales are ``[out, 1]``: the transpose of the JAX
package's ``[1, out]``, with the same values.  :class:`Int4PackedArray`
packs nibble pairs along the last axis with the same bytes as the JAX
package's ``_pack_nibbles``.

Sharding (:func:`shard_quantized`) follows from that layout flip: the
scale's contraction axis, which stays whole, is the last one here, and a
packed buffer the shard count does not divide is the input axis of a
row-parallel weight (the JAX package's is the output axis of a
column-parallel one).

Usage::

    from tensorflowonspark_tpu_torch.ops import quantize_params
    qparams = quantize_params(model.state_dict())        # Linear weights -> int8
    tokens = greedy_generate(cfg, qparams, prompt, 128)
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Callable

import torch


class _QuantArray:
    """Quantized weight (``q``) and float scale, dequantized at the call.

    ``dequantize(dtype)`` is ``q * scale`` in the scale's dtype, then cast
    to ``dtype``: the JAX wrapper's ``q.astype(scale.dtype) * scale``
    followed by the Dense layer's cast.  Subclasses fix the storage;
    consumers test against this base class.
    """

    def __init__(self, q, scale):
        self.q, self.scale = q, scale

    def _values(self):
        """The integer grid values in the weight's logical shape."""
        return self.q

    def dequantize(self, dtype=None):
        w = self._values().to(self.scale.dtype) * self.scale
        return w if dtype is None else w.to(dtype)

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def device(self):
        return self.q.device

    @property
    def nbytes(self) -> int:
        return self.q.numel() + self.scale.numel() * self.scale.element_size()

    def _replace(self, q, scale):
        return type(self)(q, scale)

    def to(self, device):
        """The same array with its tensors on ``device``."""
        return self._replace(self.q.to(device), self.scale.to(device))

    def __repr__(self):
        return f"{type(self).__name__}(shape={self.shape}, dtype={self.dtype})"


class Int8Array(_QuantArray):
    """Symmetric int8 weight and per-output-channel float scale."""


def quantize_int8(w: torch.Tensor, contract_axis: int = -1) -> Int8Array:
    """Quantize one weight to symmetric int8 with per-channel scales.

    ``contract_axis`` is the axis summed over in the consuming matmul
    (``-1``: the input dim of an ``[out, in]`` Linear weight, so the scales
    vary per output channel).  ``scale = amax / 127 + tiny`` and ``q =
    round(w / scale)`` (half to even), as the JAX package computes them.
    """
    w = torch.as_tensor(w)
    amax = w.abs().amax(dim=contract_axis, keepdim=True)
    scale = (amax / 127.0 + torch.finfo(w.dtype).tiny).to(w.dtype)
    q = torch.round(w / scale).to(torch.int8)
    return Int8Array(q, scale)


class Int4Array(_QuantArray):
    """Symmetric int4 weight, one value a byte in an int8 tensor (values in
    [-8, 7]; :func:`quantize_int4` uses [-7, 7]) and a float scale.
    ``nbytes`` counts two values a byte, as the JAX package's native
    ``jnp.int4`` storage."""

    @property
    def nbytes(self) -> int:
        return (self.q.numel() + 1) // 2 + self.scale.numel() * self.scale.element_size()


class Int4PackedArray(_QuantArray):
    """Symmetric int4 weight packed two a ``uint8`` byte, and a float scale.

    Logical elements ``2i`` and ``2i+1`` of the last axis live in the low
    and high nibble of packed byte ``i``; an odd last dim is zero-padded
    at pack time and cut off at unpack.  ``shape`` is the logical shape.

    ``blocks`` (set by :func:`shard_quantized`): ``(dim, parts, index)``
    cuts, applied in order, of a buffer held whole on every rank because
    its packed last axis does not divide over the shards; ``dequantize``
    returns this rank's block and ``shape`` is that block's."""

    def __init__(self, q, scale, logical_shape, blocks=()):
        super().__init__(q, scale)
        self.logical_shape = tuple(int(d) for d in logical_shape)
        self.blocks = tuple(blocks)

    @property
    def shape(self):
        shape = list(self.logical_shape)
        for dim, parts, _ in self.blocks:
            shape[dim] //= parts
        return tuple(shape)

    def _replace(self, q, scale):
        return Int4PackedArray(q, scale, (*q.shape[:-1], self.logical_shape[-1]), self.blocks)

    def dequantize(self, dtype=None):
        w = super().dequantize(dtype)
        for dim, parts, index in self.blocks:
            w = w.chunk(parts, dim=dim)[index]
        return w

    def _values(self):
        # repeat each byte, shift by the element's parity, sign-extend the
        # two's-complement nibble (0..15 -> -8..7)
        n = self.logical_shape[-1]
        rep = self.q.repeat_interleave(2, dim=-1)[..., :n]
        shift = (torch.arange(n, device=self.q.device) % 2 * 4).to(torch.uint8)
        nib = ((rep >> shift) & 0xF).to(torch.int8)
        return nib - 16 * (nib > 7).to(torch.int8)


def _pack_nibbles(qi: torch.Tensor) -> torch.Tensor:
    """``int8`` values in [-8, 7], any shape -> ``uint8`` two's-complement
    nibble pairs along the last axis (zero-padding an odd last dim)."""
    if qi.shape[-1] % 2:
        qi = torch.nn.functional.pad(qi, (0, 1))
    pairs = qi.to(torch.uint8).reshape(*qi.shape[:-1], -1, 2)
    return (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)


def quantize_int4(w: torch.Tensor, contract_axis: int = -1,
                  storage: str = "packed") -> _QuantArray:
    """Quantize one weight to symmetric int4 with per-channel scales (the
    :func:`quantize_int8` recipe on the grid [-7, 7]).

    ``storage="packed"`` (default) returns :class:`Int4PackedArray`;
    ``"native"`` returns :class:`Int4Array` (one value a byte)."""
    w = torch.as_tensor(w)
    amax = w.abs().amax(dim=contract_axis, keepdim=True)
    scale = (amax / 7.0 + torch.finfo(w.dtype).tiny).to(w.dtype)
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int8)
    if storage == "native":
        return Int4Array(q, scale)
    if storage != "packed":
        raise ValueError(f"unknown int4 storage {storage!r}")
    return Int4PackedArray(_pack_nibbles(q), scale, w.shape)


def _default_predicate(path: tuple, leaf) -> bool:
    # Linear weights only: >=2D floating leaves named 'weight' (the port's
    # name for a flax Dense 'kernel') outside the embedding tables ('*_emb').
    # Embeddings, norm scales, biases and position tables stay full
    # precision (they are small and/or feed float32 logits).
    return (len(path) >= 2 and str(path[-1]) == "weight"
            and not str(path[-2]).endswith("_emb")
            and torch.is_tensor(leaf) and leaf.dim() >= 2
            and leaf.is_floating_point())


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a state dict (``a.b.c`` names split into
    path components) or nested mappings, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, path + tuple(str(k).split("."))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_params(params, predicate: Callable | None = None, bits: int = 8):
    """Quantize matching leaves of a state dict (or nested mappings) to
    :class:`Int8Array` (``bits=8``) or :class:`Int4PackedArray`
    (``bits=4``).  ``predicate(path, leaf) -> bool`` overrides the default
    rule (2D+ floating leaves named ``weight`` outside ``*_emb`` tables);
    ``path`` is the leaf's name split on dots."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    pred = predicate or _default_predicate

    def visit(path, leaf):
        if not pred(path, leaf):
            return leaf
        leaf = leaf.detach()
        return quantize_int4(leaf) if bits == 4 else quantize_int8(leaf)

    return _map_tree(visit, params)


def _cut(t, cuts, name: str):
    """``t``'s block under ``cuts``: ``(dim, parts, index)`` in order, as
    ``parallel.sharding.local_block`` cuts a tensor."""
    for dim, parts, index in cuts:
        if t.shape[dim] % parts:
            raise ValueError(f"{name}: dim {dim} of size {t.shape[dim]} does not split "
                             f"over {parts} shards")
        t = t.chunk(parts, dim=dim)[index]
    return t


def shard_quantized(params: dict, shardings: dict, mesh) -> dict:
    """This rank's block of a quantized state dict on ``mesh``
    (tensor-parallel int8 or int4 decode).

    ``shardings`` is ``PartitionRules.tree_shardings(mesh, ...)`` over the
    *unquantized* state dict (the same names): DTensor placements a leaf,
    one a mesh axis.  Eager PyTorch runs each rank on its own block, so the
    result holds plain blocks, as ``parallel.sharding.local_block`` cuts
    them, where the JAX package places global arrays.  ``q`` takes its
    weight's cuts verbatim; ``scale`` (``[out, 1]``) the same cuts but on
    its contraction axis (−1), which stays whole.  A packed int4 buffer
    whose packed last axis the shard count does not divide (a row-parallel
    weight's input axis) is kept whole and cut at ``dequantize``
    (:attr:`Int4PackedArray.blocks`).  Plain leaves take their cuts
    unchanged.  A cut that does not divide raises."""
    from torch.distributed.tensor import Shard

    out = {}
    for name, leaf in params.items():
        cuts = [(p.dim % max(getattr(leaf, "ndim", 0), 1), mesh.size(m), mesh.get_local_rank(m))
                for m, p in enumerate(shardings.get(name, ()))
                if isinstance(p, Shard) and mesh.size(m) > 1]
        if not isinstance(leaf, _QuantArray):
            out[name] = _cut(leaf, cuts, name)
            continue
        last = leaf.ndim - 1
        scale = _cut(leaf.scale, [c for c in cuts if c[0] != last], name)
        if isinstance(leaf, Int4PackedArray):
            tail = [c for c in cuts if c[0] == last]
            whole = bool(tail) and leaf.q.shape[-1] % math.prod(p for _, p, _ in tail) != 0
            q_cuts = [c for c in cuts if c[0] != last] if whole else cuts
            logical = list(leaf.logical_shape)
            for dim, parts, _ in q_cuts:
                logical[dim] //= parts
            out[name] = Int4PackedArray(_cut(leaf.q, q_cuts, name), scale, logical,
                                        leaf.blocks + (tuple(tail) if whole else ()))
            continue
        out[name] = leaf._replace(_cut(leaf.q, cuts, name), scale)
    return out


def tree_nbytes(params) -> int:
    """Total parameter bytes (quantized-leaf-aware): compression reports."""
    total = [0]

    def visit(_, leaf):
        if isinstance(leaf, _QuantArray):
            total[0] += leaf.nbytes
        elif torch.is_tensor(leaf):
            total[0] += leaf.numel() * leaf.element_size()
        return leaf

    _map_tree(visit, params)
    return total[0]
