"""The port's weight quantization (``ops/quant.py``) against the JAX
package's ``ops/quant.py``.

A flax kernel is ``[in, out]`` and the port's ``nn.Linear`` weight is
``[out, in]``: the port quantizes ``W.T`` over its last axis, and its
``q`` and ``scale`` must be exactly the JAX package's, transposed (the same
float32 ``amax / 127 + tiny`` and ``round(w / scale)`` half to even).
Packed int4 must hold the same bytes as the JAX package's ``_pack_nibbles``
for the same values, and unpack to the same dequantized weight.
``shard_quantized`` cuts a quantized state dict by the GPT tp rules in the
port's layout (each block exact against the whole).  No tolerance: every
comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tensorflowonspark_tpu.models.gpt import GPT as JaxGPT
from tensorflowonspark_tpu.models.gpt import GPTConfig as JaxGPTConfig
from tensorflowonspark_tpu.ops import quant as jq
from tensorflowonspark_tpu_torch.models import gpt as P
from tensorflowonspark_tpu_torch.ops import quant

KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
          max_position_embeddings=16)


def _w(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(48, 64), (7, 5), (3, 16, 8)])
def test_int8_q_and_scales_are_the_jax_ones_transposed(shape):
    w = _w(shape)
    jqa = jq.quantize_int8(jnp.asarray(w))
    pqa = quant.quantize_int8(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert pqa.q.dtype == torch.int8 and pqa.shape == tuple(np.swapaxes(w, -1, -2).shape)
    np.testing.assert_array_equal(pqa.q.numpy(), np.swapaxes(np.asarray(jqa.q), -1, -2))
    np.testing.assert_array_equal(pqa.scale.numpy(), np.swapaxes(np.asarray(jqa.scale), -1, -2))
    np.testing.assert_array_equal(pqa.dequantize().numpy(),
                                  np.swapaxes(np.asarray(jnp.asarray(jqa)), -1, -2))
    assert pqa.nbytes == jqa.nbytes
    assert pqa.dequantize(torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(8, 6), (7, 5), (5, 9)])
def test_int4_values_packed_bytes_and_dequantized_weights_equal_jax(shape):
    w = _w(shape, seed=1)
    wt = torch.from_numpy(w.T.copy())
    jnative = jq.quantize_int4(jnp.asarray(w), storage="native")
    jpacked = jq.quantize_int4(jnp.asarray(w))
    pnative = quant.quantize_int4(wt, storage="native")
    ppacked = quant.quantize_int4(wt)
    values = np.array(jnative.q.astype(jnp.int8)).T.copy()
    np.testing.assert_array_equal(pnative.q.numpy(), values)
    assert pnative.q.dtype == torch.int8 and pnative.nbytes == jnative.nbytes
    np.testing.assert_array_equal(pnative.scale.numpy(), np.asarray(jnative.scale).T)
    # the same values pack into the same bytes (along the last axis)
    np.testing.assert_array_equal(quant._pack_nibbles(torch.from_numpy(values)).numpy(),
                                  np.asarray(jq._pack_nibbles(jnp.asarray(values))))
    assert ppacked.q.dtype == torch.uint8 and ppacked.shape == wt.shape
    assert ppacked.nbytes == (wt.shape[0] * ((wt.shape[1] + 1) // 2) + 4 * wt.shape[0])
    for p in (pnative, ppacked):
        np.testing.assert_array_equal(p.dequantize().numpy(), np.asarray(jnp.asarray(jpacked)).T)
    with pytest.raises(ValueError, match="storage"):
        quant.quantize_int4(wt, storage="int4")


def test_packed_nibbles_cover_the_whole_grid():
    values = torch.arange(-8, 8, dtype=torch.int8).reshape(2, 8)
    packed = quant.Int4PackedArray(quant._pack_nibbles(values), torch.ones(2, 1), (2, 8))
    np.testing.assert_array_equal(packed.dequantize().numpy(), values.float().numpy())


@functools.cache
def _flax_and_port_params():
    jc = JaxGPTConfig(**KW, dtype=jnp.float32)
    params = meta.unbox(jax.jit(JaxGPT(jc).init)(jax.random.key(0),
                                                 jnp.ones((1, 4), jnp.int32))["params"])
    pc = P.GPTConfig(**KW, dtype=torch.float32)
    return params, pc, P.params_from_flax(params, pc)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_picks_the_jax_leaves_and_tree_nbytes_agrees(bits):
    params, pc, sd = _flax_and_port_params()
    jqp = jq.quantize_params(params, bits=bits)
    pqp = quant.quantize_params(sd, bits=bits)
    cls = quant.Int8Array if bits == 8 else quant.Int4PackedArray
    jcls = jq.Int8Array if bits == 8 else jq.Int4PackedArray
    # the JAX package's quantized kernels, named as the port names them
    marked = jax.tree.map(lambda x: np.ones(x.shape, np.float32) if isinstance(x, jcls)
                          else np.zeros(x.shape, np.float32), jqp,
                          is_leaf=lambda x: isinstance(x, jcls))
    want = {n for n, t in P.params_from_flax(marked, pc).items() if t.numel() and t.all()}
    got = {n for n, v in pqp.items() if isinstance(v, cls)}
    assert got == want and got
    assert all(n.endswith(".weight") for n in got)
    assert quant.tree_nbytes(pqp) == jq.tree_nbytes(jqp)
    assert quant.tree_nbytes(sd) == jq.tree_nbytes(params)
    dequantized = P.params_from_flax(jax.tree.map(
        lambda x: jnp.asarray(x) if isinstance(x, jcls) else x, jqp,
        is_leaf=lambda x: isinstance(x, jcls)), pc)
    for n in got:  # every quantized leaf dequantizes to the JAX one, transposed
        np.testing.assert_array_equal(pqp[n].dequantize().numpy(), dequantized[n].numpy())
    with pytest.raises(ValueError, match="bits"):
        quant.quantize_params(sd, bits=2)


def test_quantize_params_custom_predicate_and_nesting():
    tree = {"a": {"weight": torch.ones(4, 8)}, "b": [torch.ones(4, 4)], "tok_emb.weight":
            torch.ones(3, 4), "c.bias": torch.ones(4)}
    q = quant.quantize_params(tree)
    assert isinstance(q["a"]["weight"], quant.Int8Array)
    assert torch.is_tensor(q["b"][0]) and torch.is_tensor(q["tok_emb.weight"])
    q = quant.quantize_params(tree, predicate=lambda path, leaf: path == ("b", "0"))
    assert isinstance(q["b"][0], quant.Int8Array) and torch.is_tensor(q["a"]["weight"])


@pytest.mark.parametrize("bits", [8, 4])
def test_a_quantized_tied_table_reads_as_its_dequantized_values(bits):
    """A custom predicate that also quantizes ``tok_emb`` (one scale a
    vocabulary row): the lookup and the tied head read the dequantized
    table, so the hidden states and logits are those of the dequantized
    weights."""
    _, pc, sd = _flax_and_port_params()
    q = quant.quantize_params(sd, bits=bits, predicate=lambda path, leaf: (
        quant._default_predicate(path, leaf) or path == ("tok_emb", "weight")))
    assert isinstance(q["tok_emb.weight"], quant._QuantArray)
    dense = {n: v.dequantize() if isinstance(v, quant._QuantArray) else v for n, v in q.items()}
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, KW["vocab_size"], (2, 9)))
    with torch.no_grad():
        torch.testing.assert_close(P._model(pc, q)(ids), P._model(pc, dense)(ids),
                                   rtol=0, atol=0)
        torch.testing.assert_close(P._model(pc, q).hidden(ids),
                                   P._model(pc, dense).hidden(ids), rtol=0, atol=0)


# ---------------------------------------------------- shard_quantized

class _TpMesh:
    """What ``shard_quantized`` and ``PartitionRules.tree_shardings`` read
    of a ``DeviceMesh``: one ``tp`` axis of ``n`` ranks, this rank ``r``."""

    mesh_dim_names = ("tp",)

    def __init__(self, n, r):
        self.n, self.r = n, r

    def size(self, dim=None):
        return self.n

    def get_local_rank(self, dim=None):
        return self.r


def _gpt_blocks(bits, n=2):
    """A quantized port GPT state dict, the whole one and each of ``n``
    ranks' blocks under the GPT tp rules."""
    from tensorflowonspark_tpu_torch.parallel.sharding import gpt_partition_rules

    sd = P.init_params(P.GPTConfig(**KW, dtype=torch.float32), 0)
    whole = quant.quantize_params(sd, bits=bits)
    blocks = []
    for r in range(n):
        mesh = _TpMesh(n, r)
        blocks.append(quant.shard_quantized(whole, gpt_partition_rules().tree_shardings(mesh, sd),
                                            mesh))
    return whole, blocks


@pytest.mark.parametrize("bits", [8, 4])
def test_shard_quantized_cuts_column_and_row_parallel_weights_in_the_port_layout(bits):
    """The counterpart of ``tests/test_quant.py:80-120`` in ``[out, in]``:
    a column-parallel ``q`` (``query``) is cut on dim 0 and its ``[out, 1]``
    scale alike; a row-parallel ``q`` (``out``) is cut on dim -1 and its
    scale stays whole.  The ranks' blocks put back together are the whole
    ``q`` and ``scale``, and each block dequantizes to its slice of the
    whole weight, exactly."""
    whole, blocks = _gpt_blocks(bits)
    col, row = "layers.0.attn.query.weight", "layers.0.attn.out.weight"
    for name, dim in ((col, 0), (row, 1)):
        parts = [b[name] for b in blocks]
        assert all(type(p) is type(whole[name]) for p in parts)
        np.testing.assert_array_equal(torch.cat([p.q for p in parts], dim).numpy(),
                                      whole[name].q.numpy())
        np.testing.assert_array_equal(torch.cat([p.dequantize() for p in parts], dim).numpy(),
                                      whole[name].dequantize().numpy())
    assert blocks[0][col].scale.shape == (16, 1) and blocks[0][col].shape == (16, 32)
    np.testing.assert_array_equal(torch.cat([b[col].scale for b in blocks]).numpy(),
                                  whole[col].scale.numpy())
    for b in blocks:
        assert b[row].scale.shape == (32, 1) and b[row].shape == (32, 16)
        np.testing.assert_array_equal(b[row].scale.numpy(), whole[row].scale.numpy())
        # the tied table is not quantized by default: vocab rows cut plainly
        assert b["tok_emb.weight"].shape == (32, 32)
        assert b["layers.0.attn.query.bias"].shape == (32,)     # held whole


def test_int4_packed_row_parallel_indivisible_axis_is_held_whole():
    """The counterpart of ``tests/test_quant.py:162-180``: a row-parallel
    int4 weight whose packed input axis the shard count does not divide
    (``[16, 4]`` over tp 4: 2 packed bytes a row; ``[8, 6]`` over tp 2: 3)
    keeps its packed buffer whole on every rank, cut at dequantize: each
    rank's dequantized block is its slice of the unchanged weight."""
    from tensorflowonspark_tpu_torch.parallel.sharding import P as Spec
    from tensorflowonspark_tpu_torch.parallel.sharding import PartitionRules

    rules = PartitionRules([(r".*", Spec(None, "tp"))])
    for shape, n in (((16, 4), 4), ((8, 6), 2)):
        w = {"d.weight": torch.from_numpy(_w(shape))}
        q4 = quant.quantize_params({"d": w["d.weight"]}, predicate=lambda path, leaf: True,
                                   bits=4)
        q4 = {"d.weight": q4["d"]}
        full = q4["d.weight"].dequantize()
        for r in range(n):
            mesh = _TpMesh(n, r)
            leaf = quant.shard_quantized(q4, rules.tree_shardings(mesh, w), mesh)["d.weight"]
            assert leaf.q.shape == q4["d.weight"].q.shape        # held whole, not raised
            assert leaf.shape == (shape[0], shape[1] // n)
            np.testing.assert_array_equal(leaf.dequantize().numpy(),
                                          full.chunk(n, dim=1)[r].numpy())
            # on its way to a device the block survives
            np.testing.assert_array_equal(leaf.to("cpu").dequantize().numpy(),
                                          leaf.dequantize().numpy())


def test_shard_quantized_raises_on_a_cut_that_does_not_divide():
    from tensorflowonspark_tpu_torch.parallel.sharding import gpt_partition_rules

    sd = P.init_params(P.GPTConfig(**{**KW, "vocab_size": 63}, dtype=torch.float32), 0)
    mesh = _TpMesh(2, 0)
    with pytest.raises(ValueError, match="tok_emb.weight: dim 0 of size 63"):
        quant.shard_quantized(quant.quantize_params(sd),
                              gpt_partition_rules().tree_shardings(mesh, sd), mesh)
