"""BERT encoder and its SQuAD span head, in PyTorch.

Port of ``tensorflowonspark_tpu/models/bert.py`` (the repo's flagship model,
``BASELINE.json`` configs[3]).  Numerics follow the flax module exactly:

- parameters are stored in float32; ``Dense``/``Embed`` layers with
  ``dtype=bf16`` cast both the input and the weight to bf16 before the
  product (:func:`_dense`);
- LayerNorm normalises in float32 with flax's default eps 1e-6
  (``norm_eps``), then casts back to ``cfg.dtype``; the residual add
  happens in ``cfg.dtype`` before it;
- GELU is the tanh approximation unless ``gelu_exact``;
- the dense attention path (``attention_fn=None``) computes in float32
  with ``where(mask, s, -1e30)``; ``attention_fn=flash_attention`` runs
  the CUDA kernel (``ops/flash_attention.py``);
- the QA head is a float32 Dense on ``cfg.dtype`` activations.

:func:`params_from_flax` carries the JAX package's parameters across;
:func:`init_params` draws random ones from a seed with numpy.  Not ported
yet (ROADMAP queue A): ``scan_layers``/``remat``, mesh anchoring
(``act_spec``/``emb_spec``) and ``BertForSequenceClassification``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # Optional attention override, e.g. ``ops.flash_attention``; signature
    # ``(q, k, v, mask=None) -> out`` with [batch, seq, heads, head_dim]
    # tensors and an optional [batch, seq] bool key-padding mask.
    attention_fn: Callable | None = None
    # HF BERT uses exact erf-gelu and LayerNorm eps 1e-12; the defaults keep
    # the JAX module's behavior (tanh gelu, flax eps 1e-6).
    norm_eps: float = 1e-6
    gelu_exact: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(layer: nn.LayerNorm, x, dtype):
    """flax ``nn.LayerNorm(dtype=float32)`` followed by ``.astype(dtype)``."""
    return layer(x.float()).to(dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.num_heads * cfg.head_dim
        self.query = nn.Linear(cfg.hidden_size, hd)
        self.key = nn.Linear(cfg.hidden_size, hd)
        self.value = nn.Linear(cfg.hidden_size, hd)
        self.out = nn.Linear(hd, cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = _dense(self.query, x, cfg.dtype).view(B, T, H, D)
        k = _dense(self.key, x, cfg.dtype).view(B, T, H, D)
        v = _dense(self.value, x, cfg.dtype).view(B, T, H, D)
        if cfg.attention_fn is not None:
            ctx = cfg.attention_fn(q, k, v, mask=mask)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
            if mask is not None:
                s = torch.where(mask[:, None, None, :], s, -1e30)
            p = self.dropout(torch.softmax(s, dim=-1))
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        ctx = ctx.to(cfg.dtype).reshape(B, T, H * D)
        return _dense(self.out, ctx, cfg.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = SelfAttention(cfg)
        self.ln_attn = nn.LayerNorm(cfg.hidden_size, eps=cfg.norm_eps)
        self.mlp_up = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.mlp_down = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ln_mlp = nn.LayerNorm(cfg.hidden_size, eps=cfg.norm_eps)
        self.dropout = nn.Dropout(cfg.dropout_rate)

    def forward(self, x, mask=None):
        cfg = self.cfg
        y = self.dropout(self.attn(x, mask))
        x = _layer_norm(self.ln_attn, x + y, cfg.dtype)
        y = _dense(self.mlp_up, x, cfg.dtype)
        y = F.gelu(y, approximate="none" if cfg.gelu_exact else "tanh")
        y = self.dropout(_dense(self.mlp_down, y, cfg.dtype))
        return _layer_norm(self.ln_mlp, x + y, cfg.dtype)


class Bert(nn.Module):
    """Encoder trunk: ``(input_ids, attention_mask, token_type_ids) →
    sequence of hidden states``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln_emb = nn.LayerNorm(cfg.hidden_size, eps=cfg.norm_eps)
        self.dropout = nn.Dropout(cfg.dropout_rate)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.cfg
        T = input_ids.shape[1]
        # flax Embed(dtype=bf16) casts the table, then gathers: gathering
        # first and casting the rows gives the same values
        x = self.tok_emb(input_ids).to(cfg.dtype)
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = x + self.pos_emb(pos).to(cfg.dtype)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids).to(cfg.dtype)
        x = self.dropout(_layer_norm(self.ln_emb, x, cfg.dtype))
        mask = None if attention_mask is None else attention_mask.bool()
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BertForQuestionAnswering(nn.Module):
    """SQuAD-style span head: start/end logits per position."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = Bert(cfg)
        self.qa_head = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.bert(input_ids, attention_mask, token_type_ids)
        logits = F.linear(x.float(), self.qa_head.weight, self.qa_head.bias)
        return logits[..., 0], logits[..., 1]


# ------------------------------------------------------------------ weights

def params_from_flax(flax_params: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ``BertForQuestionAnswering`` parameters (a nested
    dict of numpy arrays, the ``params`` collection unboxed) as this
    module's ``state_dict``.

    ``Dense`` kernels ``(in, out)`` become ``nn.Linear.weight`` ``(out, in)``;
    ``Embed`` tables and LayerNorm ``scale``/``bias`` carry over as they are.
    """
    sd: dict[str, torch.Tensor] = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def module(prefix, p):
        if "kernel" in p:                                   # Dense
            put(f"{prefix}.weight", np.asarray(p["kernel"]).T)
            put(f"{prefix}.bias", p["bias"])
        elif "embedding" in p:                              # Embed
            put(f"{prefix}.weight", p["embedding"])
        elif "scale" in p:                                  # LayerNorm
            put(f"{prefix}.weight", p["scale"])
            put(f"{prefix}.bias", p["bias"])
        else:
            raise KeyError(f"unrecognised flax module at {prefix}: {sorted(p)}")

    bert = flax_params["bert"]
    for name in ("tok_emb", "pos_emb", "type_emb", "ln_emb"):
        if name in bert:
            module(f"bert.{name}", bert[name])
    i = 0
    while f"layer_{i}" in bert:
        layer = bert[f"layer_{i}"]
        for name in ("query", "key", "value", "out"):
            module(f"bert.layers.{i}.attn.{name}", layer["attn"][name])
        for name in ("ln_attn", "mlp_up", "mlp_down", "ln_mlp"):
            module(f"bert.layers.{i}.{name}", layer[name])
        i += 1
    module("qa_head", flax_params["qa_head"])
    return sd


def init_params(cfg: BertConfig, seed: int) -> dict[str, torch.Tensor]:
    """Random ``BertForQuestionAnswering`` weights drawn with numpy from
    ``seed``: normal(0, 0.02) kernels and tables as the JAX module
    initialises them, zero biases, unit LayerNorm scales, and a
    normal(0, 1/sqrt(hidden)) QA head."""
    rng = np.random.default_rng(seed)
    sd: dict[str, torch.Tensor] = {}
    with torch.device("meta"):  # shapes only, nothing allocated
        shapes = BertForQuestionAnswering(cfg).state_dict()
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name.startswith("qa_head.") and name.endswith("weight"):
            arr = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(cfg.hidden_size)
        elif name.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        elif ".ln_" in name:
            arr = np.ones(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        sd[name] = torch.from_numpy(arr)
    return sd


def build_qa_model(cfg: BertConfig, state_dict: dict, device) -> BertForQuestionAnswering:
    """A ``BertForQuestionAnswering`` in eval mode on ``device`` holding
    ``state_dict`` (float32 parameters, as flax keeps them)."""
    with torch.device("meta"):
        model = BertForQuestionAnswering(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.to(device).eval()
