"""Hugging Face checkpoint conversion for the port's GPT and BERT.

Port of ``tensorflowonspark_tpu/models/convert.py``: map a ``transformers``
GPT-2, Llama-class or BERT state dict onto the port's ``state_dict``
layout, with the same config checks and messages.  ``tests/
test_torch_convert.py`` holds the mapping at the logit level against
random-init Hugging Face models.  ``transformers`` is never imported here:
pass its config object and ``model.state_dict()`` (torch tensors, or any
mapping of arrays).

Layouts: HF GPT-2's ``Conv1D`` stores ``[in, out]`` (the flax layout), so
its weights are transposed into ``nn.Linear``'s ``[out, in]`` and
``c_attn`` is split into query/key/value thirds; Llama and BERT ``Linear``
weights are ``[out, in]`` already.  Llama RoPE is rotate-half pairing (the
GPT-NeoX/HF convention) with no permutation.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models.bert import BertConfig
from tensorflowonspark_tpu_torch.models.gpt import GPTConfig


def _t(x) -> torch.Tensor:
    """A float32 CPU tensor of ``x`` (a tensor or an array)."""
    if torch.is_tensor(x):
        return x.detach().cpu().float().contiguous()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def gpt2_config_from_hf(hf_cfg) -> GPTConfig:
    """``transformers.GPT2Config`` → :class:`GPTConfig` (learned positions,
    pre-LN LayerNorm at the HF epsilon, gelu-tanh, float32)."""
    act = getattr(hf_cfg, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"GPT's gelu path is the tanh approximation (gelu_new); "
            f"checkpoint uses activation_function={act!r} — converting "
            "would silently change the numerics")
    return GPTConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head,
        intermediate_size=hf_cfg.n_inner or 4 * hf_cfg.n_embd,
        max_position_embeddings=hf_cfg.n_positions,
        dtype=torch.float32,
        pos_encoding="learned",
        norm="layernorm",
        norm_eps=hf_cfg.layer_norm_epsilon,
        mlp="gelu",
    )


def gpt2_params_from_hf(state_dict: Mapping[str, Any], cfg: GPTConfig) -> dict:
    """HF GPT-2 ``state_dict`` → the port's ``GPT(cfg)`` state dict."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    E = cfg.hidden_size
    out: dict[str, torch.Tensor] = {
        "tok_emb.weight": _t(sd["wte.weight"]),
        "pos_emb": _t(sd["wpe.weight"]),
        "ln_f.weight": _t(sd["ln_f.weight"]),
        "ln_f.bias": _t(sd["ln_f.bias"]),
    }

    def conv1d(name, w, b):  # Conv1D [in, out] -> Linear [out, in]
        out[f"{name}.weight"] = w.T.contiguous()
        out[f"{name}.bias"] = b

    for i in range(cfg.num_layers):
        p, q = f"h.{i}", f"layers.{i}"
        for ours, theirs in (("ln1", "ln_1"), ("ln2", "ln_2")):
            out[f"{q}.{ours}.weight"] = _t(sd[f"{p}.{theirs}.weight"])
            out[f"{q}.{ours}.bias"] = _t(sd[f"{p}.{theirs}.bias"])
        ca_w, ca_b = _t(sd[f"{p}.attn.c_attn.weight"]), _t(sd[f"{p}.attn.c_attn.bias"])
        for j, name in enumerate(("query", "key", "value")):
            conv1d(f"{q}.attn.{name}", ca_w[:, j * E:(j + 1) * E], ca_b[j * E:(j + 1) * E])
        conv1d(f"{q}.attn.out", _t(sd[f"{p}.attn.c_proj.weight"]),
               _t(sd[f"{p}.attn.c_proj.bias"]))
        conv1d(f"{q}.mlp_up", _t(sd[f"{p}.mlp.c_fc.weight"]), _t(sd[f"{p}.mlp.c_fc.bias"]))
        conv1d(f"{q}.mlp_down", _t(sd[f"{p}.mlp.c_proj.weight"]),
               _t(sd[f"{p}.mlp.c_proj.bias"]))
    return out


def llama_config_from_hf(hf_cfg) -> GPTConfig:
    """``transformers.LlamaConfig``-class → :class:`GPTConfig` (RoPE,
    RMSNorm, SwiGLU, GQA).  The LM head must be tied
    (``tie_word_embeddings=True``): :class:`~.gpt.GPT` always ties."""
    if not getattr(hf_cfg, "tie_word_embeddings", False):
        raise ValueError(
            "GPT ties the LM head to the token embedding; convert only "
            "checkpoints with tie_word_embeddings=True")
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling and scaling.get("rope_type", scaling.get("type")) != "default":
        raise ValueError(
            f"rope_scaling={scaling!r} is not supported (plain RoPE only); "
            "converting would silently change the frequencies")
    # Sliding windows (Qwen2-class): layers below max_window_layers attend
    # fully.  Only uniform configurations convert: all layers windowed
    # (mwl in {None, 0}) keeps the window, none (mwl >= num_layers) drops
    # it, a mix raises.
    use_sw = getattr(hf_cfg, "use_sliding_window", True)
    sw = getattr(hf_cfg, "sliding_window", None)
    mwl = getattr(hf_cfg, "max_window_layers", None)
    if use_sw and sw is not None and mwl is not None:
        if mwl >= hf_cfg.num_hidden_layers:
            use_sw = False  # HF applies the window to no layer at all
        elif mwl > 0:
            raise ValueError(
                f"max_window_layers={mwl} of "
                f"{hf_cfg.num_hidden_layers} layers: per-layer window "
                "mixes are not supported (GPTConfig.sliding_window is "
                "global)")
    return GPTConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None),
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        dtype=torch.float32,
        pos_encoding="rope",
        rope_base=getattr(hf_cfg, "rope_theta", 10000.0),
        norm="rmsnorm",
        norm_eps=hf_cfg.rms_norm_eps,
        mlp="swiglu",
        sliding_window=sw if use_sw else None,
    )


def llama_params_from_hf(state_dict: Mapping[str, Any], cfg: GPTConfig) -> dict:
    """HF Llama-class ``state_dict`` → the port's ``GPT(cfg)`` state dict.
    Llama layers have no biases: the port's Linear biases are zeros
    (Qwen2-class attention biases carry over)."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    out: dict[str, torch.Tensor] = {
        "tok_emb.weight": _t(sd["embed_tokens.weight"]),
        "ln_f.weight": _t(sd["norm.weight"]),
    }

    def linear(name, key):
        w = _t(sd[key])
        bias_key = key.removesuffix(".weight") + ".bias"
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = _t(sd[bias_key]) if bias_key in sd else torch.zeros(w.shape[0])

    for i in range(cfg.num_layers):
        p, q = f"layers.{i}", f"layers.{i}"
        out[f"{q}.ln1.weight"] = _t(sd[f"{p}.input_layernorm.weight"])
        out[f"{q}.ln2.weight"] = _t(sd[f"{p}.post_attention_layernorm.weight"])
        for ours, theirs in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"),
                             ("out", "o_proj")):
            linear(f"{q}.attn.{ours}", f"{p}.self_attn.{theirs}.weight")
        for ours, theirs in (("mlp_gate", "gate_proj"), ("mlp_up", "up_proj"),
                             ("mlp_down", "down_proj")):
            linear(f"{q}.{ours}", f"{p}.mlp.{theirs}.weight")
    return out


def bert_config_from_hf(hf_cfg) -> BertConfig:
    """``transformers.BertConfig`` → :class:`~.bert.BertConfig`: exact
    erf-gelu (``hidden_act="gelu"``) and LayerNorm at the checkpoint's
    ``layer_norm_eps``, float32."""
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported hidden_act={act!r} (gelu variants only)")
    if getattr(hf_cfg, "position_embedding_type", "absolute") != "absolute":
        raise ValueError("only absolute position embeddings are supported")
    if hf_cfg.hidden_dropout_prob != hf_cfg.attention_probs_dropout_prob:
        raise ValueError(
            f"hidden_dropout_prob ({hf_cfg.hidden_dropout_prob}) != "
            f"attention_probs_dropout_prob "
            f"({hf_cfg.attention_probs_dropout_prob}); BertConfig has one "
            "dropout_rate for both — set them equal (or 0 for inference)")
    return BertConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        type_vocab_size=hf_cfg.type_vocab_size,
        dropout_rate=hf_cfg.hidden_dropout_prob,
        dtype=torch.float32,
        norm_eps=hf_cfg.layer_norm_eps,
        gelu_exact=(act == "gelu"),
    )


def bert_params_from_hf(state_dict: Mapping[str, Any], cfg: BertConfig) -> dict:
    """HF ``BertModel`` state dict → the port's ``Bert`` (trunk) state dict.
    The pooler, when present, is ignored: SQuAD-style heads consume the
    trunk."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}
    out: dict[str, torch.Tensor] = {}

    def copy(ours, theirs, bias=True):
        out[f"{ours}.weight"] = _t(sd[f"{theirs}.weight"])
        if bias:
            out[f"{ours}.bias"] = _t(sd[f"{theirs}.bias"])

    copy("tok_emb", "embeddings.word_embeddings", bias=False)
    copy("pos_emb", "embeddings.position_embeddings", bias=False)
    copy("type_emb", "embeddings.token_type_embeddings", bias=False)
    copy("ln_emb", "embeddings.LayerNorm")
    for i in range(cfg.num_layers):
        p, q = f"encoder.layer.{i}", f"layers.{i}"
        copy(f"{q}.attn.query", f"{p}.attention.self.query")
        copy(f"{q}.attn.key", f"{p}.attention.self.key")
        copy(f"{q}.attn.value", f"{p}.attention.self.value")
        copy(f"{q}.attn.out", f"{p}.attention.output.dense")
        copy(f"{q}.ln_attn", f"{p}.attention.output.LayerNorm")
        copy(f"{q}.mlp_up", f"{p}.intermediate.dense")
        copy(f"{q}.mlp_down", f"{p}.output.dense")
        copy(f"{q}.ln_mlp", f"{p}.output.LayerNorm")
    return out
