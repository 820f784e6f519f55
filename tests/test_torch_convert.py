"""The port's Hugging Face converters (``models/convert.py``) at the logit
level: random-init ``transformers`` GPT-2, Llama, Mistral (sliding window)
and BERT models built from configs written here (no download) against the
port's GPT and BERT carrying the converted weights, float32.  Each
converted config also equals the JAX package's converter's field for
field.  Skips where ``transformers`` is absent (the card's machine has
none).

Tolerances as the JAX package's ``tests/test_convert.py``: logits
``rtol = atol = 2e-4`` (GPT-2) and ``3e-4`` (Llama-class); BERT hidden
states ``rtol = 2e-4, atol = 2e-5`` at the unpadded positions.  Both sides
are float32 PyTorch here; the seen error is ~1e-6.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # else transformers' GPT-2 imports TensorFlow, seconds
transformers = pytest.importorskip("transformers")

from tensorflowonspark_tpu.models import convert as jconvert  # noqa: E402
from tensorflowonspark_tpu_torch.models import convert  # noqa: E402
from tensorflowonspark_tpu_torch.models.bert import Bert  # noqa: E402
from tensorflowonspark_tpu_torch.models.gpt import GPT  # noqa: E402


def _same_config(port_cfg, jax_cfg):
    """Every field but the dtype (torch's float32 against numpy's) and the
    JAX package's sharding spec ``emb_spec`` (the port has no mesh yet)."""
    p = {f.name: getattr(port_cfg, f.name) for f in dataclasses.fields(port_cfg)}
    j = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    p.pop("dtype"), j.pop("dtype"), j.pop("emb_spec")
    assert p == j


def _gpt_logits(cfg, sd, ids):
    model = GPT(cfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        return model(torch.tensor(ids)).numpy()


def test_gpt2_conversion_matches_hf_logits():
    hf_cfg = transformers.GPT2Config(vocab_size=97, n_positions=32, n_embd=32, n_layer=2,
                                     n_head=4, resid_pdrop=0.0, embd_pdrop=0.0,
                                     attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = convert.gpt2_config_from_hf(hf_cfg)
    _same_config(cfg, jconvert.gpt2_config_from_hf(hf_cfg))
    ids = np.random.default_rng(0).integers(0, 97, (2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    got = _gpt_logits(cfg, convert.gpt2_params_from_hf(hf.state_dict(), cfg), ids)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["llama", "mistral"])
def test_llama_class_conversion_matches_hf_logits(family):
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=48, rms_norm_eps=1e-5,
                  tie_word_embeddings=True, attention_dropout=0.0)
    if family == "llama":
        hf_cfg = transformers.LlamaConfig(vocab_size=101, max_position_embeddings=32, **common)
        hf_cls, T = transformers.LlamaForCausalLM, 10
    else:  # a sequence longer than the window, so the band engages
        hf_cfg = transformers.MistralConfig(vocab_size=89, max_position_embeddings=64,
                                            sliding_window=6, **common)
        hf_cls, T = transformers.MistralForCausalLM, 16
    torch.manual_seed(1)
    hf = hf_cls(hf_cfg).eval()
    cfg = convert.llama_config_from_hf(hf_cfg)
    _same_config(cfg, jconvert.llama_config_from_hf(hf_cfg))
    assert (cfg.pos_encoding, cfg.norm, cfg.mlp, cfg.num_kv_heads) == ("rope", "rmsnorm",
                                                                       "swiglu", 2)
    ids = np.random.default_rng(1).integers(0, hf_cfg.vocab_size, (2, T))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
    got = _gpt_logits(cfg, convert.llama_params_from_hf(hf.state_dict(), cfg), ids)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_unsupported_variants_rejected_as_the_jax_converter():
    cases = [(convert.gpt2_config_from_hf, jconvert.gpt2_config_from_hf,
              transformers.GPT2Config(activation_function="gelu")),
             (convert.llama_config_from_hf, jconvert.llama_config_from_hf,
              transformers.LlamaConfig(tie_word_embeddings=False)),
             (convert.llama_config_from_hf, jconvert.llama_config_from_hf,
              transformers.LlamaConfig(tie_word_embeddings=True,
                                       rope_scaling={"rope_type": "linear", "factor": 2.0})),
             (convert.llama_config_from_hf, jconvert.llama_config_from_hf,
              transformers.Qwen2Config(num_hidden_layers=2, max_window_layers=1,
                                       use_sliding_window=True, sliding_window=6,
                                       tie_word_embeddings=True)),
             (convert.bert_config_from_hf, jconvert.bert_config_from_hf,
              transformers.BertConfig(hidden_dropout_prob=0.1,
                                      attention_probs_dropout_prob=0.0))]
    for port_fn, jax_fn, hf_cfg in cases:
        with pytest.raises(ValueError) as want:
            jax_fn(hf_cfg)
        with pytest.raises(ValueError) as got:
            port_fn(hf_cfg)
        assert str(got.value) == str(want.value)


def test_bert_conversion_matches_hf_hidden_states():
    hf_cfg = transformers.BertConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=48, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 97, (2, 16))
    types = rng.integers(0, 2, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[0, 12:] = 0  # padded tail on row 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                  token_type_ids=torch.tensor(types)).last_hidden_state.numpy()
    cfg = convert.bert_config_from_hf(hf_cfg)
    assert cfg.gelu_exact and cfg.norm_eps == hf_cfg.layer_norm_eps
    model = Bert(cfg)
    model.load_state_dict(convert.bert_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        got = model(torch.tensor(ids), torch.tensor(mask), torch.tensor(types)).numpy()
    keep = mask.astype(bool)  # padded query rows are an implementation detail
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-4, atol=2e-5)
