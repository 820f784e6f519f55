"""The checkpoint and export slice on the card: padded head dims through
the flash kernels, export → load → serve of a small BERT with the flash
forward inside the exported program, ``TFModel.transform`` of that export
on the card from several driver threads, and a checkpoint written on the
card restored on the CPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py

Tolerances: the padded head dims are held to the plain versions as
``test_torch_kernels_cuda.py`` holds the kernels (bf16 forward
``atol=2e-2``; gradients ``2e-2`` of each gradient's largest magnitude).
The exported program runs the eager model's operations and kernels, so its
logits are held to the eager model's at ``1e-5`` of the largest logit
(float32 layers, bf16 attention: only launch-order effects).  The
transform's threads run the same program as a one-thread call, so their
logits are held to it bit for bit.  Checkpoints restore bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import bert_inference, bert_train
from tensorflowonspark_tpu_torch import pipeline as pl
from tensorflowonspark_tpu_torch.checkpoint import (CheckpointManager, ExportedModel,
                                                    restore_checkpoint)
from tensorflowonspark_tpu_torch.models.bert import build_qa_model, init_params
from tensorflowonspark_tpu_torch.ops import flash_attention, flash_attention_plain
from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention_bwd
from tensorflowonspark_tpu_torch.parallel import DataParallelStrategy

pytestmark = pytest.mark.cuda

#: 2 layers; hidden 64 over 4 heads (D = 16, padded to 64) and over 1 head (D = 64)
SMALL = {"vocab_size": 128, "num_layers": 2, "intermediate_size": 128,
         "max_position_embeddings": 64, "dtype": "bfloat16", "hidden_size": 64}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _counts():
    return (flash_attention.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv)


@pytest.mark.parametrize("D", [8, 16, 96])
def test_padded_head_dims_launch_the_kernels(D):
    g = torch.Generator(device="cuda").manual_seed(D)
    q, k, v, dout = (torch.randn(2, 150, 3, D, device="cuda", generator=g)
                     .to(torch.bfloat16) for _ in range(4))
    mask = torch.arange(150, device="cuda")[None, :] < torch.tensor([[150], [77]],
                                                                     device="cuda")
    before = _counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, mask=mask)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert _counts() == tuple(n + 1 for n in before)
    plain_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_plain(*plain_leaves, mask=mask)
    want_grads = torch.autograd.grad(want, plain_leaves, dout)
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-5)
    for a, b in zip(grads, want_grads):
        assert a.shape == q.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item()


@pytest.mark.parametrize("heads", [4, 1], ids=["head_dim_16", "head_dim_64"])
def test_small_bert_export_serves_on_the_card_and_the_cpu(tmp_path, heads):
    config = {**SMALL, "num_heads": heads}
    cfg = bert_inference.qa_config(config)
    sd = init_params(cfg, 0)
    model = build_qa_model(cfg, sd, "cuda")
    d = bert_train.export(str(tmp_path / "e"), model, seq_len=40)
    rows = bert_inference.make_rows(3, 40, 128, seed=1)
    cols = [np.stack([r[c] for r in rows]) for c in range(3)]
    with torch.no_grad():
        want = bert_inference.forward_batch(model, cols, 3, "cuda")

    exported = ExportedModel.load(d)                     # the card, by default
    before = flash_attention.launches
    got = bert_inference.forward_batch(exported, cols, 3, "cuda")
    assert flash_attention.launches - before == SMALL["num_layers"]
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()

    on_cpu = ExportedModel.load(d, device="cpu")
    cpu_model = build_qa_model(cfg, sd, "cpu")
    with torch.no_grad():
        cpu_want = bert_inference.forward_batch(cpu_model, cols, 3, "cpu")
    for a, b in zip(bert_inference.forward_batch(on_cpu, cols, 3, "cpu"), cpu_want):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize("partitions", [4, 1])
def test_tfmodel_transform_on_the_card_from_threads(tmp_path, partitions):
    """``TFModel.transform`` loads the export on the card and serves one
    partition a thread: K1 once a layer and batch, counted from every
    thread, and logits equal to the signature called in this thread."""
    from tensorflowonspark_tpu_torch.dataframe import DataFrame, Row

    config = {**SMALL, "num_heads": 1}
    cfg = bert_inference.qa_config(config)
    model = build_qa_model(cfg, init_params(cfg, 0), "cuda")
    d = bert_train.export(str(tmp_path / "e"), model, seq_len=40)
    rows = bert_inference.make_rows(32, 40, 128, seed=2)
    names = list(bert_train.SERVE_INPUTS)
    df = DataFrame([Row(_fields=names, _values=list(r)) for r in rows],
                   num_partitions=partitions)
    tf_model = pl.TFModel().setExportDir(d).setBatchSize(8)
    before = flash_attention.launches
    out = tf_model.transform(df).collect()
    assert flash_attention.launches - before == SMALL["num_layers"] * 4
    sig = pl._load_model_cached(d, "serve").signature()
    assert sig.device.type == "cuda"
    for b in range(0, 32, 8):
        want = sig(*[np.stack([r[c] for r in rows[b:b + 8]]) for c in range(3)])
        for name in bert_train.SERVE_OUTPUTS:
            got = np.stack([np.asarray(getattr(r, name)) for r in out[b:b + 8]])
            assert np.array_equal(got, want[name].cpu().numpy())


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_a_card_checkpoint_restores_on_the_cpu_bit_for_bit(tmp_path, async_save):
    torch.manual_seed(0)
    strategy = DataParallelStrategy("cuda")
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.BatchNorm1d(32),
                                torch.nn.Linear(32, 4))
    state = strategy.init_state(model, lambda p: torch.optim.AdamW(p, lr=1e-3))
    step = strategy.build_train_step(
        lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]))
    for i in range(3):
        x = torch.randn(8, 16, device="cuda")
        state, _ = step(state, (x, torch.randint(0, 4, (8,), device="cuda")))
    live = {**state.state_dict(), "data": {"elements_consumed": 3}}
    with CheckpointManager(str(tmp_path / "m"), async_save=async_save) as mngr:
        assert mngr.save(state.step, live)
    restored = restore_checkpoint(str(tmp_path / "m"))
    assert restored["step"] == 3 and restored["data"] == {"elements_consumed": 3}
    for k, t in live["model"].items():
        assert restored["model"][k].device.type == "cpu"
        assert torch.equal(restored["model"][k], t.cpu()), k
    for k, s in live["optim"]["state"].items():
        for name, t in s.items():
            assert torch.equal(restored["optim"]["state"][k][name], t.cpu()), (k, name)
    assert sorted(os.listdir(tmp_path / "m")) == ["3"]
