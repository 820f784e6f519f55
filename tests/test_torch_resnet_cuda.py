"""The ResNet slice's device side on the card: ``device_prefetch``,
``cache_on_device`` and ResNet-50 on the card against the port's CPU path.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet_cuda.py

ResNet-50 tolerances (one train-mode step at 224 px, batch 2, flax's
initial kernels with BatchNorm scales from U(0.5, 1.5) and each block's
last from U(0.05, 0.15), so that no block's branch is silenced; the card
against the port's float32 path on the CPU, which the CPU tests hold
against flax): max |logit diff| / max |logit|, and the gradients' max
and median ``||g - g_cpu|| / ||g_cpu||``, below.  ``chip_smoke.py`` reads
the same quantities at batch 8 (PERF.md, "Gate calibration" of the
ResNet slice).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.data import Dataset, device_prefetch
from tensorflowonspark_tpu_torch.models import resnet

pytestmark = pytest.mark.cuda

#: BatchNorm scales U(0.5, 1.5), each block's last U(0.05, 0.15), as
#: ``chip_smoke.RESNET_GATE_SCALES``; the bounds are ``chip_smoke``'s
#: (``RESNET_F32_TOL``, ``RESNET_TOL``), which its ``--calibrate-resnet``
#: readings at batch 2 also keep
SCALES = (0.5, 1.5, 0.05, 0.15)
LOGITS_F32, MAX_F32, MEDIAN_F32 = 1e-5, 0.05, 1e-2
LOGITS_BF16, MAX_BF16, MEDIAN_BF16 = 2e-2, 0.6, 0.4


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_yields_what_a_synchronous_copy_gives(depth):
    rng = np.random.default_rng(depth)
    host = [(rng.standard_normal((64, 3, 56, 56), np.float32), rng.integers(0, 10, 64))
            for _ in range(6)]
    sums = []
    for x, y in device_prefetch(iter(host), depth=depth):
        assert x.is_cuda and y.is_cuda
        sums.append((x.double().sum(dim=(1, 2, 3)) + y).cpu())   # kernels on the consumer's stream
    for (x, y), got in zip(host, sums):
        want = (torch.from_numpy(x).cuda().double().sum(dim=(1, 2, 3))
                + torch.from_numpy(y).cuda()).cpu()
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert len(sums) == len(host)


def test_cache_on_device_replays_without_host_traffic():
    calls = [0]

    def gen():
        calls[0] += 1
        yield from ((np.full((4, 8), i, np.float32), np.int64(i)) for i in range(3))

    ds = Dataset.from_generator(gen).cache_on_device()
    first = list(ds)
    second = list(ds.repeat(2))
    assert calls[0] == 1
    assert all(t.is_cuda for b in first for t in b)
    # the replay hands back the tensors of the first pass: no copy was made
    assert [b[0].data_ptr() for b in second] == [b[0].data_ptr() for b in first] * 2
    assert [float(b[0][0, 0]) for b in second] == [0.0, 1.0, 2.0] * 2


def _step(sd, x, y, device, dtype):
    model = resnet.ResNet50(dtype=dtype, norm_dtype=torch.float32)
    model.load_state_dict(sd)
    model = model.to(device)
    x = x.to(device)
    if device == "cuda":
        model = model.to(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
    logits = model(x, train=True)
    torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
    return (logits.detach().float().cpu(),
            {n: p.grad.float().cpu() for n, p in model.named_parameters()})


def _readings(dtype, padding=resnet.same_padding):
    """One step on the card (``dtype`` convolutions, ``padding`` for every
    convolution) against the CPU's float32 step: the logits' max |diff| /
    max |logit|, and the gradients' max and median ``||g - g_cpu|| /
    ||g_cpu||``."""
    sd = resnet.init_params(resnet.ResNet50(), 0, SCALES)
    rng = np.random.default_rng([0, 2])
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224), np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, 2).astype(np.int64))
    cpu_logits, cpu_grads = _step(sd, x, y, "cpu", torch.float32)
    with mock.patch.object(resnet, "same_padding", padding):
        logits, grads = _step(sd, x, y, "cuda", dtype)
    # no branch is silenced: every parameter has a gradient
    assert all(float(g.norm()) > 0 for g in cpu_grads.values())
    rel = [float((grads[n] - g).norm() / g.norm()) for n, g in cpu_grads.items()]
    return (float((logits - cpu_logits).abs().max() / cpu_logits.abs().max()),
            max(rel), float(np.median(rel)))


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, (LOGITS_F32, MAX_F32, MEDIAN_F32)),
    (torch.bfloat16, (LOGITS_BF16, MAX_BF16, MEDIAN_BF16))], ids=["float32", "bf16"])
def test_resnet50_on_the_card_matches_the_cpu_path(dtype, tol):
    got = _readings(dtype)
    assert all(r <= t for r, t in zip(got, tol)), (got, tol)


def test_resnet50_gate_sees_symmetric_strided_padding():
    """The strided 3x3 convolutions padded (1, 1), PyTorch's default, fall
    outside the bf16 tolerances."""
    got = _readings(torch.bfloat16, lambda size, k, stride: ((k - 1) // 2, (k - 1) // 2))
    assert any(r > t for r, t in zip(got, (LOGITS_BF16, MAX_BF16, MEDIAN_BF16))), got
