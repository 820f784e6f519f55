"""MNIST CNN — the reference's stock example workload, in PyTorch.

Port of ``tensorflowonspark_tpu/models/mnist.py`` (``BASELINE.json``
configs[0]): Conv 32 -> pool -> Conv 64 -> pool -> Dense 128 -> Dropout
0.25 -> Dense 10, in float32.  The module is NCHW and flattens the last
feature map as ``(c, h, w)``; flax flattens its NHWC map as ``(h, w, c)``,
so :func:`params_from_flax` permutes the first Dense's input rows.
Dropout draws its mask from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.bert import _dense, _dropout

DROPOUT = 0.25


class MNISTNet(nn.Module):
    """Conv-pool x2 -> dense, the reference example's topology.  Input
    ``[B, 28, 28]`` or ``[B, 1, 28, 28]`` in [0, 1]; float32 logits."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)     # flax "SAME" at stride 1
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(7 * 7 * 64, 128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        if x.dim() == 3:
            x = x[:, None]
        dt = self.dtype
        x = x.to(dt)
        for conv in (self.conv1, self.conv2):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.max_pool2d(F.relu(x), 2)
        x = F.relu(_dense(self.fc1, x.flatten(1), dt))
        x = _dropout(x, DROPOUT, train, rng)
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


def params_from_flax(params: dict) -> dict:
    """A flax ``MNISTNet``'s params as this module's state dict: HWIO
    kernels become OIHW, Dense ``(in, out)`` kernels ``(out, in)``, and the
    first Dense's rows go from flax's ``(h, w, c)`` flatten to ``(c, h,
    w)``."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    k1 = t(params["Dense_0"]["kernel"])                      # [7*7*64, 128], rows (h, w, c)
    k1 = k1.reshape(7, 7, 64, -1).permute(2, 0, 1, 3).reshape(7 * 7 * 64, -1)
    sd = {"fc1.weight": k1.t().contiguous(), "fc1.bias": t(params["Dense_0"]["bias"]),
          "fc2.weight": t(params["Dense_1"]["kernel"]).t().contiguous(),
          "fc2.bias": t(params["Dense_1"]["bias"])}
    for i, name in enumerate(("conv1", "conv2")):
        sd[f"{name}.weight"] = t(params[f"Conv_{i}"]["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{name}.bias"] = t(params[f"Conv_{i}"]["bias"])
    return sd
