"""U-Net for image segmentation, in PyTorch.

Port of ``tensorflowonspark_tpu/models/unet.py``.  Reference workload:
``examples/segmentation`` (a U-Net over TFRecords).  NCHW in its logical
layout (``channels_last`` on the card); numerics follow the flax modules:

- :class:`ConvBlock` is two rounds of a bias-free 3x3 SAME convolution in
  ``dtype`` (bf16 by default), a float32 GroupNorm of ``min(32, filters)``
  groups with flax's **eps 1e-6** (PyTorch's default is 1e-5), and ReLU;
- the encoder max-pools 2x2/2 (VALID), the decoder upsamples with flax's
  ``ConvTranspose((2, 2), strides=(2, 2))`` and concatenates ``[up, skip]``;
- flax's ``ConvTranspose`` is a convolution over the input dilated by the
  stride with the kernel as it is (``transpose_kernel=False``): its
  output ``2i + a`` takes kernel tap ``1 - a``, where PyTorch's
  ``conv_transpose2d`` (the adjoint of a convolution) takes tap ``a``.  So
  :func:`params_from_flax` carries the kernel flipped in both spatial axes,
  with flax's ``(kh, kw, in, out)`` becoming ``(in, out, kh, kw)``;
- the head is a float32 1x1 convolution with a bias.

:func:`params_from_flax` carries a flax model's ``params`` across;
:func:`init_params` draws flax's initialisers from a seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models.resnet import Conv, _lecun_normal, _t

GN_EPS = 1e-6


class ConvBlock(nn.Module):
    """(3x3 conv -> GroupNorm -> ReLU) x 2; ``Conv_k``/``GroupNorm_k`` of
    the flax block are ``convs.k``/``norms.k``."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.groups = min(32, filters)
        self.convs = nn.ModuleList([Conv(in_channels, filters, 3), Conv(filters, filters, 3)])
        self.norms = nn.ModuleList(nn.GroupNorm(self.groups, filters, eps=GN_EPS)
                                   for _ in range(2))

    def forward(self, x, dtype: torch.dtype):
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(F.group_norm(conv(x, dtype).float(), self.groups, norm.weight,
                                    norm.bias, GN_EPS))
        return x


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (2, 2), strides=(2, 2),
    dtype=dtype)``: ``weight`` ``(in, out, 2, 2)`` as ``conv_transpose2d``
    takes it (the flax kernel flipped, :func:`params_from_flax`) and a
    bias, both cast with the input to ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 2, 2))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, dtype: torch.dtype):
        return F.conv_transpose2d(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype),
                                  stride=2)


class UNet(nn.Module):
    """Classic U-Net; ``features`` sets the per-level channel counts.
    Input ``[B, 3, H, W]`` with H and W divisible by ``2 ** (levels -
    1)``; float32 logits ``[B, num_classes, H, W]``."""

    def __init__(self, num_classes: int = 2, features: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        self.features, self.dtype = tuple(features), dtype
        down, c = [], in_channels
        for f in self.features[:-1]:
            down.append(ConvBlock(c, f))
            c = f
        self.down = nn.ModuleList(down)
        self.mid = ConvBlock(c, self.features[-1])
        c = self.features[-1]
        ups, dec = [], []
        for f in reversed(self.features[:-1]):
            ups.append(ConvTranspose(c, f))
            dec.append(ConvBlock(2 * f, f))
            c = f
        self.ups, self.dec = nn.ModuleList(ups), nn.ModuleList(dec)
        self.head = nn.Conv2d(c, num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        skips = []
        for blk in self.down:
            x = blk(x, dt)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.mid(x, dt)
        for up, blk, skip in zip(self.ups, self.dec, reversed(skips)):
            x = up(x, dt)
            x = blk(torch.cat([x, skip.to(x.dtype)], dim=1), dt)
        return F.conv2d(x.float(), self.head.weight, self.head.bias)


# ------------------------------------------------------------- weights

def init_params(model: UNet, seed: int) -> dict:
    """A state dict for ``model`` from ``seed`` with flax's initialisers:
    every kernel ``lecun_normal`` (fan-in ``kh * kw * in``; the transposed
    convolutions' as flax counts it), biases 0, GroupNorm scale 1 and bias
    0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, (Conv, nn.Conv2d)):
            w = mod.weight
            sd[p + "weight"] = torch.from_numpy(_lecun_normal(rng, tuple(w.shape), w[0].numel()))
            if getattr(mod, "bias", None) is not None:
                sd[p + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, ConvTranspose):
            w = mod.weight
            sd[p + "weight"] = torch.from_numpy(
                _lecun_normal(rng, tuple(w.shape), w.shape[0] * w.shape[2] * w.shape[3]))
            sd[p + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, nn.GroupNorm):
            sd[p + "weight"] = torch.ones(mod.weight.shape)
            sd[p + "bias"] = torch.zeros(mod.bias.shape)
    return sd


def params_from_flax(params: dict, num_levels: int) -> dict:
    """A flax ``UNet``'s ``params`` as this module's state dict, for a
    model of ``num_levels = len(features)``.  flax names the blocks in call
    order: ``ConvBlock_0..L-2`` the encoder, ``ConvBlock_{L-1}`` the
    bottleneck, ``ConvBlock_{L+j}`` the decoder's ``j``-th, after
    ``ConvTranspose_j``; ``Conv_0`` is the head.  Conv kernels HWIO become
    OIHW; ConvTranspose kernels HWIO become ``(in, out, kh, kw)`` flipped in
    both spatial axes (module docstring)."""
    sd = {}

    def block(prefix, p):
        for k in range(2):
            sd[f"{prefix}.convs.{k}.weight"] = _t(p[f"Conv_{k}"]["kernel"]).permute(3, 2, 0, 1)
            sd[f"{prefix}.norms.{k}.weight"] = _t(p[f"GroupNorm_{k}"]["scale"])
            sd[f"{prefix}.norms.{k}.bias"] = _t(p[f"GroupNorm_{k}"]["bias"])

    for name, sub in params.items():
        kind, idx = name.rsplit("_", 1)
        i = int(idx)
        if kind == "ConvBlock":
            block("down.%d" % i if i < num_levels - 1 else
                  "mid" if i == num_levels - 1 else "dec.%d" % (i - num_levels), sub)
        elif kind == "ConvTranspose":
            sd[f"ups.{i}.weight"] = _t(sub["kernel"]).permute(2, 3, 0, 1).flip(2, 3)
            sd[f"ups.{i}.bias"] = _t(sub["bias"])
        else:                                       # Conv_0, the head
            sd["head.weight"] = _t(sub["kernel"]).permute(3, 2, 0, 1)
            sd["head.bias"] = _t(sub["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
