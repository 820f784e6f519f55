"""Inception-v3 in PyTorch.

Port of ``tensorflowonspark_tpu/models/inception.py``.  Reference workload:
the historical ``examples/imagenet/inception`` job, the original
TensorFlowOnSpark launch demo.  The modules are NCHW in their logical
layout; on the card the caller makes the model and its input
``channels_last`` (cuDNN's NHWC convolutions).  Numerics follow the flax
modules, from the ResNet port's pieces (``models/resnet.py``):

- every unit is :class:`ConvBN`: a bias-free convolution in ``dtype``
  (bf16 by default) with flax's per-axis SAME padding (the factorised
  1x7/7x1 and 1x3/3x1 kernels pad one axis only), or VALID; then a float32
  BatchNorm with momentum 0.9 and **eps 1e-3** (ResNet's is 1e-5), whose
  float32 output goes through ReLU;
- the 3x3 SAME average pool counts the padded zeros
  (``count_include_pad=True``), as flax's ``avg_pool`` does; max pools are
  VALID;
- branches concatenate on the channel dim in the flax order;
- the auxiliary head (``aux_logits=True``) runs only in training calls: a
  5x5/3 VALID average pool, a 1x1 ConvBN to 128, a ConvBN to 768 whose
  kernel is the whole remaining grid, a spatial mean and a float32 Dense.
  Its grid is fixed by ``image_size`` (a torch module holds its kernel's
  shape from the start), and a grid under 5 wide raises, as the flax
  module does when it is called;
- the dropout before the float32 classifier draws its mask from the
  explicit ``torch.Generator`` ``rng``.

``forward(x, train=True, rng=...)`` returns ``(logits, aux_logits)`` with
the aux head, else the logits.  :func:`params_from_flax` carries a flax
model's ``params`` and ``batch_stats`` across; :func:`init_params` draws
flax's initialisers from a seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.models import resnet
from tensorflowonspark_tpu_torch.models.bert import _dropout
from tensorflowonspark_tpu_torch.models.resnet import BatchNorm, Conv

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (in ``dtype``) -> BatchNorm (eps 1e-3, returning ``norm_dtype``,
    float32 as in the flax module) -> ReLU."""

    def __init__(self, in_channels: int, filters: int, kernel=(3, 3), strides=(1, 1),
                 padding="SAME"):
        super().__init__()
        self.conv = Conv(in_channels, filters, kernel, strides, padding)
        self.bn = BatchNorm(filters, eps=BN_EPS)

    def forward(self, x, train: bool, dtype: torch.dtype, norm_dtype: torch.dtype):
        return F.relu(self.bn(self.conv(x, dtype), train, norm_dtype))


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A mixed block: ``convs`` in the flax module's call order
    (``ConvBN_i`` is ``convs.i``)."""

    def __init__(self, specs, dtype, norm_dtype=torch.float32):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.convs = nn.ModuleList(ConvBN(*s) for s in specs)

    def run(self, i: int, x, train: bool):
        return self.convs[i](x, train, self.dtype, self.norm_dtype)


class InceptionA(_Block):
    """35x35 mixed block: 1x1 / 5x5 / double-3x3 / pool-proj branches."""

    def __init__(self, c: int, pool_filters: int, dtype, norm_dtype=torch.float32):
        super().__init__([(c, 64, 1), (c, 48, 1), (48, 64, 5), (c, 64, 1), (64, 96, 3),
                          (96, 96, 3), (c, pool_filters, 1)], dtype, norm_dtype)
        self.out_channels = 64 + 64 + 96 + pool_filters

    def forward(self, x, train: bool = False):
        r = self.run
        b1 = r(0, x, train)
        b5 = r(2, r(1, x, train), train)
        b3 = r(5, r(4, r(3, x, train), train), train)
        bp = r(6, _avg_pool_same(x), train)
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, c: int, dtype, norm_dtype=torch.float32):
        super().__init__([(c, 384, 3, 2, "VALID"), (c, 64, 1), (64, 96, 3),
                          (96, 96, 3, 2, "VALID")], dtype, norm_dtype)
        self.out_channels = 384 + 96 + c

    def forward(self, x, train: bool = False):
        r = self.run
        b3 = r(0, x, train)
        bd = r(3, r(2, r(1, x, train), train), train)
        bp = _max_pool_valid(x)
        return torch.cat([b3, bd, bp.to(b3.dtype)], dim=1)


class InceptionB(_Block):
    """17x17 mixed block with factorised 1x7 / 7x1 convolutions."""

    def __init__(self, c: int, c7: int, dtype, norm_dtype=torch.float32):
        super().__init__([(c, 192, 1), (c, c7, 1), (c7, c7, (1, 7)), (c7, 192, (7, 1)),
                          (c, c7, 1), (c7, c7, (7, 1)), (c7, c7, (1, 7)), (c7, c7, (7, 1)),
                          (c7, 192, (1, 7)), (c, 192, 1)], dtype, norm_dtype)
        self.out_channels = 4 * 192

    def forward(self, x, train: bool = False):
        r = self.run
        b1 = r(0, x, train)
        b7 = r(3, r(2, r(1, x, train), train), train)
        bd = r(8, r(7, r(6, r(5, r(4, x, train), train), train), train), train)
        bp = r(9, _avg_pool_same(x), train)
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, c: int, dtype, norm_dtype=torch.float32):
        super().__init__([(c, 192, 1), (192, 320, 3, 2, "VALID"), (c, 192, 1),
                          (192, 192, (1, 7)), (192, 192, (7, 1)),
                          (192, 192, 3, 2, "VALID")], dtype, norm_dtype)
        self.out_channels = 320 + 192 + c

    def forward(self, x, train: bool = False):
        r = self.run
        b3 = r(1, r(0, x, train), train)
        b7 = r(5, r(4, r(3, r(2, x, train), train), train), train)
        bp = _max_pool_valid(x)
        return torch.cat([b3, b7, bp.to(b3.dtype)], dim=1)


class InceptionC(_Block):
    """8x8 mixed block with split 1x3 / 3x1 output branches."""

    def __init__(self, c: int, dtype, norm_dtype=torch.float32):
        super().__init__([(c, 320, 1), (c, 384, 1), (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (c, 448, 1), (448, 384, 3), (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (c, 192, 1)], dtype, norm_dtype)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x, train: bool = False):
        r = self.run
        b1 = r(0, x, train)
        b3 = r(1, x, train)
        b3 = torch.cat([r(2, b3, train), r(3, b3, train)], dim=1)
        bd = r(5, r(4, x, train), train)
        bd = torch.cat([r(6, bd, train), r(7, bd, train)], dim=1)
        bp = r(8, _avg_pool_same(x), train)
        return torch.cat([b1, b3, bd, bp], dim=1)


def aux_grid(image_size: int) -> int:
    """The aux head's grid after its 5x5/3 pool, for a square input of
    ``image_size``: 5 at 299 px, 1 at 139 px."""
    s = (image_size - 3) // 2 + 1          # stem 3x3/2 VALID
    s = s - 2                              # 3x3 VALID (the SAME 3x3 keeps it)
    s = (s - 3) // 2 + 1                   # max pool
    s = s - 2                              # 1x1 VALID, then 3x3 VALID
    s = (s - 3) // 2 + 1                   # max pool: the 35x35 stage
    s = (s - 3) // 2 + 1                   # ReductionA: the 17x17 stage
    return (s - 5) // 3 + 1 if s >= 5 else 0


class InceptionV3(nn.Module):
    """Inception-v3 (299x299 canonical; any size from 75 px works without
    the aux head).  ``image_size`` sizes the aux head's last kernel;
    ``norm_dtype`` is what BatchNorm returns (float32, the flax module's;
    float64 only for a float64 comparison)."""

    def __init__(self, num_classes: int = 1000, aux_logits: bool = False,
                 dropout_rate: float = 0.2, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 299, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.aux_logits = num_classes, aux_logits
        self.dropout_rate, self.dtype, self.norm_dtype = dropout_rate, dtype, norm_dtype
        nd = norm_dtype
        self.stem = nn.ModuleList([ConvBN(3, 32, 3, 2, "VALID"), ConvBN(32, 32, 3, 1, "VALID"),
                                   ConvBN(32, 64, 3), ConvBN(64, 80, 1, 1, "VALID"),
                                   ConvBN(80, 192, 3, 1, "VALID")])
        blocks, c = [], 192
        for pf in (32, 64, 64):
            blocks.append(InceptionA(c, pf, dtype, nd))
            c = blocks[-1].out_channels
        blocks.append(ReductionA(c, dtype, nd))
        c = blocks[-1].out_channels
        for c7 in (128, 160, 160, 192):
            blocks.append(InceptionB(c, c7, dtype, nd))
            c = blocks[-1].out_channels
        self.n_before_aux = len(blocks)
        self.aux = self.aux_head = None
        if aux_logits:
            grid = aux_grid(image_size)
            if grid < 1:
                raise ValueError(
                    f"aux_logits=True needs a >=5-wide 17x17-stage grid, got none at "
                    f"{image_size}px (input too small; use inputs >= ~139px or "
                    "aux_logits=False)")
            self.aux = nn.ModuleList([ConvBN(c, 128, 1), ConvBN(128, 768, grid, 1, "VALID")])
            self.aux_head = nn.Linear(768, num_classes)
        blocks.append(ReductionB(c, dtype, nd))
        c = blocks[-1].out_channels
        for _ in range(2):
            blocks.append(InceptionC(c, dtype, nd))
            c = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False, rng=None):
        dt, nd = self.dtype, self.norm_dtype
        x = x.to(dt)
        x = self.stem[0](x, train, dt, nd)
        x = self.stem[1](x, train, dt, nd)
        x = _max_pool_valid(self.stem[2](x, train, dt, nd))
        x = self.stem[3](x, train, dt, nd)
        x = _max_pool_valid(self.stem[4](x, train, dt, nd))
        for blk in self.blocks[:self.n_before_aux]:
            x = blk(x, train)
        aux = None
        if self.aux_logits and train:
            if min(x.shape[2:]) < 5:
                raise ValueError(
                    f"aux_logits=True needs a >=5-wide 17x17-stage grid, got "
                    f"{x.shape[2]}x{x.shape[3]} (input too small; use inputs "
                    ">= ~139px or aux_logits=False)")
            a = F.avg_pool2d(x, 5, 3)
            a = self.aux[1](self.aux[0](a, train, dt, nd), train, dt, nd)
            aux = self._f32_dense(self.aux_head, a.mean(dim=(2, 3)))
        for blk in self.blocks[self.n_before_aux:]:
            x = blk(x, train)
        x = _dropout(x.mean(dim=(2, 3)), self.dropout_rate, train, rng)
        logits = self._f32_dense(self.fc, x)
        return (logits, aux) if aux is not None else logits

    def _f32_dense(self, layer: nn.Linear, x):
        """flax ``Dense(dtype=float32)``: a float32 product (in the
        parameters' dtype, float64 in a float64 comparison)."""
        x = x.to(torch.promote_types(layer.weight.dtype, torch.float32))
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


# ------------------------------------------------------------- weights

def init_params(model: InceptionV3, seed: int, scales: tuple | None = None) -> dict:
    """A state dict for ``model`` drawn from ``seed`` with flax's
    initialisers (``resnet.init_params``: ``lecun_normal`` kernels, zero
    biases, unit BatchNorm scales, or scales from U(lo, hi) with
    ``scales=(lo, hi)``)."""
    return resnet.init_params(model, seed, scales)


def _flax_prefix(name: str) -> str:
    """The torch prefix of a top-level flax module name."""
    if name == "aux_head":
        return name
    kind, idx = name.rsplit("_", 1)
    i = int(idx)
    if kind == "ConvBN":                       # the stem, then the aux head's two
        return f"stem.{i}" if i < 5 else f"aux.{i - 5}"
    offset = {"InceptionA": 0, "ReductionA": 3, "InceptionB": 4, "ReductionB": 8,
              "InceptionC": 9}
    if kind in offset:
        return f"blocks.{offset[kind] + i}"
    return "fc"                                # Dense_0


def params_from_flax(params: dict, batch_stats: dict) -> dict:
    """A flax ``InceptionV3``'s ``params`` and ``batch_stats`` as this
    module's state dict: HWIO kernels become OIHW (a 1x7 stays 1x7: flax
    ``(1, 7, in, out)`` is torch ``(out, in, 1, 7)``), BatchNorm ``scale``
    the ``weight`` and ``mean``/``var`` the running buffers, Dense kernels
    ``(in, out)`` become ``(out, in)``.  Top-level ``ConvBN_0..4`` are the
    stem, ``ConvBN_5..6`` the aux head's; ``ConvBN_i`` inside a block is its
    ``convs.i``."""
    t = resnet._t
    sd = {}

    def conv_bn(prefix, p, s):
        sd[f"{prefix}.conv.weight"] = t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{prefix}.bn.weight"] = t(p["BatchNorm_0"]["scale"])
        sd[f"{prefix}.bn.bias"] = t(p["BatchNorm_0"]["bias"])
        sd[f"{prefix}.bn.running_mean"] = t(s["BatchNorm_0"]["mean"])
        sd[f"{prefix}.bn.running_var"] = t(s["BatchNorm_0"]["var"])

    for name, sub in params.items():
        prefix = _flax_prefix(name)
        stats = batch_stats.get(name, {})
        if name.startswith("ConvBN"):
            conv_bn(prefix, sub, stats)
        elif "kernel" in sub:                  # Dense_0 and aux_head
            sd[f"{prefix}.weight"] = t(sub["kernel"]).t().contiguous()
            sd[f"{prefix}.bias"] = t(sub["bias"])
        else:
            for inner, leaf in sub.items():
                conv_bn(f"{prefix}.convs.{inner.rsplit('_', 1)[1]}", leaf, stats[inner])
    return sd
