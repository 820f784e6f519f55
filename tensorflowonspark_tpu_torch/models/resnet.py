"""ResNet family (v1.5) in PyTorch.

Port of ``tensorflowonspark_tpu/models/resnet.py``: ``BASELINE.json``'s
CIFAR ResNet (``CifarResNet``) and the ResNet-50 ImageNet job whose
training step ``bench.py::bench_resnet`` times.  The modules are NCHW in
their logical layout; on the card the caller makes the model and its input
``channels_last``, which cuDNN's convolutions and PyTorch's BatchNorm
kernels take as NHWC memory.  Numerics follow the flax modules:

- parameters are float32; a convolution casts its input and kernel to
  ``dtype`` (bf16) and returns ``dtype`` (flax ``nn.Conv(dtype=...)``);
- padding is flax's ``"SAME"`` (:func:`same_padding`): at stride 2 on an
  even input a 3x3 convolution pads **(0, 1)**, not PyTorch's symmetric
  ``padding=1``; the s2d stem pads ``(2, 1)``.  Asymmetric pads go through
  ``F.pad``;
- BatchNorm (:class:`BatchNorm`) normalises in float32 with float32
  statistics and returns ``norm_dtype``; in training it updates its
  running statistics as flax does: ``ra = 0.9 ra + 0.1 batch`` with the
  **biased** batch variance (PyTorch's own BatchNorm uses the unbiased
  one).  In a process group of more than one member the batch statistics
  are those of the global batch: the per-channel sums are all-reduced,
  with the gradient through the reduction, as XLA reduces flax's
  statistics over the data axis of the JAX strategy's sharded batch, so
  the running statistics stay equal on every replica;
- the last BatchNorm of each block starts with scale 0, the max-pool pads
  with -inf, and the classifier is a float32 Dense.

:func:`params_from_flax` carries a flax ResNet's ``params`` and
``batch_stats`` across; :func:`init_params` draws flax's initialisers from
a numpy seed.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

IN_CHANNELS = 3      # RGB images


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NCHW space-to-depth: ``[B, C, H, W] -> [B, b*b*C, H/b, W/b]`` with
    channel order ``(dy, dx, c)``, the flax function's NHWC result seen as
    NCHW.  A ``channels_last`` input gives a ``channels_last`` result."""
    B, C, H, W = x.shape
    if H % block or W % block:
        raise ValueError(f"space_to_depth needs H and W divisible by "
                         f"{block}, got {H}x{W} (pad or crop the input)")
    y = x.permute(0, 2, 3, 1).reshape(B, H // block, block, W // block, block, C)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H // block, W // block, block * block * C)
    y = y.permute(0, 3, 1, 2)
    return y if _channels_last(x) else y.contiguous()


def conv7_stem_to_s2d_kernel(k7: torch.Tensor) -> torch.Tensor:
    """The exact weight transform from the 7x7/s2 stem to the s2d stem's
    4x4/s1 kernel, in OIHW: ``[O, C, 7, 7] -> [O, 4C, 4, 4]``.  The 7x7
    kernel padded one row and column at the top and left is an 8x8
    stride-2 kernel, which on the space-to-depth image is a 4x4 stride-1
    kernel over ``(dy, dx, c)`` channels (the flax function's transform)."""
    O, C = k7.shape[:2]
    k8 = F.pad(k7, (1, 0, 1, 0))
    k4 = k8.reshape(O, C, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k4.reshape(O, 4 * C, 4, 4)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding ``(low, high)`` of one spatial dim: the
    output has ``ceil(size / stride)`` positions and the odd pad, if any,
    goes at the end.  A 3x3 stride-2 convolution on an even input pads
    ``(0, 1)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _channels_last(x: torch.Tensor) -> bool:
    return (x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous())


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding, use_bias=False,
    dtype=dtype)``: an OIHW float32 kernel, cast with the input to ``dtype``
    for the product.  ``padding`` is ``"SAME"`` or explicit ``((top,
    bottom), (left, right))``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding="SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        k, s = self.kernel, self.stride
        if self.padding == "SAME":
            (top, bottom), (left, right) = (same_padding(x.shape[2], k, s),
                                            same_padding(x.shape[3], k, s))
        else:
            (top, bottom), (left, right) = self.padding
        x, w = x.to(dtype), self.weight.to(dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, None, s, (top, left))
        padded = F.pad(x, (left, right, top, bottom))
        if _channels_last(x) and not _channels_last(padded):
            padded = padded.contiguous(memory_format=torch.channels_last)
        return F.conv2d(padded, w, None, s, 0)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, whose gradient is the sum of every
    process's gradient (each process's loss depends on every process's
    activations through the global statistics)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=norm_dtype)``
    over the channel dim: float32 ``weight`` (flax's ``scale``, 0 when
    ``zero_scale``), ``bias``, and ``running_mean``/``running_var`` buffers
    (flax's ``batch_stats`` ``mean``/``var``)."""

    momentum, eps = 0.9, 1e-5          # every BatchNorm of the flax ResNet

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype) -> torch.Tensor:
        # the input as the normalisation reads it: flax computes in float32
        # and casts to ``dtype``; PyTorch's kernels return their input's dtype
        # (and compute in float32 for bf16), so a bf16 input is taken as it
        # is only when bf16 is also the output
        xin = x if x.dtype == dtype else x.float()
        if not train:
            return F.batch_norm(xin, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(dtype)
        if _group_size() > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.ops.aten._native_batch_norm_legit.no_stats(
                xin, self.weight, self.bias, True, 0.0, self.eps)
            var = invstd.detach().pow(-2) - self.eps      # the biased batch variance
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        return y.to(dtype)

    def _global_batch_norm(self, x):
        """Training BatchNorm over the whole process group's batch: the
        per-channel count and sum are all-reduced for the mean, then the
        sum of squared deviations for the biased variance (two passes, as
        PyTorch's single-process kernels are accurate; flax's ``E[x^2] -
        E[x]^2`` loses digits when the mean is large against the spread)."""
        C = x.shape[1]
        xf = x.float()
        dims, shape = (0, 2, 3), (1, C, 1, 1)
        sums = _AllReduceSum.apply(torch.stack([xf.sum(dims),
                                                xf.new_full((C,), float(x.numel() // C))]))
        mean = sums[0] / sums[1]
        centred = xf - mean.view(shape)
        var = _AllReduceSum.apply((centred * centred).sum(dims)) / sums[1]
        y = centred * (torch.rsqrt(var + self.eps) * self.weight).view(shape) + self.bias.view(shape)
        return y, mean, var


class BasicBlock(nn.Module):
    """flax ``BasicBlock``: 3x3 (stride) -> BN -> relu -> 3x3 -> BN (scale
    0), plus a 1x1 projection with BN when the shape changes."""

    expansion = 1
    convs = ("conv1", "conv2", "proj")             # flax's Conv_0, Conv_1, Conv_2
    norms = ("bn1", "bn2", "proj_bn")

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        self.conv1 = Conv(in_channels, filters, 3, strides)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        self.proj = self.proj_bn = None
        if strides != 1 or in_channels != filters:
            self.proj = Conv(in_channels, filters, 1, strides)
            self.proj_bn = BatchNorm(filters)

    def forward(self, x, train: bool = False):
        dt, nd = self.dtype, self.norm_dtype
        y = F.relu(self.bn1(self.conv1(x, dt), train, nd))
        y = self.bn2(self.conv2(y, dt), train, nd)
        residual = x if self.proj is None else self.proj_bn(self.proj(x, dt), train, nd)
        return F.relu(y + residual.to(y.dtype))


class Bottleneck(nn.Module):
    """flax ``Bottleneck`` (v1.5: the stride on the 3x3): 1x1 -> BN ->
    relu -> 3x3 (stride) -> BN -> relu -> 1x1 (4x filters) -> BN (scale 0),
    plus a 1x1 projection with BN when the shape changes."""

    expansion = 4
    convs = ("conv1", "conv2", "conv3", "proj")    # flax's Conv_0 .. Conv_3
    norms = ("bn1", "bn2", "bn3", "proj_bn")

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.norm_dtype = dtype, norm_dtype
        out = filters * 4
        self.conv1 = Conv(in_channels, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, out, 1)
        self.bn3 = BatchNorm(out, zero_scale=True)
        self.proj = self.proj_bn = None
        if strides != 1 or in_channels != out:
            self.proj = Conv(in_channels, out, 1, strides)
            self.proj_bn = BatchNorm(out)

    def forward(self, x, train: bool = False):
        dt, nd = self.dtype, self.norm_dtype
        y = F.relu(self.bn1(self.conv1(x, dt), train, nd))
        y = F.relu(self.bn2(self.conv2(y, dt), train, nd))
        y = self.bn3(self.conv3(y, dt), train, nd)
        residual = x if self.proj is None else self.proj_bn(self.proj(x, dt), train, nd)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """Configurable ResNet: ``stage_sizes`` blocks per stage, input
    ``[B, 3, H, W]``, float32 logits.  ``cifar_stem``: a 3x3/1 stem and no
    max-pool; otherwise ``stem="conv7"`` (7x7/2) or ``"s2d"`` (2x2
    space-to-depth then 4x4/1, exactly conv7 under
    :func:`conv7_stem_to_s2d_kernel`).  ``forward(x, train=True)`` uses the
    batch statistics and updates the running ones."""

    def __init__(self, stage_sizes, block=Bottleneck, num_classes: int = 1000,
                 num_filters: int = 64, cifar_stem: bool = False, stem: str = "conv7",
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r} (expected 'conv7' or 's2d')")
        self.cifar_stem, self.stem_kind = cifar_stem, stem
        self.dtype, self.norm_dtype = dtype, norm_dtype
        if cifar_stem:
            self.stem = Conv(IN_CHANNELS, num_filters, 3)
        elif stem == "s2d":
            self.stem = Conv(4 * IN_CHANNELS, num_filters, 4, 1, padding=((2, 1), (2, 1)))
        else:
            self.stem = Conv(IN_CHANNELS, num_filters, 7, 2, padding=((3, 3), (3, 3)))
        self.stem_bn = BatchNorm(num_filters)
        blocks, channels = [], num_filters
        for stage, n in enumerate(stage_sizes):
            for i in range(n):
                filters = num_filters * 2 ** stage
                blocks.append(block(channels, filters, 2 if stage > 0 and i == 0 else 1,
                                    dtype=dtype, norm_dtype=norm_dtype))
                channels = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(channels, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.cifar_stem and self.stem_kind == "s2d":
            x = space_to_depth(x, 2)
        x = F.relu(self.stem_bn(self.stem(x, self.dtype), train, self.norm_dtype))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x, train)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.fc.weight, self.fc.bias)


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block=Bottleneck)
# The reference CIFAR-10 example's scale: ResNet-18-ish with a CIFAR stem.
CifarResNet = partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock,
                      num_classes=10, cifar_stem=True)


# ------------------------------------------------------------- weights

def _lecun_normal(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    """flax's ``lecun_normal``: a normal truncated to +-2, scaled so the
    variance is ``1 / fan_in``."""
    z = rng.standard_normal(shape, dtype=np.float32)
    out = np.abs(z) > 2
    while out.any():
        z[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
        out = np.abs(z) > 2
    return z * np.float32(np.sqrt(1.0 / fan_in) / 0.87962566103423978)


def init_params(model: nn.Module, seed: int, scales: tuple | None = None) -> dict:
    """A state dict for ``model`` drawn from ``seed`` with flax's
    initialisers: convolution and dense kernels ``lecun_normal``, biases 0,
    BatchNorm scale 1 (0 where ``zero_scale``) and bias 0, running mean 0
    and variance 1.  Covers :class:`Conv`, ``nn.Conv2d``, ``nn.Linear`` and
    :class:`BatchNorm` (the ResNet and MNIST models).

    ``scales=(lo, hi)`` draws every BatchNorm scale from U(lo, hi) instead,
    and ``scales=(lo, hi, last_lo, last_hi)`` each block's last one (flax's
    0) from U(last_lo, last_hi), from a stream of their own: the kernels
    stay the same.  At flax's init a block's last scale of 0 makes its
    branch's output 0 and every gradient inside the branch 0, so a
    comparison there sees only the stem, the projection shortcuts and the
    classifier."""
    rng = np.random.default_rng(seed)
    scale_rng = np.random.default_rng([seed, 1])
    sd = {}
    for name, mod in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(mod, (Conv, nn.Conv2d, nn.Linear)):
            w = mod.weight
            sd[p + "weight"] = torch.from_numpy(
                _lecun_normal(rng, tuple(w.shape), w[0].numel()))
            if getattr(mod, "bias", None) is not None:
                sd[p + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            if scales is None:
                sd[p + "weight"] = torch.zeros(c) if mod.zero_scale else torch.ones(c)
            else:
                lo, hi = scales[2:] if mod.zero_scale and len(scales) == 4 else scales[:2]
                sd[p + "weight"] = torch.from_numpy(
                    scale_rng.uniform(lo, hi, c).astype(np.float32))
            sd[p + "bias"] = torch.zeros(c)
            sd[p + "running_mean"] = torch.zeros(c)
            sd[p + "running_var"] = torch.ones(c)
    return sd


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_flax(params: dict, batch_stats: dict) -> dict:
    """A flax ResNet's ``params`` and ``batch_stats`` as this module's
    state dict: HWIO kernels become OIHW, the Dense ``(in, out)`` kernel
    ``(out, in)``, ``scale`` the BatchNorm ``weight``, and ``mean``/``var``
    its running buffers.  Blocks keep flax's order (``Bottleneck_i`` is
    ``blocks.i``); inside a block flax's ``Conv_k`` and ``BatchNorm_k`` are
    the block's k-th of ``convs`` and ``norms``."""
    blocks = {"Bottleneck": Bottleneck, "BasicBlock": BasicBlock}
    sd = {}

    def put(prefix: str, kind: str, leaf: dict, stats: dict) -> None:
        if kind == "Conv":
            sd[prefix + ".weight"] = _t(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
        elif kind == "Dense":
            sd[prefix + ".weight"] = _t(leaf["kernel"]).t().contiguous()
            sd[prefix + ".bias"] = _t(leaf["bias"])
        else:
            sd[prefix + ".weight"] = _t(leaf["scale"])
            sd[prefix + ".bias"] = _t(leaf["bias"])
            sd[prefix + ".running_mean"] = _t(stats["mean"])
            sd[prefix + ".running_var"] = _t(stats["var"])

    for name, sub in params.items():
        kind, idx = name.rsplit("_", 1)
        stats = batch_stats.get(name, {})
        if kind in blocks:
            for inner, leaf in sub.items():
                ik, k = inner.rsplit("_", 1)
                names = blocks[kind].convs if ik == "Conv" else blocks[kind].norms
                put(f"blocks.{idx}.{names[int(k)]}", ik, leaf, stats.get(inner, {}))
        else:
            put({"Conv": "stem", "BatchNorm": "stem_bn", "Dense": "fc"}[kind], kind, sub, stats)
    return sd
