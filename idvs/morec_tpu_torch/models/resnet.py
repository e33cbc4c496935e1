"""ResNet-18/34/50/101/152 (JAX twin: models/resnet.py), the reference's CV
towers (inbatch_sasrec_e2e_vision/run.py:27-46) with the classifier fc
replaced by a Dense to ``out_dim`` inside the net.

Images arrive NHWC and stay in that memory layout: the net runs on the
NCHW view of it (``channels_last``) through ``F.conv2d``, which XLA's
convolutions stand for in the JAX package (no Pallas kernel). Module and
parameter names follow the Flax tree (``conv1``, ``bn1``,
``layer{s}_{b}.conv{i}`` / ``bn{i}`` / ``downsample_conv`` /
``downsample_bn``, ``fc``); a convolution keeps the Flax HWIO kernel as its
``weight`` (as ``models/swin.py`` ``PatchProject`` does), so
``convert.from_flax`` carries the weights across by its one rule.

BatchNorm follows Flax's ``nn.BatchNorm`` (JAX resnet.py ``_bn``), written
as a function rather than ``nn.BatchNorm2d``, whose running variance is
the unbiased one and whose bf16 path chooses its own accumulation:

- in training mode the batch's statistics over (N, H, W) in float32, the
  variance E[x^2] - E[x]^2 clamped at 0 (biased), and the running
  averages updated once a call, ``0.9 * running + 0.1 * batch``, that
  biased variance into ``var``; in eval mode the running averages;
- y = (x - mean) * (rsqrt(var + 1e-5) * scale) + bias in float32, cast to
  x's dtype (the compute dtype: JAX builds the norm with dtype bf16 under
  bf16 compute);
- the running averages are the buffers ``mean`` and ``var``, Flax's
  ``batch_stats`` collection, outside the optimizer;
- SyncBN: under a process group (``parallel/mesh.py``) the per-channel
  (E[x], E[x^2]) are averaged over the ranks by one all-reduce that
  gradients flow through (``mesh.all_mean``), as the JAX norm's
  ``axis_name='data'`` pmean inside ``value_and_grad``: the reference's
  SyncBatchNorm (run.py:128). ``nn.SyncBatchNorm`` refuses CPU tensors and
  keeps the unbiased variance.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from .layers import Dense, lecun_normal_, on_device

ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}
MOMENTUM, EPS = 0.9, 1e-5


class Conv(nn.Module):
    """A bias-less convolution whose ``weight`` is the Flax (kh, kw, in,
    out) kernel; the input is an NCHW tensor (an NHWC one's view)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, device=None):
        super().__init__()
        device = on_device(device)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(kernel, kernel, in_channels,
                                               features, device=device))

    def reset_parameters(self, generator) -> None:
        # flax lecun_normal on (kh, kw, in, out): fan_in = kh * kw * in
        flat = torch.empty(math.prod(self.weight.shape[:3]),
                           self.weight.shape[3], device=self.weight.device)
        lecun_normal_(flat, generator)
        with torch.no_grad():
            self.weight.copy_(flat.reshape(self.weight.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).permute(3, 2, 0, 1)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32 at least (float64 stays float64), as Flax promotes."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def batch_stats(x: torch.Tensor, pg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of an NCHW x in float32 (at least): Flax's
    ``_compute_stats`` with the fast variance, averaged over the process
    group ``pg`` unless it is None."""
    xf = _wide(x)
    stats = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
    if pg is not None:
        stats = mesh.all_mean(stats, pg)
    mu, mu2 = stats[0], stats[1]
    return mu, (mu2 - mu * mu).clamp_min(0.0)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of an NCHW x (see the module docstring). ``weight`` is Flax's
    ``scale``; ``mean`` and ``var`` are its ``batch_stats``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        device = on_device(device)
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x, mesh.group())
            with torch.no_grad():
                self.mean.copy_(MOMENTUM * self.mean
                                + (1 - MOMENTUM) * mean.detach())
                self.var.copy_(MOMENTUM * self.var
                               + (1 - MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        view = lambda t: t.reshape(1, -1, 1, 1)
        mul = torch.rsqrt(var + EPS) * _wide(self.weight)
        y = (_wide(x) - view(mean)) * view(mul) + view(_wide(self.bias))
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = Conv(in_channels, filters, 3, stride, 1, device=device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, 1, 1, device=device)
        self.bn2 = BatchNorm(filters, device=device)
        self.down = in_channels != filters or stride != 1
        if self.down:
            self.downsample_conv = Conv(in_channels, filters, 1, stride,
                                        device=device)
            self.downsample_bn = BatchNorm(filters, device=device)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = (self.downsample_bn(self.downsample_conv(x)) if self.down
               else x)
        return F.relu(res + y)


class Bottleneck(nn.Module):
    """filters: the 3x3's width; the block's output is 4 * filters."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 device=None):
        super().__init__()
        out = 4 * filters
        self.conv1 = Conv(in_channels, filters, 1, device=device)
        self.bn1 = BatchNorm(filters, device=device)
        self.conv2 = Conv(filters, filters, 3, stride, 1, device=device)
        self.bn2 = BatchNorm(filters, device=device)
        self.conv3 = Conv(filters, out, 1, device=device)
        self.bn3 = BatchNorm(out, device=device)
        self.down = in_channels != out or stride != 1
        if self.down:
            self.downsample_conv = Conv(in_channels, out, 1, stride,
                                        device=device)
            self.downsample_bn = BatchNorm(out, device=device)
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = (self.downsample_bn(self.downsample_conv(x)) if self.down
               else x)
        return F.relu(res + y)


class ResNet(nn.Module):
    """Normalised NHWC images -> (N, out_dim) through the replaced fc.
    BatchNorm's statistics are the process group's when one is up (the
    JAX runner passes ``axis_name='data'`` on more than one device)."""

    def __init__(self, arch: str = "resnet50", out_dim: int = 512,
                 device=None):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown ResNet arch {arch!r}")
        device = on_device(device)
        self.arch = arch
        kind, counts = ARCHS[arch]
        Block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv(3, 64, 7, 2, 3, device=device)
        self.bn1 = BatchNorm(64, device=device)
        self.layout: List[str] = []
        channels, filters = 64, 64
        for stage, n in enumerate(counts):
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                block = Block(channels, filters, stride, device=device)
                self.add_module(name, block)
                self.layout.append(name)
                channels = block.out_channels
            filters *= 2
        self.fc = Dense(channels, out_dim, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)       # NCHW view of the NHWC images
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        for name in self.layout:
            y = getattr(self, name)(y)
        # the adaptive average pool to 1x1: a float32 mean, as XLA's
        y = _wide(y).mean((2, 3)).to(y.dtype)
        return self.fc(y)


def resnet_param_order(arch: str) -> List[Tuple[str, tuple]]:
    """[(torchvision name, Flax path)] in torchvision's
    ``named_parameters()`` order (JAX resnet.py
    ``resnet_torch_param_order``): the BN running averages are buffers and
    not in it, as in the reference's index-based freezing (run.py:58-60)."""
    order = [("conv1.weight", ("conv1", "kernel")),
             ("bn1.weight", ("bn1", "scale")),
             ("bn1.bias", ("bn1", "bias"))]
    kind, counts = ARCHS[arch]
    n_convs, expansion = (2, 1) if kind == "basic" else (3, 4)
    filters, in_f = 64, 64
    for stage, n_blocks in enumerate(counts):
        for b in range(n_blocks):
            t, f = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for ci in range(1, n_convs + 1):
                order += [(f"{t}.conv{ci}.weight", (f, f"conv{ci}", "kernel")),
                          (f"{t}.bn{ci}.weight", (f, f"bn{ci}", "scale")),
                          (f"{t}.bn{ci}.bias", (f, f"bn{ci}", "bias"))]
            stride = 2 if (stage > 0 and b == 0) else 1
            if b == 0 and (stride != 1 or in_f != filters * expansion):
                order += [(f"{t}.downsample.0.weight",
                           (f, "downsample_conv", "kernel")),
                          (f"{t}.downsample.1.weight",
                           (f, "downsample_bn", "scale")),
                          (f"{t}.downsample.1.bias",
                           (f, "downsample_bn", "bias"))]
            in_f = filters * expansion
        filters *= 2
    return order + [("fc.weight", ("fc", "kernel")),
                    ("fc.bias", ("fc", "bias"))]


def resnet_frozen_paths(arch: str, freeze_before: int,
                        prefix: tuple = ()) -> set:
    """Flax paths of the parameters the reference freezes: index <
    freeze_before in torchvision's order, the replaced fc excepted (it
    stays in the recsys group, run.py:125-129)."""
    return {prefix + fpath for idx, (tname, fpath)
            in enumerate(resnet_param_order(arch))
            if idx < freeze_before and not tname.startswith("fc.")}
