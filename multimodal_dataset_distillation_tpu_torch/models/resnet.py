"""ResNet family: basic and bottleneck blocks, BatchNorm or GroupNorm, the
"AP" variants, CIFAR or ImageNet stems.

Counterpart of ``multimodal_dataset_distillation_tpu/models/resnet.py``
(reference ``networks.py:295-517`` and the timm/torchvision ``resnet50`` /
``resnet18_gn`` towers, ``networks.py:674``).  Modules take NCHW tensors.

Names and registration order are torchvision's (``conv1``, ``bn1``,
``layer{L}.{i}.{conv1, bn1, conv2, bn2[, conv3, bn3], downsample.{0,1}}``,
``fc``), so ``parameters()`` is the reference snapshot order and a
torchvision/timm state dict loads strictly.

As in the JAX package: padding is explicit and symmetric (1 at the 3x3
convs, also at stride 2, and at the ImageNet stem's max pool); BatchNorm
is flax's (:class:`~.layers.BatchNorm`: momentum 0.99, biased running
variance, eps 1e-5); GroupNorm takes flax's default eps, 1e-6.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .convnet import conv
from .layers import BatchNorm, GroupNorm, dense


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "batchnorm":
        return BatchNorm(channels)
    if kind == "groupnorm":
        return GroupNorm(min(32, channels), channels, eps=1e-6)
    if kind == "instancenorm":
        return GroupNorm(channels, channels, eps=1e-6)
    raise ValueError(kind)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_chs: int, planes: int, stride: int = 1,
                 norm: str = "batchnorm", avg_pool_down: bool = False):
        super().__init__()
        self.stride, self.avg_pool_down = stride, avg_pool_down
        self.conv1 = _conv(in_chs, planes, 3, 1 if avg_pool_down else stride)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_chs != planes:
            self.downsample = nn.Sequential(
                _conv(in_chs, planes, 1, 1 if avg_pool_down else stride),
                make_norm(norm, planes))
        self.jax_names = {"downsample.0": "shortcut_conv",
                          "downsample.1": "shortcut_bn"}

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1), train))
        if self.avg_pool_down and self.stride != 1:
            out = F.avg_pool2d(out, 2, self.stride)
        out = self.bn2(conv(out, self.conv2), train)
        short = x
        if self.downsample is not None:
            short = self.downsample[1](conv(x, self.downsample[0]), train)
            if self.avg_pool_down and self.stride != 1:
                short = F.avg_pool2d(short, 2, self.stride)
        return F.relu(out + short)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_chs: int, planes: int, stride: int = 1,
                 norm: str = "batchnorm", avg_pool_down: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(in_chs, planes, 1)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = make_norm(norm, planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = make_norm(norm, out_ch)
        self.downsample = None
        if stride != 1 or in_chs != out_ch:
            self.downsample = nn.Sequential(_conv(in_chs, out_ch, 1, stride),
                                            make_norm(norm, out_ch))
        self.jax_names = {"downsample.0": "shortcut_conv",
                          "downsample.1": "shortcut_bn"}

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1), train))
        out = F.relu(self.bn2(conv(out, self.conv2), train))
        out = self.bn3(conv(out, self.conv3), train)
        short = x
        if self.downsample is not None:
            short = self.downsample[1](conv(x, self.downsample[0]), train)
        return F.relu(out + short)


class ResNet(nn.Module):
    """CIFAR-style (3x3 stem) or ImageNet-style (7x7/2 stem + 3x3/2 max
    pool); global average pool, then ``fc`` unless ``num_classes`` is 0."""

    def __init__(self, block: str, layers: Tuple[int, int, int, int],
                 num_classes: int = 10, norm: str = "batchnorm",
                 imagenet_stem: bool = False, avg_pool_down: bool = False,
                 in_chs: int = 3):
        super().__init__()
        cls = BasicBlock if block == "basic" else Bottleneck
        self.imagenet_stem = imagenet_stem
        self.conv1 = (_conv(in_chs, 64, 7, 2) if imagenet_stem
                      else _conv(in_chs, 64, 3))
        self.bn1 = make_norm(norm, 64)
        self.jax_names = {}
        c = 64
        for si, (n, p) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                blocks.append(cls(c, p, stride, norm, avg_pool_down))
                c = p * cls.expansion
                self.jax_names[f"layer{si + 1}.{bi}"] = (
                    f"layer{si + 1}_block{bi}")
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(c, num_classes) if num_classes else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.bn1(conv(x, self.conv1), train))
        if self.imagenet_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, train)
        x = x.mean(dim=(2, 3))
        return x if self.fc is None else dense(x, self.fc)


def resnet18(num_classes: int = 10, norm: str = "batchnorm",
             imagenet_stem: bool = False) -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), num_classes, norm, imagenet_stem)


def resnet18_gn(num_classes: int = 10, imagenet_stem: bool = True) -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), num_classes, "groupnorm",
                  imagenet_stem)


def resnet18_ap(num_classes: int = 10, norm: str = "batchnorm") -> ResNet:
    return ResNet("basic", (2, 2, 2, 2), num_classes, norm,
                  imagenet_stem=False, avg_pool_down=True)


def resnet50(num_classes: int = 1000, norm: str = "batchnorm") -> ResNet:
    return ResNet("bottleneck", (3, 4, 6, 3), num_classes, norm,
                  imagenet_stem=True)
