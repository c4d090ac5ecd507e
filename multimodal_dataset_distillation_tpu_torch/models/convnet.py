"""The DatasetCondensation classification zoo: MLP, ConvNet (width, depth,
activation, norm and pooling variants, GAP head), LeNet, AlexNet, VGG.

Counterpart of ``multimodal_dataset_distillation_tpu/models/convnet.py``
(reference ``networks.py:27-289``).  Modules take NCHW tensors (the image
tower keeps them channels-last).  Where the JAX classifier flattens a
feature map, it flattens NHWC; the port flattens NHWC too, so the Dense
rows of a carried-across JAX classifier line up as they are.

Norm eps is 1e-5 everywhere here (torch's GroupNorm/LayerNorm default,
which the JAX zoo matches); "instancenorm" is GroupNorm with one group per
channel, "layernorm" normalises the channel axis, "batchnorm" is
:class:`~.layers.BatchNorm`.  ``ConvNet`` names and registers its layers
as the reference's (``features.{k}`` = [conv, norm, act, pool] per block,
then ``classifier``), so ``parameters()`` is the reference snapshot order;
the other nets use the JAX module names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    ACTIVATIONS,
    BatchNorm,
    ChannelLayerNorm,
    GroupNorm,
    dense,
    promoted,
)


def make_norm(kind: str, channels: int) -> Optional[nn.Module]:
    if kind == "instancenorm":
        return GroupNorm(channels, channels, eps=1e-5)
    if kind == "groupnorm":
        return GroupNorm(min(32, channels), channels, eps=1e-5)
    if kind == "layernorm":
        return ChannelLayerNorm(channels, eps=1e-5)
    if kind == "batchnorm":
        return BatchNorm(channels)
    if kind == "none":
        return None
    raise ValueError(f"unknown norm: {kind}")


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype (flax ``nn.Conv``)."""
    x, w, b = promoted(x, layer.weight, layer.bias)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The JAX classifiers' ``x.reshape(n, -1)`` of an NHWC map."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Act(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.name](x)


class _Pool(nn.Module):
    def __init__(self, kind: str):
        super().__init__()
        if kind not in ("avgpooling", "maxpooling"):
            raise ValueError(f"unknown pooling: {kind}")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = F.avg_pool2d if self.kind == "avgpooling" else F.max_pool2d
        return pool(x, 2, 2)


class MLP(nn.Module):
    """networks.py:27-41: two hidden layers of 128, ReLU."""

    def __init__(self, num_classes: int, in_features: int = 32 * 32 * 3):
        super().__init__()
        self.fc_1 = nn.Linear(in_features, 128)
        self.fc_2 = nn.Linear(128, 128)
        self.fc_3 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(dense(flatten_nhwc(x), self.fc_1))
        x = F.relu(dense(x, self.fc_2))
        return dense(x, self.fc_3)


class ConvNet(nn.Module):
    """networks.py:44-114 (and ConvNetGAP, :117-188): ``net_depth`` blocks
    of [3x3 conv, norm, activation, 2x2 pool], then a Dense classifier on
    the flattened map (or on its global average with ``gap``).
    ``im_size`` sizes the flattened classifier input."""

    def __init__(self, num_classes: int, net_width: int = 128,
                 net_depth: int = 3, net_act: str = "relu",
                 net_norm: str = "instancenorm",
                 net_pooling: str = "avgpooling", gap: bool = False,
                 in_chs: int = 3, im_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        layers = []
        #: port child name -> flax module name (models/convert.py)
        self.jax_names: Dict[str, str] = {}
        h, w = im_size
        for d in range(net_depth):
            self.jax_names[f"features.{len(layers)}"] = f"conv{d}"
            layers.append(nn.Conv2d(in_chs if d == 0 else net_width,
                                    net_width, 3, padding=1))
            norm = make_norm(net_norm, net_width)
            if norm is not None:
                self.jax_names[f"features.{len(layers)}"] = f"norm{d}"
                layers.append(norm)
            layers.append(_Act(net_act))
            if net_pooling != "none":
                layers.append(_Pool(net_pooling))
                h, w = h // 2, w // 2
        self.features = nn.Sequential(*layers)
        self.gap = gap
        self.classifier = nn.Linear(net_width if gap else net_width * h * w,
                                    num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = conv(x, layer)
            elif isinstance(layer, (_Act, _Pool)):
                x = layer(x)
            else:
                x = layer(x, train)
        x = x.mean(dim=(2, 3)) if self.gap else flatten_nhwc(x)
        return dense(x, self.classifier)


class LeNet(nn.Module):
    """networks.py:191-214."""

    def __init__(self, num_classes: int, in_chs: int = 3,
                 im_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chs, 6, 5, padding=2)
        self.conv2 = nn.Conv2d(6, 16, 5)
        h, w = ((s // 2 - 4) // 2 for s in im_size)
        self.fc_1 = nn.Linear(16 * h * w, 120)
        self.fc_2 = nn.Linear(120, 84)
        self.fc_3 = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.max_pool2d(F.relu(conv(x, self.conv1)), 2, 2)
        x = F.max_pool2d(F.relu(conv(x, self.conv2)), 2, 2)
        x = F.relu(dense(flatten_nhwc(x), self.fc_1))
        x = F.relu(dense(x, self.fc_2))
        return dense(x, self.fc_3)


class AlexNet(nn.Module):
    """networks.py:217-249 (the CIFAR-sized AlexNet)."""

    def __init__(self, num_classes: int, in_chs: int = 3,
                 im_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chs, 128, 5, padding=4)
        self.conv2 = nn.Conv2d(128, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 256, 3, padding=1)
        self.conv4 = nn.Conv2d(256, 192, 3, padding=1)
        self.conv5 = nn.Conv2d(192, 192, 3, padding=1)
        h, w = ((s + 4) // 2 // 2 // 2 for s in im_size)
        self.fc = nn.Linear(192 * h * w, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.max_pool2d(F.relu(conv(x, self.conv1)), 2, 2)
        x = F.max_pool2d(F.relu(conv(x, self.conv2)), 2, 2)
        x = F.relu(conv(x, self.conv3))
        x = F.relu(conv(x, self.conv4))
        x = F.max_pool2d(F.relu(conv(x, self.conv5)), 2, 2)
        return dense(flatten_nhwc(x), self.fc)


VGG_CFG = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    """networks.py:252-289: ``conv{i}`` 3x3 + ``norm{i}`` + ReLU per width
    of the configuration, 2x2 max pools at its "M"s, then ``classifier``;
    ``norm`` "instancenorm" (the zoo default) or "batchnorm" (VGG*BN)."""

    def __init__(self, vgg_name: str, num_classes: int,
                 norm: str = "instancenorm", in_chs: int = 3,
                 im_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.plan = VGG_CFG[vgg_name]
        h, w = im_size
        i, c = 0, in_chs
        for v in self.plan:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            setattr(self, f"conv{i}", nn.Conv2d(c, v, 3, padding=1))
            setattr(self, f"norm{i}", make_norm(norm, v))
            i, c = i + 1, v
        self.classifier = nn.Linear(c * h * w, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        i = 0
        for v in self.plan:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = conv(x, getattr(self, f"conv{i}"))
            x = F.relu(getattr(self, f"norm{i}")(x, train))
            i += 1
        return dense(flatten_nhwc(x), self.classifier)
