"""Shared building blocks of the NF towers.

Counterpart of ``multimodal_dataset_distillation_tpu/models/layers.py``.
Modules take NCHW tensors, which the towers keep channels-last in memory
so that a permute to NHWC is free; parameters use timm's names, shapes
and registration order.  Train-mode randomness (DropPath, Dropout) draws
from an explicit ``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gconv import gconv3x3

# Expected gain of x -> act(x) under x ~ N(0, 1) (Brock et al. 2021).
NONLIN_GAMMA = {
    "identity": 1.0,
    "celu": 1.270926833152771,
    "elu": 1.2716004848480225,
    "gelu": 1.7015043497085571,
    "leaky_relu": 1.70590341091156,
    "log_sigmoid": 1.9193484783172607,
    "log_softmax": 1.0002083778381348,
    "relu": 1.7139588594436646,
    "relu6": 1.7131484746932983,
    "selu": 1.0008515119552612,
    "sigmoid": 4.803835391998291,
    "silu": 1.7881293296813965,
    "softsign": 2.338853120803833,
    "softplus": 1.9203323125839233,
    "tanh": 1.5939117670059204,
}

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "silu": F.silu,
    "gelu": F.gelu,  # exact erf form
    "sigmoid": torch.sigmoid,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def gamma_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Variance-preserving activation: gamma * act(x)."""
    act = ACTIVATIONS[name]
    gamma = NONLIN_GAMMA[name if name != "leakyrelu" else "leaky_relu"]
    return lambda x: act(x) * gamma


def tf_same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF/flax "SAME" padding of an NCHW tensor: the extra pixel goes at
    the end, so a 3x3 stride-2 conv on an even size pads (0, 1)."""
    ih, iw = x.shape[-2:]
    pad_h = max((-(-ih // s) - 1) * s + k - ih, 0)
    pad_w = max((-(-iw // s) - 1) * s + k - iw, 0)
    if not (pad_h or pad_w):
        return x
    return F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class WSConv(nn.Module):
    """Scaled weight-standardized conv (timm ``ScaledStdConv2d``), TF-SAME.

    weight' = gain * (w - mean(w)) / sqrt((var(w) + eps) * fan_in) per
    output channel, timm's eps placement.  With ``gconv`` set, a grouped
    3x3 stride-1 conv runs through the hand-written kernel
    (:func:`~..ops.gconv.gconv3x3`), as the JAX WSConv routes it to the
    Pallas primitive under ``pallas_gconv``; every other conv is
    ``F.conv2d``.
    """

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, eps: float = 1e-6,
                 gconv: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_chs, in_chs // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_chs))
        self.gain = nn.Parameter(torch.ones(out_chs, 1, 1, 1))
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.eps = eps
        self.use_gconv = (gconv and groups > 1 and kernel_size == 3
                          and stride == 1)

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(1, keepdim=True)
        var = flat.var(1, unbiased=False, keepdim=True)
        scale = torch.rsqrt((var + self.eps) * flat.shape[1])
        return ((flat - mean) * scale).view_as(w) * self.gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.standardized_weight()
        if self.use_gconv:
            y = gconv3x3(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                         self.groups).permute(0, 3, 1, 2)
        else:
            y = F.conv2d(tf_same_pad(x, self.kernel_size, self.stride), w,
                         stride=self.stride, groups=self.groups)
        return y + self.bias.view(1, -1, 1, 1)


class SqueezeExcite(nn.Module):
    """SE attention (timm SEModule: 1x1-conv fc1/fc2 parameters)."""

    def __init__(self, features: int, rd_ratio: float = 0.25,
                 rd_divisor: int = 8):
        super().__init__()
        rd = max(int(features * rd_ratio), rd_divisor)
        rd = int((rd + rd_divisor / 2) // rd_divisor * rd_divisor)
        self.fc1 = nn.Conv2d(features, rd, 1)
        self.fc2 = nn.Conv2d(rd, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = F.relu(F.linear(s, self.fc1.weight.flatten(1), self.fc1.bias))
        s = torch.sigmoid(F.linear(s, self.fc2.weight.flatten(1),
                                   self.fc2.bias))
        return x * s[:, :, None, None]


class DropPath(nn.Module):
    """Per-sample stochastic depth."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode DropPath needs a torch.Generator")
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                       generator=generator, device=x.device)
        return x * (u < keep).to(x.dtype) / keep
