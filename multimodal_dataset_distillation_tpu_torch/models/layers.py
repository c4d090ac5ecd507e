"""Shared building blocks of the image towers.

Counterpart of ``multimodal_dataset_distillation_tpu/models/layers.py``
(and of the flax norms the towers there use).  Modules take NCHW tensors,
which the towers keep channels-last in memory so that a permute to NHWC is
free; parameters use timm's / torchvision's names, shapes and
registration order.  Train-mode randomness (DropPath, Dropout) draws from
an explicit ``torch.Generator`` passed to ``forward``; under data
parallelism a :class:`~..parallel.mesh.RowShard` of it, which draws the
whole batch's mask and keeps the rank's rows.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_jvp
from ..ops import s2d as _s2d
from ..ops.gconv import gconv3x3
from ..parallel import collectives as col
from ..parallel.mesh import SINGLE, rows_of

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


def trunc_normal_fan_in(t: torch.Tensor, fan_in: int, scale: float,
                        gen: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")`` into
    ``t`` from ``gen`` (scale 1: lecun-normal, 2: he-normal)."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def gamma_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Variance-preserving activation: gamma * act(x)."""
    act = ACTIVATIONS[name]
    gamma = NONLIN_GAMMA[name if name != "leakyrelu" else "leaky_relu"]
    return lambda x: act(x) * gamma


def tf_same_pad(x: torch.Tensor, k: int, s: int,
                value: float = 0.0) -> torch.Tensor:
    """TF/flax "SAME" padding of an NCHW tensor: the extra pixel goes at
    the end, so a 3x3 stride-2 conv on an even size pads (0, 1).  ``value``
    fills the pad (-inf for flax's ``max_pool``)."""
    ih, iw = x.shape[-2:]
    pad_h = max((-(-ih // s) - 1) * s + k - ih, 0)
    pad_w = max((-(-iw // s) - 1) * s + k - iw, 0)
    if not (pad_h or pad_w):
        return x
    return F.pad(x, (pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2), value=value)


def promoted(x: torch.Tensor, *ps: Optional[torch.Tensor]):
    """``x`` and the parameters ``ps`` cast to their promoted dtype: flax's
    layers with ``dtype=None`` compute in ``result_type(inputs, params)``,
    so float32 activations meet bfloat16-rounded weights in float32."""
    dt = x.dtype
    for p in ps:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return [x.to(dt)] + [None if p is None else p.to(dt) for p in ps]


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype (flax ``nn.Dense``)."""
    return F.linear(*promoted(x, layer.weight, layer.bias))


def _layer_norm(x: torch.Tensor, shape, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``F.layer_norm(x, shape, w, b, eps)``, unless a forward-mode tangent
    rides on an operand: then flax's formula in plain ops (statistics in
    at least float32, variance ``E[x^2] - E[x]^2`` floored at 0), in
    ``x``'s dtype.  The reverse pass over ``F.layer_norm``'s forward-mode
    rule gives wrong second derivatives without an error (1.6e-1 relative
    in float64), so the grad-of-jvp meta-backward must not reach it."""
    if not any(fused_jvp.has_tangent(t) for t in (x, w, b)):
        return F.layer_norm(x, shape, w, b, eps)
    dims = tuple(range(-len(shape), 0))
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xs.mean(dims, keepdim=True)
    var = ((xs * xs).mean(dims, keepdim=True) - mean * mean).clamp_min(0)
    return ((xs - mean) * (torch.rsqrt(var + eps) * w) + b).to(x.dtype)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype (flax ``nn.LayerNorm``)."""
    x, w, b = promoted(x, layer.weight, layer.bias)
    return _layer_norm(x, layer.normalized_shape, w, b, layer.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.99, eps 1e-5) on NCHW.

    Train mode normalises by the batch's biased statistics, taken in
    float32 as flax takes them (``E[x^2] - E[x]^2``, floored at 0), and
    moves the running averages as flax does: ``ra = 0.99 * ra + 0.01 *
    batch``, the variance biased (torch's ``BatchNorm2d`` would use 0.1 and
    the unbiased variance).  Eval mode normalises by the running averages.
    The output takes the promoted dtype of input and parameters; the
    running averages stay float32.  Names are torchvision's: parameters
    ``weight``/``bias`` (flax ``scale``/``bias``), buffers
    ``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``),
    so they are not part of ``parameters()``, as in the reference.

    ``mesh`` (set by a data-parallel trainer, :func:`sync_batchnorm`): the
    train-mode moments are the global batch's, as GSPMD gives them in the
    JAX package: the sums of x and x^2 are summed over the ranks, in the
    backward too."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.mesh = SINGLE
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train and self.mesh.world > 1:
            sums = col.synced_sum(torch.stack(
                (xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)))),
                self.mesh)
            count = x.shape[0] * x.shape[2] * x.shape[3] * self.mesh.world
            mean = sums[0] / count
            var = (sums[1] / count - mean * mean).clamp_min(0)
        elif train:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0)
        if train:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias.float()[:, None, None]
        return y.to(promoted(x, self.weight, self.bias)[0].dtype)


def sync_batchnorm(model: nn.Module, mesh) -> None:
    """Every :class:`BatchNorm` of ``model`` takes its train-mode moments
    over ``mesh``'s ranks."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` with the towers' norm signature: ``forward(x,
    train)``, ``train`` unread (the norm has no running state).  The input
    goes in contiguous: ``F.group_norm``'s forward-mode rule fails on a
    channels-last tangent (under ``torch.autograd.forward_ad`` and
    ``torch.func.jvp`` alike), and on the card the op makes that copy
    itself."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return super().forward(x.contiguous())


class ChannelLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the channel axis of an NCHW tensor (the
    JAX ConvNet's "layernorm": the last axis of its NHWC activations);
    ``train`` unread, as in :class:`GroupNorm`."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = _layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                        self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    u = rows_of(torch.rand, x.shape, generator, x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class WSConv(nn.Module):
    """Scaled weight-standardized conv (timm ``ScaledStdConv2d``), TF-SAME.

    weight' = gain * (w - mean(w)) / sqrt((var(w) + eps) * fan_in) per
    output channel, timm's eps placement.  The JAX WSConv's routing
    order: the space-to-depth form (below); with ``gconv`` set, a grouped
    3x3 stride-1 conv through the hand-written kernel
    (:func:`~..ops.gconv.gconv3x3`, whose forward-mode rule is its own),
    as the JAX WSConv routes it to the Pallas primitive under
    ``pallas_gconv``; while :func:`..ops.fused_jvp.active`, the
    merged-tangent conv; every other conv ``F.conv2d``.

    ``forward(x, s2d_in, s2d_out)`` with ``s2d_in > 1`` is the
    space-to-depth form (:mod:`..ops.s2d`, the JAX WSConv's ``s2d_in`` /
    ``s2d_out``): ``x`` comes in s2d(``s2d_in``) layout and the output goes
    out in s2d(``s2d_out``) layout; the parameters are the same, the
    standardized weight is rearranged at apply time, explicit block
    padding replaces TF-SAME and the bias is tiled ``s2d_out**2`` times.
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

    def forward(self, x: torch.Tensor, s2d_in: int = 1,
                s2d_out: int = 1) -> torch.Tensor:
        w = self.standardized_weight()
        if s2d_in > 1:
            assert self.groups == 1, "s2d mode is for the ungrouped stem"
            k, s = self.kernel_size, self.stride
            lo, hi = _s2d.block_padding(k, s, s2d_in, s2d_out)
            y = F.conv2d(F.pad(x, (lo, hi, lo, hi)),
                         _s2d.rearrange_kernel(w, s, s2d_in, s2d_out))
            bias = self.bias.repeat_interleave(s2d_out * s2d_out)
            return y + bias.view(1, -1, 1, 1)
        if self.use_gconv:
            y = gconv3x3(x.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                         self.groups).permute(0, 3, 1, 2)
        else:
            conv = fused_jvp.conv if fused_jvp.active() else F.conv2d
            y = conv(tf_same_pad(x, self.kernel_size, self.stride), w,
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
        for fc in (self.fc1, self.fc2):   # a flax Dense in the JAX tree
            fc.jax_dense = True

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
        u = rows_of(torch.rand, (x.shape[0],) + (1,) * (x.dim() - 1),
                    generator, x.device)
        return x * (u < keep).to(x.dtype) / keep
