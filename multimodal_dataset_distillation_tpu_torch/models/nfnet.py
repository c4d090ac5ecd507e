"""Normalizer-Free networks (NFNet-L0, NF-ResNet50, NF-RegNet-B1 and a
CI-sized NFNet) in PyTorch.

Counterpart of ``multimodal_dataset_distillation_tpu/models/nfnet.py``:
scaled weight-standardized convs, variance-preserving activations,
residual branches scaled by beta = 1/expected_std on entry and alpha on
exit, SE with gain 2 (after conv3, timm ``attn_last``, on NFNet-style
blocks; mid-block on the expanded width, timm ``attn``, on reg-style
ones), optional zero-init skipinit gain, final 1x1 conv, global average
pool, optional dropout + classifier.  Stems: ``deep_quad`` (NFNet),
``7x7_pool`` (7x7/2 conv, activation, TF-SAME 3x3/2 max pool) and ``3x3``
(one 3x3/2 conv; stage 0 then strides too).  Reg-style blocks (NF-RegNet)
take their mid width from the block's input.

Module names, shapes and registration order are timm's ``NormFreeNet``
(``stem.conv1..4`` or ``stem.conv``, ``stages.{s}.{b}.{skipinit_gain,
downsample.conv, conv1, conv2, conv2b, attn.fc1/fc2, conv3,
attn_last.fc1/fc2}``, ``final_conv``, ``head.fc``), so ``parameters()``
order is the reference's snapshot order.

``stem_s2d`` runs the stems in space-to-depth form (:mod:`..ops.s2d`, the
JAX stems' ``s2d.enabled()`` branches): ``deep_quad`` takes s2d(4) images
through conv1 4->2, conv2 and conv3 2->2 and conv4 2->1; ``7x7_pool`` and
``3x3`` take s2d(2) images through their conv 2->1.  Same parameters and
outputs; the activations are elementwise, so they commute with the
layout.  An input whose height or width the block size does not divide
takes the plain stem, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.s2d import space_to_depth
from .layers import (
    DropPath,
    SqueezeExcite,
    WSConv,
    dense,
    dropout,
    gamma_act,
    tf_same_pad,
)


def make_divisible(v: float, divisor: int = 8,
                   round_limit: float = 0.9) -> int:
    """timm's channel rounding: nearest multiple of ``divisor``, bumped up
    when that falls below ``round_limit * v``."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class NfConfig:
    depths: Tuple[int, ...]
    channels: Tuple[int, ...]
    alpha: float = 0.2
    stem_type: str = "deep_quad"
    stem_chs: int = 128
    group_size: Optional[int] = None      # channels per group in 3x3 convs
    bottle_ratio: float = 0.25
    extra_conv: bool = False              # second grouped 3x3 (NFNet blocks)
    num_features: int = 0                 # final 1x1 conv width (0 = none)
    act: str = "silu"
    attn_rd_ratio: float = 0.0            # 0 disables SE
    attn_gain: float = 2.0
    skipinit: bool = True
    drop_path_rate: float = 0.0
    num_classes: int = 0
    drop_rate: float = 0.0
    reg: bool = False
    width_factor: float = 1.0
    ch_div: int = 8


# timm `nfnet_l0`: 2304 pooled features (image_embedding=2304).
NFNET_L0 = NfConfig(
    depths=(1, 2, 6, 3), channels=(256, 512, 1536, 1536),
    stem_type="deep_quad", stem_chs=128, group_size=64, bottle_ratio=0.25,
    extra_conv=True, num_features=2304, act="silu", attn_rd_ratio=0.25,
    skipinit=True, drop_path_rate=0.1,
)

# timm `nf_resnet50`: 7x7 + pool stem, plain 3x3s, ReLU, no SE, no
# skipinit, the 1000-class head kept (networks.py:670).
NF_RESNET50 = NfConfig(
    depths=(3, 4, 6, 3), channels=(256, 512, 1024, 2048),
    stem_type="7x7_pool", stem_chs=64, group_size=None, bottle_ratio=0.25,
    extra_conv=False, num_features=0, act="relu", attn_rd_ratio=0.0,
    skipinit=False, num_classes=1000,
)

# timm `nf_regnet_b1`: widths x0.75, 3x3/2 stem, inverted bottlenecks x2.25
# of the block input with 8-channel groups, SE (0.5) mid-block, final 1x1
# conv to 960, the 1000-class head kept (networks.py:672).
NF_REGNET_B1 = NfConfig(
    depths=(2, 4, 7, 7), channels=(48, 104, 208, 440),
    stem_type="3x3", stem_chs=40, group_size=8, bottle_ratio=2.25,
    extra_conv=False, num_features=960, act="silu", attn_rd_ratio=0.5,
    skipinit=False, num_classes=1000, reg=True, width_factor=0.75,
)

# CI-sized NFNet: nfnet_l0's block anatomy at toy width and depth.
NF_TINY = NfConfig(
    depths=(1, 2), channels=(32, 64),
    stem_type="deep_quad", stem_chs=16, group_size=8, bottle_ratio=0.5,
    extra_conv=True, num_features=128, act="silu", attn_rd_ratio=0.25,
    skipinit=True, drop_path_rate=0.0,
)


class DeepQuadStem(nn.Module):
    """3x3/s2 -> 3x3 -> 3x3 -> 3x3/s2, widths c/8, c/4, c/2, c."""

    def __init__(self, in_chs: int, c: int, act: str, s2d: bool = False):
        super().__init__()
        self.conv1 = WSConv(in_chs, c // 8, 3, stride=2)
        self.conv2 = WSConv(c // 8, c // 4, 3)
        self.conv3 = WSConv(c // 4, c // 2, 3)
        self.conv4 = WSConv(c // 2, c, 3, stride=2)
        self.act = gamma_act(act)
        self.s2d = s2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s2d and x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0:
            x = self.act(self.conv1(space_to_depth(x, 4), 4, 2))
            x = self.act(self.conv2(x, 2, 2))
            x = self.act(self.conv3(x, 2, 2))
            return self.conv4(x, 2, 1)
        x = self.act(self.conv1(x))
        x = self.act(self.conv2(x))
        x = self.act(self.conv3(x))
        return self.conv4(x)


class SimpleStem(nn.Module):
    """``7x7_pool``: 7x7/2 conv, activation, TF-SAME 3x3/2 max pool (the
    pad is -inf, as flax's); ``3x3``: one 3x3/2 conv."""

    def __init__(self, in_chs: int, c: int, stem_type: str, act: str,
                 s2d: bool = False):
        super().__init__()
        self.pool = stem_type == "7x7_pool"
        self.conv = WSConv(in_chs, c, 7 if self.pool else 3, stride=2)
        self.act = gamma_act(act)
        self.s2d = s2d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            x = self.conv(space_to_depth(x, 2), 2, 1)
        else:
            x = self.conv(x)
        if not self.pool:
            return x
        x = tf_same_pad(self.act(x), 3, 2, value=float("-inf"))
        return F.max_pool2d(x, 3, 2)


class DownsampleAvg(nn.Module):
    """Transition shortcut: 2x2 average pool (TF-SAME, pads counted) when
    strided, then a 1x1 WSConv."""

    def __init__(self, in_chs: int, out_chs: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv = WSConv(in_chs, out_chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = F.avg_pool2d(tf_same_pad(x, 2, self.stride), 2, self.stride)
        return self.conv(x)


class NfBlock(nn.Module):
    def __init__(self, cfg: NfConfig, in_chs: int, out_chs: int, stride: int,
                 beta: float, transition: bool, drop_path: float,
                 gconv: bool):
        super().__init__()
        mid = make_divisible((in_chs if cfg.reg else out_chs)
                             * cfg.bottle_ratio, cfg.ch_div)
        groups = 1
        if cfg.group_size:
            groups = max(1, mid // cfg.group_size)
            if cfg.group_size % cfg.ch_div == 0:
                mid = groups * cfg.group_size
        self.beta, self.alpha = beta, cfg.alpha
        self.attn_gain = cfg.attn_gain
        self.act = gamma_act(cfg.act)
        # the block's one direct parameter: first in parameters() order
        self.skipinit_gain = (nn.Parameter(torch.zeros(()))
                              if cfg.skipinit else None)
        self.downsample = (DownsampleAvg(in_chs, out_chs, stride)
                           if transition else None)
        self.conv1 = WSConv(in_chs, mid, 1)
        self.conv2 = WSConv(mid, mid, 3, stride=stride, groups=groups,
                            gconv=gconv)
        self.conv2b = (WSConv(mid, mid, 3, groups=groups, gconv=gconv)
                       if cfg.extra_conv else None)
        se = cfg.attn_rd_ratio > 0
        self.attn = (SqueezeExcite(mid, rd_ratio=cfg.attn_rd_ratio)
                     if se and cfg.reg else None)
        self.conv3 = WSConv(mid, out_chs, 1)
        self.attn_last = (SqueezeExcite(out_chs, rd_ratio=cfg.attn_rd_ratio)
                          if se and not cfg.reg else None)
        self.jax_names = {"downsample.conv": "downsample_conv",
                          "attn": "se_mid", "attn_last": "se"}
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.act(x) * self.beta
        shortcut = self.downsample(out) if self.downsample is not None else x
        out = self.conv1(out)
        out = self.conv2(self.act(out))
        if self.conv2b is not None:
            out = self.conv2b(self.act(out))
        if self.attn is not None:
            out = self.attn_gain * self.attn(out)
        out = self.conv3(self.act(out))
        if self.attn_last is not None:
            out = self.attn_gain * self.attn_last(out)
        out = self.drop_path(out, train, generator)
        if self.skipinit_gain is not None:
            out = out * self.skipinit_gain
        return out * self.alpha + shortcut


class ClassifierHead(nn.Module):
    """timm's ``head``: dropout, then ``fc``."""

    def __init__(self, in_features: int, num_classes: int, drop_rate: float):
        super().__init__()
        self.drop_rate = drop_rate
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            x = dropout(x, self.drop_rate, generator)
        return dense(x, self.fc)


class NormFreeNet(nn.Module):
    """Normalizer-free network over :class:`NfConfig`; NCHW in, pooled
    (N, features) out, or (N, num_classes) with a head; ``gconv`` routes
    the grouped 3x3s to the kernels, ``stem_s2d`` runs the stem in
    space-to-depth form."""

    def __init__(self, cfg: NfConfig, in_chs: int = 3, gconv: bool = False,
                 stem_s2d: bool = False):
        super().__init__()
        self.cfg = cfg
        self.act = gamma_act(cfg.act)
        stem_chs = make_divisible(cfg.stem_chs * cfg.width_factor, cfg.ch_div)
        if cfg.stem_type == "deep_quad":
            self.stem = DeepQuadStem(in_chs, stem_chs, cfg.act, stem_s2d)
        elif cfg.stem_type in ("7x7_pool", "3x3"):
            self.stem = SimpleStem(in_chs, stem_chs, cfg.stem_type, cfg.act,
                                   stem_s2d)
        else:
            raise ValueError(cfg.stem_type)
        # 3x3 stems downsample only 2x, so stage 0 strides too (timm)
        stem_stride = 2 if cfg.stem_type == "3x3" else 4
        self.jax_names = {"head.fc": "head"}
        self.jax_names.update({f"stem.{n}": f"stem_{n}"
                               for n, _ in self.stem.named_children()})
        total_blocks = sum(cfg.depths)
        block_idx = 0
        expected_std = 1.0
        prev = stem_chs
        stages = []
        for si, (depth, chs) in enumerate(zip(cfg.depths, cfg.channels)):
            out_chs = make_divisible(chs * cfg.width_factor, cfg.ch_div)
            stride = 1 if si == 0 and stem_stride > 2 else 2
            blocks = []
            for bi in range(depth):
                self.jax_names[f"stages.{si}.{bi}"] = f"stage{si}_block{bi}"
                dpr = cfg.drop_path_rate * block_idx / max(total_blocks - 1, 1)
                blocks.append(NfBlock(cfg, prev, out_chs,
                                      stride if bi == 0 else 1,
                                      1.0 / expected_std, bi == 0, dpr,
                                      gconv))
                if bi == 0:
                    expected_std = 1.0
                expected_std = (expected_std ** 2 + cfg.alpha ** 2) ** 0.5
                block_idx += 1
                prev = out_chs
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.final_conv = (WSConv(prev, cfg.num_features, 1)
                           if cfg.num_features else None)
        self.head = (ClassifierHead(cfg.num_features or prev,
                                    cfg.num_classes, cfg.drop_rate)
                     if cfg.num_classes else None)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x)
        for stage in self.stages:
            for block in stage:
                x = block(x, train, generator)
        if self.final_conv is not None:
            x = self.act(self.final_conv(x))
        x = x.mean(dim=(2, 3))
        return x if self.head is None else self.head(x, train, generator)
