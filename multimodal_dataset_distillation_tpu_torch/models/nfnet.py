"""Normalizer-Free networks (NFNet-L0 and its CI-sized twin) in PyTorch.

Counterpart of ``multimodal_dataset_distillation_tpu/models/nfnet.py``:
scaled weight-standardized convs, variance-preserving activations,
residual branches scaled by beta = 1/expected_std on entry and alpha on
exit, SE after conv3 (timm ``attn_last``) with gain 2, zero-init skipinit
gain, final 1x1 conv, global average pool.

Module names, shapes and registration order are timm's ``NormFreeNet``
(``stem.conv1..4``, ``stages.{s}.{b}.{skipinit_gain, downsample.conv,
conv1, conv2, conv2b, conv3, attn_last.fc1/fc2}``, ``final_conv``), so
``parameters()`` order is the reference's snapshot order.  Supported here:
the deep_quad stem, headless towers (``num_classes=0``).  The s2d stem and
the other NF configurations come in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DropPath, SqueezeExcite, WSConv, gamma_act, tf_same_pad


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

# CI-sized NFNet: nfnet_l0's block anatomy at toy width and depth.
NF_TINY = NfConfig(
    depths=(1, 2), channels=(32, 64),
    stem_type="deep_quad", stem_chs=16, group_size=8, bottle_ratio=0.5,
    extra_conv=True, num_features=128, act="silu", attn_rd_ratio=0.25,
    skipinit=True, drop_path_rate=0.0,
)


class DeepQuadStem(nn.Module):
    """3x3/s2 -> 3x3 -> 3x3 -> 3x3/s2, widths c/8, c/4, c/2, c."""

    def __init__(self, in_chs: int, c: int, act: str):
        super().__init__()
        self.conv1 = WSConv(in_chs, c // 8, 3, stride=2)
        self.conv2 = WSConv(c // 8, c // 4, 3)
        self.conv3 = WSConv(c // 4, c // 2, 3)
        self.conv4 = WSConv(c // 2, c, 3, stride=2)
        self.act = gamma_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.conv1(x))
        x = self.act(self.conv2(x))
        x = self.act(self.conv3(x))
        return self.conv4(x)


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
        if cfg.reg:
            raise NotImplementedError("reg-style NF blocks come with a "
                                      "later slice")
        mid = make_divisible(out_chs * cfg.bottle_ratio, cfg.ch_div)
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
        self.conv3 = WSConv(mid, out_chs, 1)
        self.attn_last = (SqueezeExcite(out_chs, rd_ratio=cfg.attn_rd_ratio)
                          if cfg.attn_rd_ratio > 0 else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.act(x) * self.beta
        shortcut = self.downsample(out) if self.downsample is not None else x
        out = self.conv1(out)
        out = self.conv2(self.act(out))
        if self.conv2b is not None:
            out = self.conv2b(self.act(out))
        out = self.conv3(self.act(out))
        if self.attn_last is not None:
            out = self.attn_gain * self.attn_last(out)
        out = self.drop_path(out, train, generator)
        if self.skipinit_gain is not None:
            out = out * self.skipinit_gain
        return out * self.alpha + shortcut


class NormFreeNet(nn.Module):
    """Headless normalizer-free network over :class:`NfConfig`; NCHW in,
    pooled (N, features) out."""

    def __init__(self, cfg: NfConfig, in_chs: int = 3, gconv: bool = False):
        super().__init__()
        if cfg.stem_type != "deep_quad" or cfg.num_classes:
            raise NotImplementedError(
                "this slice ports the deep_quad stem and headless towers")
        self.cfg = cfg
        self.act = gamma_act(cfg.act)
        stem_chs = make_divisible(cfg.stem_chs * cfg.width_factor, cfg.ch_div)
        self.stem = DeepQuadStem(in_chs, stem_chs, cfg.act)
        total_blocks = sum(cfg.depths)
        block_idx = 0
        expected_std = 1.0
        prev = stem_chs
        stages = []
        for si, (depth, chs) in enumerate(zip(cfg.depths, cfg.channels)):
            out_chs = make_divisible(chs * cfg.width_factor, cfg.ch_div)
            stride = 1 if si == 0 else 2  # deep_quad stems already stride 4
            blocks = []
            for bi in range(depth):
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

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x)
        for stage in self.stages:
            for block in stage:
                x = block(x, train, generator)
        if self.final_conv is not None:
            x = self.act(self.final_conv(x))
        return x.mean(dim=(2, 3))
