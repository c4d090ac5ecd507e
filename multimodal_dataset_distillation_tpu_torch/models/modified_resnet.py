"""OpenAI CLIP's ModifiedResNet with its attention pooling.

Counterpart of ``multimodal_dataset_distillation_tpu/models/
modified_resnet.py`` (the reference ships these blocks partly dead,
``networks.py:527-621`` / ``model.py:11-195``; the JAX package rebuilt them
as a working encoder, and no entry point of either package builds it):
a 3-conv stem with a 2x2 average pool, CLIP bottlenecks whose strides are
anti-aliased (a stride x stride average pool before the 1x1 expansion and
on the shortcut), and QKV attention pooling over the spatial mean and the
H*W tokens, whose output is the mean token's.

NCHW in.  BatchNorm is flax's (:class:`~.layers.BatchNorm`: momentum
0.99, eps 1e-5, the biased batch variance), so train mode moves the
running averages as the JAX module's ``batch_stats`` move.  3x3 convs are
TF-SAME, as flax's ``padding="SAME"``.  Names follow the JAX tree through
``jax_names`` (``layer{l}.{b}`` for ``layer{l}_{b}``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.contrastive import softmax
from .layers import BatchNorm, tf_same_pad


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, bias=False)


def _same(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    return layer(tf_same_pad(x, layer.kernel_size[0], layer.stride[0]))


class ClipBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.shortcut = stride > 1 or inplanes != out_ch
        if self.shortcut:
            self.down_conv = _conv(inplanes, out_ch, 1)
            self.down_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(_same(out, self.conv2), train))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride, self.stride)
        out = self.bn3(self.conv3(out), train)
        sc = x
        if self.shortcut:
            if self.stride > 1:
                sc = F.avg_pool2d(sc, self.stride, self.stride)
            sc = self.down_bn(self.down_conv(sc), train)
        return F.relu(out + sc)


class AttentionPool2d(nn.Module):
    def __init__(self, spatial: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spatial + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.flatten(2).transpose(1, 2)   # (B, HW, C), row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        b, n, c = tokens.shape
        h = self.num_heads

        def heads(layer):
            return layer(tokens).view(b, n, h, c // h).transpose(1, 2)

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        probs = softmax((q @ k.transpose(-2, -1)) * (c // h) ** -0.5, -1)
        out = (probs @ v).transpose(1, 2).reshape(b, n, c)
        return self.c_proj(out[:, 0])


class ModifiedResNet(nn.Module):
    """``input_resolution`` sizes the attention pool's positional
    embedding (its spatial grid is the input's / 32), as the JAX module
    sizes it from its input."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32, width: int = 64,
                 input_resolution: int = 224, in_chs: int = 3):
        super().__init__()
        self.conv1 = _conv(in_chs, width // 2, 3, 2)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = _conv(width // 2, width // 2, 3)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = _conv(width // 2, width, 3)
        self.bn3 = BatchNorm(width)
        self.jax_names = {}
        inplanes, stages = width, []
        for li, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes, stage = width * 2 ** li, []
            for bi in range(blocks):
                stage.append(ClipBottleneck(inplanes, planes,
                                            stride if bi == 0 else 1))
                inplanes = planes * ClipBottleneck.expansion
                self.jax_names[f"layers.{li}.{bi}"] = f"layer{li + 1}_{bi}"
            stages.append(nn.ModuleList(stage))
        self.layers = nn.ModuleList(stages)
        self.attnpool = AttentionPool2d((input_resolution // 32) ** 2,
                                        width * 32, heads, output_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(_same(x, self.conv1), train))
        x = F.relu(self.bn2(_same(x, self.conv2), train))
        x = F.relu(self.bn3(_same(x, self.conv3), train))
        x = F.avg_pool2d(x, 2, 2)
        for stage in self.layers:
            for block in stage:
                x = block(x, train)
        return self.attnpool(x)
