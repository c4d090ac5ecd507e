"""ConvNeXt-Tiny, headless (768 pooled features).

Counterpart of ``multimodal_dataset_distillation_tpu/models/convnext.py``
(the reference's ``--image_encoder=convnext``, built through timm's
generic branch, ``networks.py:674``; the reference's dim table says 640,
``networks.py:816-817``, a latent shape bug: the tower gives 768).

Depths 3/3/9/3, dims 96/192/384/768.  The stem is a 4x4/4 conv and a
LayerNorm; each downsample a LayerNorm and a 2x2/2 conv; each block a
depthwise 7x7 conv padded 3, a LayerNorm over the channels (eps 1e-6),
Linear 4x, exact GELU, Linear, and the layer scale ``gamma`` (init 1e-6)
on the residual branch; then the global mean and ``head_norm``.  NCHW in,
channels-last in memory: a channel LayerNorm and the block's MLP run on
the free NHWC view, as the JAX module runs them on its NHWC activations.
Every layer computes in the promoted dtype of its input and parameters
(flax's ``dtype=None``).  Flax's LayerNorm takes the variance as
``E[x^2] - E[x]^2``, torch's as ``E[(x - E[x])^2]``: they agree to
float32 round-off.

Names follow the JAX tree through ``jax_names`` (``stem_conv``,
``stem_norm``, ``down_norms.{i}`` / ``down_convs.{i}`` for
``down{i+1}_norm`` / ``down{i+1}_conv``, ``stages.{s}.{b}`` for
``stage{s}_block{b}`` with ``dwconv``, ``norm``, ``pwconv1``, ``pwconv2``,
``gamma``; ``head_norm``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ChannelLayerNorm, dense, promoted, tf_same_pad
from .vit import layer_norm


def conv(x: torch.Tensor, layer: nn.Conv2d, padding: int = 0) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype (flax ``nn.Conv``)."""
    x, w, b = promoted(x, layer.weight, layer.bias)
    return F.conv2d(x, w, b, layer.stride, padding, groups=layer.groups)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv(x, self.dwconv, padding=3).permute(0, 2, 3, 1)   # NHWC
        h = F.gelu(dense(layer_norm(h, self.norm), self.pwconv1))
        h, gamma = promoted(dense(h, self.pwconv2), self.gamma)
        return x + (gamma * h).permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """NCHW images -> (N, dims[-1]) pooled features (or classes with
    ``num_classes``); ``forward(x, train, generator)`` like the zoo's other
    towers (none of it is random)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 0, in_chs: int = 3):
        super().__init__()
        self.stem_conv = nn.Conv2d(in_chs, dims[0], 4, 4)
        self.stem_norm = ChannelLayerNorm(dims[0], eps=1e-6)
        self.down_norms = nn.ModuleList(ChannelLayerNorm(d, eps=1e-6)
                                        for d in dims[:-1])
        self.down_convs = nn.ModuleList(nn.Conv2d(a, b, 2, 2)
                                        for a, b in zip(dims, dims[1:]))
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(d) for _ in range(n))
            for n, d in zip(depths, dims))
        self.head_norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes) if num_classes else None
        self.jax_names = {f"stages.{s}.{b}": f"stage{s}_block{b}"
                          for s, n in enumerate(depths) for b in range(n)}
        for i in range(len(dims) - 1):
            self.jax_names[f"down_norms.{i}"] = f"down{i + 1}_norm"
            self.jax_names[f"down_convs.{i}"] = f"down{i + 1}_conv"

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for si, blocks in enumerate(self.stages):
            if si == 0:
                x = conv(tf_same_pad(x, 4, 4), self.stem_conv)
                x = self.stem_norm(x)
            else:
                x = self.down_norms[si - 1](x)
                x = conv(tf_same_pad(x, 2, 2), self.down_convs[si - 1])
            for block in blocks:
                x = block(x)
        x = layer_norm(x.mean(dim=(2, 3)), self.head_norm)
        return x if self.head is None else dense(x, self.head)


def convnext_tiny(num_classes: int = 0) -> ConvNeXt:
    return ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768), num_classes)
