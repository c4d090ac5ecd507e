"""Vision Transformer (ViT-Tiny/16).

Counterpart of ``multimodal_dataset_distillation_tpu/models/vit.py`` (the
reference's ``timm.create_model('vit_tiny_patch16_224')``,
``networks.py:668``, with its 1000-class head): dim 192, depth 12, 3
heads, MLP ratio 4, exact GELU, LayerNorm eps 1e-6 (flax's default),
``cls_token`` zeros, ``pos_embed`` normal(0.02) with one row per patch
plus the CLS token, so its length follows the image size given at build
time (5 at 32^2, 197 at 224^2), as the JAX module sizes it from its input.

Names and registration order are timm's (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``, ``head``): ``parameters()`` is the
reference snapshot order and a timm state dict loads strictly.

Dtypes follow flax's promotion: the attention logits, the softmax and the
attention-weighted sum are float32 whatever the compute dtype
(``preferred_element_type=float32`` there), and every later layer
computes in the promoted dtype of its input and parameters, so under
bfloat16 weights the blocks run in float32 from the first attention on,
as in the JAX package.  Attention is an explicit matmul + softmax: the
distillation step differentiates it twice, which the fused
``scaled_dot_product_attention`` backends do not support.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense, promoted


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype (flax ``nn.LayerNorm``)."""
    x, w, b = promoted(x, layer.weight, layer.bias)
    return F.layer_norm(x, layer.normalized_shape, w, b, layer.eps)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chs: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chs, dim, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promoted(x, self.proj.weight, self.proj.bias)
        y = F.conv2d(x, w, b, self.proj.stride)
        return y.flatten(2).transpose(1, 2)   # (B, patches, dim), row-major


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = dense(x, self.qkv).reshape(b, n, 3, h, c // h).float()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        out = torch.softmax(attn, dim=-1) @ v        # (B, H, N, hd) float32
        return dense(out.transpose(1, 2).reshape(b, n, c), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(F.gelu(dense(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: float = 4.0,
                 num_classes: int = 1000, image_size: int = 224,
                 in_chs: int = 3):
        super().__init__()
        tokens = (image_size // patch_size) ** 2 + 1
        # the root's direct parameters lead parameters(), as in timm
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.patch_embed = PatchEmbed(patch_size, in_chs, dim)
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes) if num_classes else None
        self.jax_names = {"patch_embed.proj": "patch_embed",
                          **{f"blocks.{i}": f"block{i}"
                             for i in range(depth)}}

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(x)
        b, n, d = x.shape
        if n + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{n} patches, but pos_embed was built for "
                             f"{self.pos_embed.shape[1] - 1}: build the "
                             f"tower at this image size")
        x, cls = promoted(x, self.cls_token)
        x = torch.cat([cls.expand(b, 1, d), x], dim=1)
        x, pos = promoted(x, self.pos_embed)
        x = x + pos
        for block in self.blocks:
            x = block(x)
        feats = layer_norm(x, self.norm)[:, 0]
        return feats if self.head is None else dense(feats, self.head)


def vit_tiny_patch16_224(num_classes: int = 1000,
                         image_size: int = 224) -> VisionTransformer:
    return VisionTransformer(patch_size=16, dim=192, depth=12, num_heads=3,
                             num_classes=num_classes, image_size=image_size)
