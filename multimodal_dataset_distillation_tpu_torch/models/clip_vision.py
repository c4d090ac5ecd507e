"""CLIP vision tower (the ViT-B/32 layout).

Counterpart of ``multimodal_dataset_distillation_tpu/models/clip_vision.py``
(the reference's ``--image_encoder=clip``: OpenAI CLIP ViT-B/32's
``encode_image``, ``networks.py:659-661, 679-680``, 512-d features):

* a patch conv without bias; tokens are its output in row-major (h, w)
  order, after the class token; a positional embedding with one row per
  token, so its length follows the image size given at build time (50 at
  224^2), as the JAX module sizes it from its input;
* ``ln_pre``; pre-LN blocks with QuickGELU; ``ln_post`` on the class token;
  the (width, embed) ``proj``.

Names follow the JAX tree (``patch_embed``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``blocks.{i}`` for ``block{i}``,
``ln_post``, ``proj``; a block's ``attn.q_proj`` is the flax
``block{i}/q_proj``), so :mod:`.convert` carries its weights across.
Dtypes follow flax's promotion as in :mod:`.vit`: logits, softmax and the
attention-weighted sum in float32, every later layer in the promoted dtype
of its input and parameters.  Attention is an explicit matmul + softmax,
which the distillation step differentiates twice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import ClipBlock
from .layers import layer_norm, promoted


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 512
    layer_norm_eps: float = 1e-5


CLIP_VIT_B32 = ClipVisionConfig()


class ClipVisionTransformer(nn.Module):
    """NCHW images -> (N, embed) features; ``forward(x, train, generator)``
    like the zoo's other towers (none of it is random)."""

    def __init__(self, cfg: ClipVisionConfig = CLIP_VIT_B32,
                 image_size: Optional[int] = None, in_chs: int = 3):
        super().__init__()
        self.cfg = cfg
        size = cfg.image_size if image_size is None else image_size
        tokens = (size // cfg.patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(in_chs, cfg.width, cfg.patch_size,
                                     cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(tokens, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.blocks = nn.ModuleList(
            ClipBlock(cfg.width, cfg.num_heads, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers))
        for block in self.blocks:   # flax's vision block has no attn module
            block.jax_names = {f"attn.{n}": n for n in
                               ("q_proj", "k_proj", "v_proj", "out_proj")}
        self.ln_post = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))
        self.jax_names = {f"blocks.{i}": f"block{i}"
                          for i in range(cfg.num_layers)}

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, w = promoted(x, self.patch_embed.weight)
        x = F.conv2d(x, w, stride=self.cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)   # (B, patches, width), row-major
        b, n, d = x.shape
        if n + 1 != self.positional_embedding.shape[0]:
            raise ValueError(
                f"{n} patches, but positional_embedding was built for "
                f"{self.positional_embedding.shape[0] - 1}: build the tower "
                f"at this image size")
        x, cls = promoted(x, self.class_embedding)
        x = torch.cat([cls.expand(b, 1, d), x], dim=1)
        x, pos = promoted(x, self.positional_embedding)
        x = layer_norm(x + pos, self.ln_pre)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(x[:, 0], self.ln_post)
        return x.float() @ self.proj.float()


def clip_vision_state_dict_from_hf(sd: Dict[str, torch.Tensor],
                                   cfg: ClipVisionConfig = CLIP_VIT_B32
                                   ) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPModel.state_dict()``'s vision branch -> the state dict
    of :class:`ClipVisionTransformer` (renames; HF's
    ``visual_projection`` Linear transposed into ``proj``)."""
    out = {
        "patch_embed.weight":
            sd["vision_model.embeddings.patch_embedding.weight"],
        "class_embedding": sd["vision_model.embeddings.class_embedding"],
        "positional_embedding":
            sd["vision_model.embeddings.position_embedding.weight"],
        "ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "proj": sd["visual_projection.weight"].t(),
    }
    names = {"layer_norm1": "ln_1", "layer_norm2": "ln_2",
             "self_attn.q_proj": "attn.q_proj",
             "self_attn.k_proj": "attn.k_proj",
             "self_attn.v_proj": "attn.v_proj",
             "self_attn.out_proj": "attn.out_proj",
             "mlp.fc1": "mlp_fc", "mlp.fc2": "mlp_proj"}
    for i in range(cfg.num_layers):
        for hf, own in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{own}.{leaf}"] = sd[
                    f"vision_model.encoder.layers.{i}.{hf}.{leaf}"]
    return {k: v.detach().float().contiguous() for k, v in out.items()}


def try_hf_clip_vision_weights(cfg: ClipVisionConfig = CLIP_VIT_B32
                               ) -> Optional[Dict[str, torch.Tensor]]:
    """CLIP vision weights from a local HF cache (``local_files_only``), or
    None."""
    try:
        from transformers import CLIPModel

        m = CLIPModel.from_pretrained("openai/clip-vit-base-patch32",
                                      local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None
    return clip_vision_state_dict_from_hf(m.state_dict(), cfg)
