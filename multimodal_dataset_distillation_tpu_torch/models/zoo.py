"""Image-tower registry (the subset this slice ports: ``nfnet``, ``nf_tiny``).

Counterpart of ``multimodal_dataset_distillation_tpu/models/zoo.py:26-105``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .nfnet import NF_TINY, NFNET_L0, NormFreeNet

# image-tower output dims (what the contrastive loss sees)
IMAGE_FEATURE_DIMS = {
    "nfnet": 2304,
    "nf_tiny": 128,
}

_CONFIGS = {"nfnet": NFNET_L0, "nf_tiny": NF_TINY}


class ImageTower(nn.Module):
    """``forward(x, train, generator)`` on NHWC images, like the JAX tower.

    The NHWC batch is viewed as NCHW without a copy: a contiguous NHWC
    tensor is a channels-last NCHW one, so the tower runs channels-last and
    the grouped-conv kernel sees NHWC activations without transposes.
    """

    def __init__(self, encoder_name: str, gconv: bool = False):
        super().__init__()
        if encoder_name not in _CONFIGS:
            raise ValueError(f"image encoder {encoder_name!r} is not ported "
                             f"yet (have {sorted(_CONFIGS)})")
        self.encoder_name = encoder_name
        self.model = NormFreeNet(_CONFIGS[encoder_name], gconv=gconv)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(x.permute(0, 3, 1, 2), train, generator)
