"""Image-tower registry (the subset this slice ports: ``nfnet``, ``nf_tiny``).

Counterpart of ``multimodal_dataset_distillation_tpu/models/zoo.py:26-105``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

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


# timm checkpoint file names as the reference's `timm.create_model(...,
# pretrained=True)` leaves them in the torch-hub cache (networks.py:666-672);
# the other towers' names come with their port
TIMM_CKPT_NAMES = {"nfnet": ("nfnet_l0_ra2-45c6688d.pth",)}


def find_local_timm_checkpoint(arch: str) -> Optional[str]:
    """Path of a local timm checkpoint for ``arch``, or None.  Searched:
    ``$MDD_TIMM_CKPT_<ARCH>``, ``$MDD_TIMM_CKPT``, then the torch-hub cache
    (``~/.cache/torch/hub/checkpoints``) under the known file names.
    Nothing is downloaded."""
    for env in (f"MDD_TIMM_CKPT_{arch.upper()}", "MDD_TIMM_CKPT"):
        p = os.environ.get(env)
        if p and os.path.exists(p):
            return p
    hub = os.path.join(os.path.expanduser("~"), ".cache", "torch", "hub",
                       "checkpoints")
    for name in TIMM_CKPT_NAMES.get(arch, ()):
        p = os.path.join(hub, name)
        if os.path.exists(p):
            return p
    return None


def load_timm_state_dict(arch: str
                         ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                    Optional[str]]:
    """(state dict, path) of the local timm checkpoint for ``arch``, or
    (None, None); a ``{"state_dict": ...}`` wrapper is unwrapped."""
    if arch not in TIMM_CKPT_NAMES:
        return None, None
    path = find_local_timm_checkpoint(arch)
    if path is None:
        return None, None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd, path


def load_timm_image_tower(tower: ImageTower,
                          sd: Dict[str, torch.Tensor]) -> None:
    """Load a timm state dict into the headless tower: the network uses
    timm's names, so it loads strictly once the classifier (``head.*``) is
    dropped."""
    tower.model.load_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("head.")})
