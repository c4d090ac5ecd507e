"""Image-tower registry and the legacy ``get_network`` surface.

Counterpart of ``multimodal_dataset_distillation_tpu/models/zoo.py`` (the
reference's ``ImageEncoder`` timm dispatch, ``networks.py:648-688``, and
``utils.get_network`` / ``get_eval_pool``, ``utils.py:148-246,336-360``).
Feature dims follow the reference: ``nfnet`` is headless (2304 features),
its ``--transfer`` tower keeps a 1000-class head, and ``vit`` /
``nf_resnet50`` / ``nf_regnet`` / ``resnet50`` keep their 1000-class heads;
``clip`` (CLIP ViT-B/32's ``encode_image``) gives 512 features and
``convnext`` (ConvNeXt-Tiny, headless) 768, the true widths (the
reference's dim table says 1000 and 640, ``networks.py:816-819``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import convnet as _convnet
from . import convnext as _convnext
from . import resnet as _resnet
from . import vit as _vit
from .clip_vision import ClipVisionTransformer
from .nfnet import NF_REGNET_B1, NF_RESNET50, NF_TINY, NFNET_L0, NormFreeNet

# image-tower output dims (what the contrastive loss sees)
IMAGE_FEATURE_DIMS = {
    "nfnet": 2304,
    "nfnet_transfer": 1000,
    "vit": 1000,
    "vit_tiny": 1000,
    "nf_resnet50": 1000,
    "nf_regnet": 1000,
    "resnet50": 1000,
    "resnet18": 512,
    "resnet18_gn": 512,
    "convnet": 768,
    "convnet_tiny": 64,
    "nf_tiny": 128,
    "clip": 512,
    "convnext": 768,
}

_NF = {"nfnet": NFNET_L0, "nf_tiny": NF_TINY, "nf_resnet50": NF_RESNET50,
       "nf_regnet": NF_REGNET_B1}

#: flax's auto-name of each network class inside the JAX ImageTower
JAX_TOWER_KEYS = {NormFreeNet: "NormFreeNet_0",
                  _convnet.ConvNet: "ConvNet_0", _resnet.ResNet: "ResNet_0",
                  _vit.VisionTransformer: "VisionTransformer_0",
                  ClipVisionTransformer: "ClipVisionTransformer_0",
                  _convnext.ConvNeXt: "ConvNeXt_0"}


def feature_dim(name: str, transfer: bool = False) -> int:
    """The tower's output width (the JAX ``create_image_encoder``'s)."""
    return IMAGE_FEATURE_DIMS["nfnet_transfer" if (name == "nfnet"
                                                   and transfer) else name]


def build_tower(name: str, transfer: bool = False, gconv: bool = False,
                image_size: int = 224, stem_s2d: bool = False) -> nn.Module:
    """The network of the JAX ``zoo._build(name, transfer)``; ``gconv``
    routes the NF towers' grouped 3x3s to the kernels, ``stem_s2d`` runs
    their stems in space-to-depth form, ``image_size`` sizes the ViTs'
    positional embeddings."""
    if name in _NF:
        cfg = _NF[name]
        if name == "nfnet" and transfer:
            cfg = dataclasses.replace(cfg, num_classes=1000)
        return NormFreeNet(cfg, gconv=gconv, stem_s2d=stem_s2d)
    if name in ("vit", "vit_tiny"):
        return _vit.vit_tiny_patch16_224(1000, image_size)
    if name == "clip":
        return ClipVisionTransformer(image_size=image_size)
    if name == "convnext":
        return _convnext.convnext_tiny(num_classes=0)
    if name == "resnet50":
        return _resnet.resnet50(1000)
    if name == "resnet18":
        return _resnet.resnet18(512, imagenet_stem=True)
    if name == "resnet18_gn":
        return _resnet.resnet18_gn(512)
    if name == "convnet":
        return _convnet.ConvNet(768, gap=True)
    if name == "convnet_tiny":
        return _convnet.ConvNet(64, net_width=16, net_depth=2, gap=True)
    raise ValueError(f"unknown image encoder: {name}")


class ImageTower(nn.Module):
    """``forward(x, train, generator)`` on NHWC images, like the JAX tower.

    Every tower takes that signature on NCHW; only the NFNets read the
    generator (drop path, head dropout).  The towers' norm layers all take
    ``train``; only BatchNorm reads it.

    The NHWC batch is viewed as NCHW without a copy: a contiguous NHWC
    tensor is a channels-last NCHW one, so the tower runs channels-last and
    the grouped-conv kernel sees NHWC activations without transposes.
    """

    def __init__(self, encoder_name: str, gconv: bool = False,
                 transfer: bool = False, image_size: int = 224,
                 stem_s2d: bool = False):
        super().__init__()
        self.encoder_name = encoder_name
        self.model = build_tower(encoder_name, transfer, gconv, image_size,
                                 stem_s2d)
        self.jax_names = {"model": JAX_TOWER_KEYS[type(self.model)]}

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(x.permute(0, 3, 1, 2), train, generator)


def create_image_encoder(name: str, transfer: bool = False,
                         gconv: bool = False, image_size: int = 224,
                         stem_s2d: bool = False) -> Tuple[ImageTower, int]:
    """(the tower, its output width), as the JAX ``create_image_encoder``."""
    return (ImageTower(name, gconv, transfer, image_size, stem_s2d),
            feature_dim(name, transfer))


def get_network(model: str, channel: int, num_classes: int,
                im_size: Tuple[int, int] = (32, 32)) -> nn.Module:
    """The DC zoo by name (utils.py:148-246), with the full variant grammar:
    ConvNetD{n}, ConvNetW{n}, ConvNetA{S,R,L}, ConvNet{NN,BN,LN,IN,GN},
    ConvNet{NP,MP,AP}, ConvNetKIP, ConvNetGAP, MLP, LeNet, AlexNet,
    VGG11/13/16/19[BN], ResNet18[_AP|BN_AP].  Modules take NCHW."""
    w, d, act, norm, pool = 128, 3, "relu", "instancenorm", "avgpooling"
    size = tuple(im_size)
    if model == "MLP":
        return _convnet.MLP(num_classes, channel * size[0] * size[1])
    if model == "LeNet":
        return _convnet.LeNet(num_classes, channel, size)
    if model == "AlexNet":
        return _convnet.AlexNet(num_classes, channel, size)
    if model.startswith("VGG"):
        base = model[:5] if model[3:5].isdigit() else model[:4]
        kind = "batchnorm" if model.endswith("BN") else "instancenorm"
        return _convnet.VGG(base, num_classes, kind, channel, size)
    if model == "ResNet18":
        return _resnet.ResNet("basic", (2, 2, 2, 2), num_classes,
                              in_chs=channel)
    if model in ("ResNet18_AP", "ResNet18BN_AP"):
        return _resnet.ResNet("basic", (2, 2, 2, 2), num_classes,
                              avg_pool_down=True, in_chs=channel)
    if model.startswith("ConvNet"):
        suffix = model[len("ConvNet"):]
        gap = False
        if suffix.startswith("D"):
            d = int(suffix[1:])
        elif suffix.startswith("W"):
            w = int(suffix[1:])
        elif suffix in ("AS", "AR", "AL"):
            act = {"AS": "sigmoid", "AR": "relu", "AL": "leakyrelu"}[suffix]
        elif suffix in ("NN", "BN", "LN", "IN", "GN"):
            norm = {"NN": "none", "BN": "batchnorm", "LN": "layernorm",
                    "IN": "instancenorm", "GN": "groupnorm"}[suffix]
        elif suffix in ("NP", "MP", "AP"):
            pool = {"NP": "none", "MP": "maxpooling",
                    "AP": "avgpooling"}[suffix]
        elif suffix == "KIP":
            w, norm = 1024, "none"
        elif suffix == "GAP":
            gap = True
        return _convnet.ConvNet(num_classes, w, d, act, norm, pool, gap,
                                channel, size)
    raise ValueError(f"DC error: unknown model {model}")


def get_eval_pool(eval_mode: str, model: str, model_eval: str) -> list:
    """Eval-pool grammar (utils.py:336-360)."""
    pools = {
        "M": ["ConvNet", "AlexNet", "VGG11", "ResNet18_AP", "ResNet18"],
        "W": ["ConvNetW32", "ConvNetW64", "ConvNetW128", "ConvNetW256"],
        "D": ["ConvNetD1", "ConvNetD2", "ConvNetD3", "ConvNetD4"],
        "A": ["ConvNetAS", "ConvNetAR", "ConvNetAL"],
        "P": ["ConvNetNP", "ConvNetMP", "ConvNetAP"],
        "N": ["ConvNetNN", "ConvNetBN", "ConvNetLN", "ConvNetIN",
              "ConvNetGN"],
    }
    if eval_mode in pools:
        return pools[eval_mode]
    if eval_mode == "S":
        return [model[: model.index("BN")]] if "BN" in model else [model]
    if eval_mode == "C":
        return [model, "ConvNet"]
    return [model_eval]


# timm checkpoint file names as the reference's `timm.create_model(...,
# pretrained=True)` leaves them in the torch-hub cache (networks.py:666-674)
TIMM_CKPT_NAMES = {
    "nfnet": ("nfnet_l0_ra2-45c6688d.pth",),
    "nf_resnet50": ("nf_resnet50_ra2-9f236009.pth",),
    "nf_regnet": ("nf_regnet_b1_256_ra2-ad85cfef.pth",),
    "resnet50": ("resnet50_a1_0-14fe96d1.pth", "resnet50_ram-a26f946b.pth"),
    "resnet18": ("resnet18-5c106cde.pth",),
    # vit_tiny has no stable hub file name: $MDD_TIMM_CKPT_VIT names one
    "vit": (),
}


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
    """Load a timm / torchvision state dict into the tower, as the JAX
    ``load_image_tower_weights`` does: the networks use those names, so it
    loads strictly, BatchNorm's ``num_batches_tracked`` counters dropped
    (flax keeps none), the classifier kept (the reference keeps it) but
    where the tower is headless and for ``nfnet``, whose JAX importer maps
    no head: its ``--transfer`` tower keeps the head it has."""
    own = tower.model.state_dict().keys()
    skip_head = tower.encoder_name == "nfnet" or not any(
        k.startswith("head.") for k in own)
    missing, unexpected = tower.model.load_state_dict({
        k: v for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
        and not (skip_head and k.startswith("head."))}, strict=False)
    missing = [k for k in missing
               if not (skip_head and k.startswith("head."))]
    if missing or unexpected:
        raise KeyError(f"timm checkpoint for {tower.encoder_name}: missing "
                       f"{missing[:4]}, unexpected {unexpected[:4]}")
