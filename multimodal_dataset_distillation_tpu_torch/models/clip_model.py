"""VLBiEncoder: the CLIP-style bi-encoder (CLIPModel_full equivalent).

Counterpart of ``multimodal_dataset_distillation_tpu/models/clip_model.py``
and of ``engine/expert.py::init_bi_encoder`` there.  The two parameter
groups the reference optimizes and snapshots separately are the
``image_encoder`` and ``text_projection`` submodules; text features are
cached embeddings, so the frozen text encoder is not a submodule.  With
``only_image_projection`` an ``image_projection`` head (to 768) follows
the image tower; no optimizer steps it (the reference's groups), so it
stays at its init.  ``transfer`` gives the ``nfnet`` tower its 1000-class
head (the reference's ``eval_stage``).
:class:`VLBiEncoderTrainableText` is the ``--text_trainable`` variant,
with BERT inside the step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops import s2d
from ..ops.contrastive import FIXED_LOGIT_SCALE, contrastive_loss_and_acc
from .bert import BERT_BASE, BERT_TINY, BertConfig, BertEncoder
from .clip_text import CLIP_TEXT_TINY
from .clip_vision import ClipVisionTransformer
from .convnext import ConvNeXtBlock
from .layers import BatchNorm, WSConv, trunc_normal_fan_in
from .projection import ProjectionHead
from .vit import VisionTransformer
from .zoo import ImageTower, feature_dim


class VLBiEncoder(nn.Module):
    def __init__(self, image_encoder_name: str = "nfnet",
                 text_embedding: int = 768, image_embedding: int = 2304,
                 proj_dropout: float = 0.1, gconv: bool = False,
                 only_image_projection: bool = False, transfer: bool = False,
                 image_size: int = 224, stem_s2d: bool = False):
        super().__init__()
        self.text_embedding = text_embedding
        self.image_encoder = ImageTower(image_encoder_name, gconv=gconv,
                                        transfer=transfer,
                                        image_size=image_size,
                                        stem_s2d=stem_s2d)
        self.text_projection = ProjectionHead(text_embedding, image_embedding,
                                              dropout=proj_dropout)
        self.image_projection = (ProjectionHead(image_embedding,
                                                dropout=proj_dropout)
                                 if only_image_projection else None)

    def encode_image(self, images: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        feats = self.image_encoder(images, train, generator)
        if self.image_projection is not None:
            feats = self.image_projection(feats, train, generator)
        return feats

    def project_text(self, text_features: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return self.text_projection(text_features, train, generator)

    def forward(self, images: torch.Tensor, text_features: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        img = self.encode_image(images, train, generator).float()
        txt = self.project_text(text_features.float(), train, generator)
        return contrastive_loss_and_acc(img, txt, FIXED_LOGIT_SCALE)


class VLBiEncoderTrainableText(VLBiEncoder):
    """The bi-encoder of ``--text_trainable`` (buffer.py:49-50): the BERT
    tower runs inside the step on tokenized captions, the projection over
    its CLS row.  BERT has no dropout (the JAX module's has none); the
    projection keeps its train-mode dropout.  ``project_text`` scores
    cached CLS embeddings, as ``epoch_test`` does in this mode too."""

    def __init__(self, image_encoder_name: str = "nfnet",
                 image_embedding: int = 2304, bert: BertConfig = BERT_BASE,
                 gconv: bool = False, image_size: int = 224,
                 stem_s2d: bool = False):
        super().__init__(image_encoder_name, bert.hidden_size,
                         image_embedding, gconv=gconv, image_size=image_size,
                         stem_s2d=stem_s2d)
        self.text_encoder = BertEncoder(bert)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        img = self.encode_image(images, train, generator).float()
        cls = self.text_encoder(input_ids, attention_mask)[:, 0]
        txt = self.project_text(cls, train, generator)
        return contrastive_loss_and_acc(img, txt, FIXED_LOGIT_SCALE)


def build_bi_encoder(cfg: Config, device=None) -> VLBiEncoder:
    """Build from a :class:`Config` like the JAX ``build_bi_encoder``, on
    ``device`` (default ``cfg.device``, the card unless the config says
    otherwise); the grouped 3x3 convs take the kernels when
    ``cfg.pallas_gconv`` is set, and the NF stems run in space-to-depth
    form when ``cfg.stem_s2d`` is (``MDD_STEM_S2D`` wins when set).  The
    text width is the configured text encoder's (768 BERT-base, 512
    CLIP-base; 128 for either tiny tower)."""
    text_dim = cfg.text_embedding
    if cfg.text_encoder_config == "tiny":
        text_dim = (BERT_TINY.hidden_size if cfg.text_encoder == "bert"
                    else CLIP_TEXT_TINY.embed_dim)
    model = VLBiEncoder(image_encoder_name=cfg.image_encoder,
                        text_embedding=text_dim,
                        image_embedding=feature_dim(cfg.image_encoder,
                                                    cfg.transfer),
                        gconv=cfg.pallas_gconv,
                        only_image_projection=cfg.only_has_image_projection,
                        transfer=cfg.transfer, image_size=cfg.image_size,
                        stem_s2d=s2d.configure(cfg))
    return model.to(cfg.device if device is None else device)


def build_trainable_text(cfg: Config, device=None) -> VLBiEncoderTrainableText:
    """The ``--text_trainable`` bi-encoder for ``cfg`` (BERT-base, or the
    tiny BERT when ``text_encoder_config="tiny"``), on ``device``; like the
    JAX one it has no image projection and no transfer head."""
    model = VLBiEncoderTrainableText(
        cfg.image_encoder, feature_dim(cfg.image_encoder),
        BERT_TINY if cfg.text_encoder_config == "tiny" else BERT_BASE,
        gconv=cfg.pallas_gconv, image_size=cfg.image_size,
        stem_s2d=s2d.configure(cfg))
    return model.to(cfg.device if device is None else device)


@torch.no_grad()
def init_bi_encoder(model: VLBiEncoder, seed: int = 0) -> VLBiEncoder:
    """Fresh weights from a seeded generator, with the JAX package's
    initializers: he-normal WS kernels, unit gains, zero biases, zero
    skipinit gains, lecun-normal conv and dense kernels, unit norm scales,
    BatchNorm running averages 0 / 1, ViT's ``cls_token`` zeros and
    ``pos_embed`` normal(0.02), CLIP's ``class_embedding`` and
    ``positional_embedding`` normal(0.02) and ``proj`` normal(0.01),
    ConvNeXt's layer scales 1e-6 (its depthwise kernels lecun-normal on
    their fan-in of 49, as every conv)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, WSConv):
            w = torch.empty(mod.weight.shape)
            trunc_normal_fan_in(w, mod.weight[0].numel(), 2.0, gen)
            mod.weight.copy_(w)
            mod.gain.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = torch.empty(mod.weight.shape)
            trunc_normal_fan_in(w, mod.weight[0].numel(), 1.0, gen)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, VisionTransformer):
            mod.cls_token.zero_()
            mod.pos_embed.copy_(0.02 * torch.randn(mod.pos_embed.shape,
                                                   generator=gen))
        elif isinstance(mod, ClipVisionTransformer):
            for p, std in ((mod.class_embedding, 0.02),
                           (mod.positional_embedding, 0.02),
                           (mod.proj, 0.01)):
                p.copy_(std * torch.randn(p.shape, generator=gen))
        elif isinstance(mod, ConvNeXtBlock):
            mod.gamma.fill_(1e-6)
    for name, p in model.named_parameters():
        if name.endswith("skipinit_gain"):
            p.zero_()
    return model
