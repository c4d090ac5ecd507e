"""VLBiEncoder: the CLIP-style bi-encoder (CLIPModel_full equivalent).

Counterpart of ``multimodal_dataset_distillation_tpu/models/clip_model.py``
and of ``engine/expert.py::init_bi_encoder`` there.  The two parameter
groups the reference optimizes and snapshots separately are the
``image_encoder`` and ``text_projection`` submodules; text features are
cached embeddings, so the frozen text encoder is not a submodule.
:class:`VLBiEncoderTrainableText` is the ``--text_trainable`` variant,
with BERT inside the step.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.contrastive import FIXED_LOGIT_SCALE, contrastive_loss_and_acc
from .bert import BERT_BASE, BERT_TINY, BertConfig, BertEncoder
from .layers import WSConv
from .projection import ProjectionHead
from .zoo import IMAGE_FEATURE_DIMS, ImageTower

# text widths of the offline tiny encoders (BERT_TINY, CLIP_TEXT_TINY)
_TINY_TEXT_DIM = 128


class VLBiEncoder(nn.Module):
    def __init__(self, image_encoder_name: str = "nfnet",
                 text_embedding: int = 768, image_embedding: int = 2304,
                 proj_dropout: float = 0.1, gconv: bool = False):
        super().__init__()
        self.text_embedding = text_embedding
        self.image_encoder = ImageTower(image_encoder_name, gconv=gconv)
        self.text_projection = ProjectionHead(text_embedding, image_embedding,
                                              dropout=proj_dropout)

    def encode_image(self, images: torch.Tensor, train: bool = False,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return self.image_encoder(images, train, generator)

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
                 gconv: bool = False):
        super().__init__(image_encoder_name, bert.hidden_size,
                         image_embedding, gconv=gconv)
        self.text_encoder = BertEncoder(bert)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        img = self.encode_image(images, train, generator).float()
        cls = self.text_encoder(input_ids, attention_mask)[:, 0]
        txt = self.project_text(cls, train, generator)
        return contrastive_loss_and_acc(img, txt, FIXED_LOGIT_SCALE)


def _check_buildable(cfg: Config) -> None:
    if cfg.only_has_image_projection or cfg.transfer:
        raise NotImplementedError(
            "--transfer / --only_has_image_projection: the transfer and "
            "image-projection heads are not ported yet (ROADMAP A, item 16)")
    if cfg.image_encoder not in IMAGE_FEATURE_DIMS:
        raise NotImplementedError(
            f"--image_encoder={cfg.image_encoder}: models/zoo.py towers are "
            f"not ported yet (ROADMAP A, item 16); the port has "
            f"{', '.join(IMAGE_FEATURE_DIMS)}")


def build_bi_encoder(cfg: Config, device=None) -> VLBiEncoder:
    """Build from a :class:`Config` like the JAX ``build_bi_encoder``, on
    ``device`` (default ``cfg.device``, the card unless the config says
    otherwise); the grouped 3x3 convs take the kernels when
    ``cfg.pallas_gconv`` is set."""
    _check_buildable(cfg)
    text_dim = (_TINY_TEXT_DIM if cfg.text_encoder_config == "tiny"
                else cfg.text_embedding)
    model = VLBiEncoder(image_encoder_name=cfg.image_encoder,
                        text_embedding=text_dim,
                        image_embedding=IMAGE_FEATURE_DIMS[cfg.image_encoder],
                        gconv=cfg.pallas_gconv)
    return model.to(cfg.device if device is None else device)


def build_trainable_text(cfg: Config, device=None) -> VLBiEncoderTrainableText:
    """The ``--text_trainable`` bi-encoder for ``cfg`` (BERT-base, or the
    tiny BERT when ``text_encoder_config="tiny"``), on ``device``."""
    _check_buildable(cfg)
    model = VLBiEncoderTrainableText(
        cfg.image_encoder, IMAGE_FEATURE_DIMS[cfg.image_encoder],
        BERT_TINY if cfg.text_encoder_config == "tiny" else BERT_BASE,
        gconv=cfg.pallas_gconv)
    return model.to(cfg.device if device is None else device)


def _trunc_normal(t: torch.Tensor, fan_in: int, scale: float,
                  gen: torch.Generator) -> None:
    # flax variance_scaling(scale, "fan_in", "truncated_normal")
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


@torch.no_grad()
def init_bi_encoder(model: VLBiEncoder, seed: int = 0) -> VLBiEncoder:
    """Fresh weights from a seeded generator, with the JAX package's
    initializers: he-normal WS kernels, unit gains, zero biases, zero
    skipinit gains, lecun-normal dense kernels, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, WSConv):
            w = torch.empty(mod.weight.shape)
            _trunc_normal(w, mod.weight[0].numel(), 2.0, gen)
            mod.weight.copy_(w)
            mod.gain.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = torch.empty(mod.weight.shape)
            _trunc_normal(w, mod.weight[0].numel(), 1.0, gen)
            mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("skipinit_gain"):
            p.zero_()
    return model
