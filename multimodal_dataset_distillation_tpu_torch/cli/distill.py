"""Distillation entry point: the eval students' initializer.

Counterpart of ``multimodal_dataset_distillation_tpu/cli/distill.py:77-108``.
The rest of the distill CLI (data, buffers, the outer loop and its eval
block) comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import Config
from ..models.clip_model import VLBiEncoder, init_bi_encoder
from ..models.zoo import load_timm_image_tower, load_timm_state_dict


def make_eval_initializer(cfg: Config
                          ) -> Callable[[VLBiEncoder, int],
                                        Dict[str, torch.Tensor]]:
    """Eval students start like the reference's ``CLIPModel_full(args)``
    eval nets (networks.py:666 via epoch_original.py:164): from a local
    timm checkpoint of the image tower when ``image_pretrained`` is set and
    one exists, from the seeded init otherwise.  -> ``init(eval_model,
    seed) -> state dict`` (the model's own weights are overwritten)."""
    sd = None
    if cfg.image_pretrained:
        sd, path = load_timm_state_dict(cfg.image_encoder)
        if sd is not None:
            print(f"Eval students use pretrained image tower: {path}")

    def init(eval_model: VLBiEncoder, seed: int) -> Dict[str, torch.Tensor]:
        init_bi_encoder(eval_model, seed)
        if sd is not None:
            load_timm_image_tower(eval_model.image_encoder, sd)
        return {k: v.clone() for k, v in eval_model.state_dict().items()}

    return init
