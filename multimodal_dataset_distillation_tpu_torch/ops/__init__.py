"""The port's ops; re-exports what ``multimodal_dataset_distillation_tpu.ops``
does (the contrastive loss)."""

from .contrastive import (  # noqa: F401
    FIXED_LOGIT_SCALE,
    RAW_LOG_SCALE,
    contrastive_loss_and_acc,
    info_nce,
    l2_normalize,
)
