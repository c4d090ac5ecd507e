"""The port's towers; re-exports what ``multimodal_dataset_distillation_tpu.
models`` does.  No kernel is built on import (``ops/gconv.py`` builds at
first launch)."""

from .clip_model import VLBiEncoder  # noqa: F401
from .projection import ProjectionHead  # noqa: F401
from .zoo import IMAGE_FEATURE_DIMS, create_image_encoder, get_network  # noqa: F401
