"""The port's utilities; re-exports what ``multimodal_dataset_distillation_tpu.
utils`` does (flat parameter vectors)."""

from .flat import FlatParams, flatten_params, make_unravel  # noqa: F401
