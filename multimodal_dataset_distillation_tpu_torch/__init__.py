"""PyTorch / CUDA port of ``multimodal_dataset_distillation_tpu`` for one
NVIDIA H100: the expert phase, distillation and evaluation of
vision-language dataset distillation (bi-trajectory matching, TMLR 2024,
arXiv 2308.07545), with hand-written Hopper kernels for the grouped 3x3
convolutions (``csrc/``, built at first use).

Only :class:`~.config.Config` and ``__version__`` are exported here, so
that importing the package loads neither the towers nor a kernel.
"""

__version__ = "0.1.0"

from .config import Config  # noqa: E402,F401
