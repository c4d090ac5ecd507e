"""ROCOv2 radiology expert trainer: :mod:`.buffer` with the ROCO defaults.

Counterpart of the root ``buffer_roco.py`` (the reference's
``Buffer_ROCO_Test.py``; ``--disable_wandb`` honoured, ``:160-168``).

Usage::

  python -m multimodal_dataset_distillation_tpu_torch.cli.buffer_roco \\
      --image_root=/path/to/radiology/images/ \\
      --ann_root=/path/to/radiologytraindata.csv ...
"""

from ..config import Config, parse_config
from .buffer import main

DEFAULTS = Config(dataset="roco", image_encoder="nfnet", disable_wandb=True)

if __name__ == "__main__":
    main(parse_config(defaults=DEFAULTS))
