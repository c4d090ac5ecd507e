"""LR schedules (reference ``utils.py:594-610``), in functional form.

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/
schedules.py``.  The reference mutates ``optimizer.param_groups`` in
place; here each schedule returns the LR for the step or epoch, to be set
on a ``torch.optim`` parameter group by the caller.
"""

from __future__ import annotations

import math


def cosine_lr_schedule(epoch: int, max_epoch: int, init_lr: float,
                       min_lr: float) -> float:
    """utils.py:594-599."""
    return ((init_lr - min_lr) * 0.5
            * (1.0 + math.cos(math.pi * epoch / max_epoch)) + min_lr)


def warmup_lr_schedule(step: int, max_step: int, init_lr: float,
                       max_lr: float) -> float:
    """utils.py:601-605."""
    return min(max_lr, init_lr + (max_lr - init_lr) * step / max(max_step, 1))


def step_lr_schedule(epoch: int, init_lr: float, min_lr: float,
                     decay_rate: float) -> float:
    """utils.py:607-610."""
    return max(min_lr, init_lr * (decay_rate ** epoch))
