"""One parser for the ``MDD_*`` boolean environment overrides.

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/env.py``:
unset or empty means no override; ``0``/``false``/``no``/``off`` in any
case mean False; anything else means True.
"""

from __future__ import annotations

import os
from typing import Optional

_FALSY = {"0", "false", "no", "off"}


def env_bool(name: str) -> Optional[bool]:
    """None when ``name`` is unset or empty, else its boolean value."""
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v.strip().lower() not in _FALSY
