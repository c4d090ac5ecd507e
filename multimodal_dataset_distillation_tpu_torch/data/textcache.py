"""Text-embedding cache (the reference's ``load_or_process_file``).

The port's own copy of the cache side of ``multimodal_dataset_distillation_
tpu/data/textcache.py`` (reference ``data/__init__.py:153-191`` +
``utils.py:872-893``): the frozen text encoder's outputs over the test
captions live in ``{dataset}_{text_encoder}_text_embed.npz`` (train
captions: ``..._train_text_embed.npz``) under key ``bert_test_embed``, in
the current directory; computed if missing, then loaded.  The file names
are the JAX package's, so a cache it wrote is read here.

The compute side needs the text tower (``models/bert.py``), which is not
ported yet: :func:`textprocess` and :func:`textprocess_train` raise
``NotImplementedError`` naming the file to make with the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from ..config import Config


def cache_name(cfg: Config, file_type: str, cache_dir: str = ".") -> str:
    """Path of the test (``file_type="text"``) or train embedding cache."""
    suffix = "text_embed" if file_type == "text" else "train_text_embed"
    return os.path.join(cache_dir,
                        f"{cfg.dataset}_{cfg.text_encoder}_{suffix}.npz")


def _no_text_tower(fname: str):
    raise NotImplementedError(
        f"{fname} is missing, and the port has no text encoder yet "
        f"(models/bert.py comes with a later slice): write it with the JAX "
        f"package's data/textcache.py, or copy it here")


def textprocess(cfg: Config, testloader, cache_dir: str = ".") -> str:
    """Encode the test-split captions -> npz (needs the text tower)."""
    _no_text_tower(cache_name(cfg, "text", cache_dir))


def textprocess_train(cfg: Config, texts, cache_dir: str = ".") -> str:
    """Encode all train captions -> npz (needs the text tower)."""
    _no_text_tower(cache_name(cfg, "train", cache_dir))


def load_or_process_file(file_type: str, process_fn: Callable, cfg: Config,
                         data_source, cache_dir: str = "."
                         ) -> Dict[str, np.ndarray]:
    """Compute-if-missing cache loader (utils.py:872-893)."""
    fname = cache_name(cfg, file_type, cache_dir)
    if not os.path.exists(fname):
        print(f"Processing {fname}...")
        process_fn(cfg, data_source, cache_dir=cache_dir)
    else:
        print(f"Loading {fname}...")
    with np.load(fname) as f:
        return dict(f)
