"""Text-embedding precompute and cache (textprocess / textprocess_train).

The port's own copy of ``multimodal_dataset_distillation_tpu/data/
textcache.py`` (reference ``data/__init__.py:153-191`` +
``utils.py:872-893``): the frozen text encoder's CLS outputs over the test
captions live in ``{dataset}_{text_encoder}_text_embed.npz`` (train
captions: ``..._train_text_embed.npz``) under key ``bert_test_embed``, in
the current directory; computed if missing, then loaded.  The file names
(``flickr_clip_text_embed.npz`` for the CLIP tower) and key are the JAX
package's, so a cache written by either package is read by the other.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from ..config import Config
from ..models.bert import TextEncoder
from ..models.clip_text import ClipTextEncoder


def cache_name(cfg: Config, file_type: str, cache_dir: str = ".") -> str:
    """Path of the test (``file_type="text"``) or train embedding cache."""
    suffix = "text_embed" if file_type == "text" else "train_text_embed"
    return os.path.join(cache_dir,
                        f"{cfg.dataset}_{cfg.text_encoder}_{suffix}.npz")


def make_text_encoder(cfg: Config) -> Union[TextEncoder, ClipTextEncoder]:
    """The frozen text tower on ``cfg.device`` (networks.py:693-737): BERT
    or CLIP, base or tiny."""
    kw = dict(variant=cfg.text_encoder_config, pretrained=cfg.text_pretrained,
              seed=cfg.seed, device=cfg.device)
    if cfg.text_encoder == "bert":
        return TextEncoder(**kw)
    if cfg.text_encoder == "clip":
        return ClipTextEncoder(**kw)
    raise NotImplementedError(f"Unsupported text encoder: {cfg.text_encoder}")


def textprocess(cfg: Config, testloader,
                encoder: Optional[TextEncoder] = None,
                cache_dir: str = ".") -> str:
    """Encode the test-split captions -> npz; returns the file name."""
    encoder = encoder or make_text_encoder(cfg)
    embed = encoder.encode(testloader.dataset.text, chunk_size=1000)
    fname = cache_name(cfg, "text", cache_dir)
    np.savez(fname, bert_test_embed=embed)
    return fname


def textprocess_train(cfg: Config, texts: Sequence[str],
                      encoder: Optional[TextEncoder] = None,
                      cache_dir: str = ".") -> str:
    """Encode all train captions -> npz; returns the file name."""
    encoder = encoder or make_text_encoder(cfg)
    embed = encoder.encode(list(texts), chunk_size=2000)
    fname = cache_name(cfg, "train", cache_dir)
    np.savez(fname, bert_test_embed=embed)
    return fname


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
