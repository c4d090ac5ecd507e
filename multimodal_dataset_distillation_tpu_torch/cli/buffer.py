"""Expert-trajectory entry point: the caption lookup the distill CLI uses.

Counterpart of ``multimodal_dataset_distillation_tpu/cli/buffer.py:49-62``.
The rest of the buffer CLI (training the experts and saving their
trajectories) comes with a later slice (ROADMAP A, item 14).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import Config
from ..data.textcache import load_or_process_file, textprocess_train
from ..models.bert import TextEncoder


def make_caption_lookup(train_dataset, cfg: Config, cache_dir: str = ".",
                        encoder: Optional[TextEncoder] = None):
    """-> (lookup: captions -> cached CLS embeddings, the train embedding
    cache, the train captions).  The tower is frozen, so the cache is
    exact.  ``encoder`` computes a missing cache (a fresh tower when
    None)."""
    sentences = train_dataset.get_all_captions()
    cache = load_or_process_file(
        "train_text", functools.partial(textprocess_train, encoder=encoder),
        cfg, sentences, cache_dir=cache_dir)
    embed = cache["bert_test_embed"].astype(np.float32)
    index: Dict[str, int] = {}
    for i, s in enumerate(sentences):
        index.setdefault(s, i)

    def lookup(captions: Sequence[str]) -> np.ndarray:
        return embed[[index[c] for c in captions]]

    return lookup, embed, sentences
