"""ProjectionHead: the trainable text pathway.

Counterpart of ``multimodal_dataset_distillation_tpu/models/projection.py``
(reference ``networks.py:625-646``): Linear(emb -> proj) -> exact GELU ->
Linear(proj -> proj) -> Dropout -> + first projection -> LayerNorm
(eps 1e-5).  Parameter order: projection, fc, layer_norm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dropout, layer_norm


class ProjectionHead(nn.Module):
    def __init__(self, embedding_dim: int, projection_dim: int = 768,
                 dropout: float = 0.1):
        super().__init__()
        self.projection = nn.Linear(embedding_dim, projection_dim)
        self.fc = nn.Linear(projection_dim, projection_dim)
        self.layer_norm = nn.LayerNorm(projection_dim, eps=1e-5)
        self.rate = dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        projected = self.projection(x)
        h = self.fc(F.gelu(projected))
        if train:
            h = dropout(h, self.rate, generator)
        return layer_norm(h + projected, self.layer_norm)
