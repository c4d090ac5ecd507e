"""ZCA whitening (the reference's kornia ZCA, utils.py:50-105).

The port's own copy of ``multimodal_dataset_distillation_tpu/ops/zca.py``,
on the host in numpy: the fit runs once per run (``--zca``) on at most
2048 images, and the transforms run on the synthetic set at init and in
the eval block's artifacts, never in a step.  Covariance and
eigendecomposition in float64, ``W = U diag((s + eps)^-1/2) U^T`` over the
flattened pixel-channel features, eps 0.1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ZCAWhitening:
    def __init__(self, eps: float = 0.1):
        self.eps = eps
        self.mean: Optional[np.ndarray] = None
        self.whiten: Optional[np.ndarray] = None
        self.dewhiten: Optional[np.ndarray] = None

    def fit(self, images: np.ndarray) -> "ZCAWhitening":
        """images: (N, H, W, C) float."""
        n = images.shape[0]
        flat = images.reshape(n, -1).astype(np.float64)
        self.mean = flat.mean(axis=0)
        x = flat - self.mean
        cov = (x.T @ x) / (n - 1)
        s, u = np.linalg.eigh(cov)
        s = np.maximum(s, 0.0)
        self.whiten = (u * (1.0 / np.sqrt(s + self.eps))) @ u.T
        self.dewhiten = (u * np.sqrt(s + self.eps)) @ u.T
        return self

    def transform(self, images: np.ndarray) -> np.ndarray:
        shape = images.shape
        flat = images.reshape(shape[0], -1).astype(np.float64) - self.mean
        return (flat @ self.whiten).reshape(shape).astype(np.float32)

    def inverse_transform(self, images: np.ndarray) -> np.ndarray:
        shape = images.shape
        flat = images.reshape(shape[0], -1).astype(np.float64)
        return ((flat @ self.dewhiten) + self.mean).reshape(shape).astype(
            np.float32)
