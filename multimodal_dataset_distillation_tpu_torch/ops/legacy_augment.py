"""Non-differentiable DC augmentation (reference ``utils.py:255-335``).

The port's own copy of ``multimodal_dataset_distillation_tpu/ops/
legacy_augment.py``: the same numpy draws give the same images.
``augment``: per image, one of crop / scale / rotate / noise drawn at
random (the DatasetCondensation legacy path, for models with BatchNorm
under evaluation; ``get_daparam``).  Host-side numpy over NHWC; the
differentiable Siamese suite is :mod:`~.diffaug`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def get_daparam(dataset: str, model: str, model_eval: str,
                ipc: int) -> Dict[str, object]:
    """utils.py:318-335 (values preserved)."""
    p: Dict[str, object] = {"crop": 4, "scale": 0.2, "rotate": 45,
                            "noise": 0.001, "strategy": "none"}
    if dataset == "MNIST":
        p["strategy"] = "crop_scale_rotate"
    if model_eval in ("ConvNetBN",):
        p["strategy"] = "crop_noise"
    return p


def _crop(img: np.ndarray, pad: int, mean: np.ndarray,
          rng: np.random.RandomState) -> np.ndarray:
    h, w, c = img.shape
    canvas = np.broadcast_to(mean, (h + 2 * pad, w + 2 * pad, c)).copy()
    canvas[pad:pad + h, pad:pad + w] = img
    r = rng.permutation(pad * 2)[0]
    s = rng.permutation(pad * 2)[0]
    return canvas[r:r + h, s:s + w]


def _scale(img: np.ndarray, ratio: float,
           rng: np.random.RandomState) -> np.ndarray:
    h0, w0, c = img.shape
    h = int(rng.uniform(1 - ratio, 1 + ratio) * h0)
    w = int(rng.uniform(1 - ratio, 1 + ratio) * h0)
    # nearest-neighbor resize (host path; parity-level fidelity)
    yi = (np.arange(h) * h0 / h).astype(int)
    xi = (np.arange(w) * w0 / w).astype(int)
    tmp = img[yi][:, xi]
    m = max(h, w, h0, w0)
    canvas = np.zeros((m, m, c), img.dtype)
    r, s = (m - h) // 2, (m - w) // 2
    canvas[r:r + h, s:s + w] = tmp
    r, s = (m - h0) // 2, (m - w0) // 2
    return canvas[r:r + h0, s:s + w0]


def _rotate(img: np.ndarray, max_deg: int, mean: float,
            rng: np.random.RandomState) -> np.ndarray:
    from scipy.ndimage import rotate as scipyrotate

    h0, w0, _ = img.shape
    out = scipyrotate(img, angle=int(rng.randint(-max_deg, max_deg)),
                      axes=(0, 1), cval=mean)
    r = (out.shape[0] - h0) // 2
    s = (out.shape[1] - w0) // 2
    return out[r:r + h0, s:s + w0].astype(img.dtype)


def augment(images: np.ndarray, dc_aug_param: Optional[Dict],
            rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Randomly apply one augmentation per image (utils.py:255-315).

    images: (N, H, W, C) float numpy; returns a new array.
    """
    if dc_aug_param is None or dc_aug_param.get("strategy", "none") == "none":
        return images
    rng = rng or np.random.RandomState()
    images = np.array(images)
    mean = images.mean(axis=(0, 1, 2))
    augs = str(dc_aug_param["strategy"]).split("_")
    for i in range(images.shape[0]):
        choice = rng.permutation(augs)[0]
        if choice == "crop":
            images[i] = _crop(images[i], int(dc_aug_param["crop"]), mean, rng)
        elif choice == "scale":
            images[i] = _scale(images[i], float(dc_aug_param["scale"]), rng)
        elif choice == "rotate":
            images[i] = _rotate(images[i], int(dc_aug_param["rotate"]),
                                float(mean.mean()), rng)
        elif choice == "noise":
            images[i] = images[i] + (float(dc_aug_param["noise"])
                                     * rng.randn(*images[i].shape))
    return images
