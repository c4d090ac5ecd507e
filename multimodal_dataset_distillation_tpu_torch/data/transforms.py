"""Host-side image transforms (PIL) producing NHWC float32 arrays.

The port's own copy of ``multimodal_dataset_distillation_tpu/data/
transforms.py:24-94``, the reference's torchvision pipelines
(``data/__init__.py:193-227``): train = RandomResizedCrop(bicubic, scale
0.5-1.0) + HFlip + RandAugment(2,5, 10-op list) + CLIP normalization; test
= square bicubic resize + CLIP normalization.

:func:`make_train_transform_native` (``:136-167`` there) is the
``native_decode`` train transform over raw file bytes through the C++
decode pool (:mod:`..native`); :func:`make_train_transform_raw` (``:97-133``
there) the raw crops of ``--device_augment``, whose RandAugment and
normalisation run in the train step (:mod:`..ops.randaugment_device`).
"""

from __future__ import annotations

import io
import math
from typing import Callable, Tuple

import numpy as np
from PIL import Image

from .. import native
from ..ops.randaugment import VL_AUGS, RandomAugment
from ..utils.augrng import get as _rng

# CLIP normalization (data/__init__.py:194-196)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def denormalize(arr: np.ndarray) -> np.ndarray:
    return np.clip((arr * CLIP_STD + CLIP_MEAN) * 255.0, 0, 255)


def sample_crop_params(w: int, h: int,
                       scale: Tuple[float, float] = (0.5, 1.0),
                       ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                       ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop sampling -> (x, y, cw, ch)."""
    area = w * h
    for _ in range(10):
        target = area * _rng().uniform(*scale)
        log_r = _rng().uniform(math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(log_r)
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = _rng().randint(0, w - cw + 1)
            y = _rng().randint(0, h - ch + 1)
            return x, y, cw, ch
    # fallback: center crop at clamped ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(img: Image.Image, size: int,
                        scale: Tuple[float, float] = (0.5, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                        ) -> Image.Image:
    """torchvision RandomResizedCrop semantics (bicubic)."""
    x, y, cw, ch = sample_crop_params(*img.size, scale=scale, ratio=ratio)
    return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))


def _crop_flip(image_size: int, min_scale: float) -> Callable:
    """RandomResizedCrop + HFlip of a PIL image, or of file bytes: JPEG
    bytes through the C++ pool when it is built, anything else (or a
    decode the pool fails) through PIL.  -> uint8 HWC; the crop, then the
    flip, drawn from the per-item stream."""
    scale = (min_scale, 1.0)

    def pil_path(img: Image.Image) -> np.ndarray:
        img = random_resized_crop(img.convert("RGB"), image_size, scale=scale)
        if _rng().random_sample() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return np.asarray(img)

    def crop_flip(data) -> np.ndarray:
        if isinstance(data, Image.Image):
            return pil_path(data)
        if native.get_fastimage() is not None and native.is_jpeg(data):
            dims = native.read_dims(data)
            if dims is not None:
                x, y, cw, ch = sample_crop_params(dims[0], dims[1],
                                                  scale=scale)
                flip = bool(_rng().random_sample() < 0.5)
                out, failed = native.decode_batch(
                    [(data, (x, y, cw, ch), flip)], image_size, n_threads=1)
                if not failed:
                    return out[0]
        return pil_path(Image.open(io.BytesIO(data)))

    return crop_flip


def make_train_transform(image_size: int = 224,
                         min_scale: float = 0.5) -> Callable:
    aug = RandomAugment(2, 5, isPIL=True, augs=VL_AUGS)
    crop_flip = _crop_flip(image_size, min_scale)

    def transform(img: Image.Image) -> np.ndarray:
        return normalize(np.asarray(aug(Image.fromarray(crop_flip(img)))))

    return transform


def make_test_transform(image_size: int = 224) -> Callable:
    def transform(img: Image.Image) -> np.ndarray:
        img = img.convert("RGB")
        img = img.resize((image_size, image_size), Image.BICUBIC)
        return normalize(np.asarray(img))

    return transform


def make_train_transform_native(image_size: int = 224,
                                min_scale: float = 0.5) -> Callable:
    """Train transform over raw file *bytes*: the C++ pool's decode + crop +
    resize + flip (GIL-free, DCT-scaled), then RandAugment + normalize.
    PIL input, a non-JPEG, or a decode the pool fails takes the PIL path
    (:func:`make_train_transform`).  Same sampling distributions as that
    path; bilinear against bicubic resampling is the one difference."""
    transform = make_train_transform(image_size, min_scale)
    transform.accepts_bytes = True
    return transform


def make_train_transform_raw(image_size: int = 224,
                             min_scale: float = 0.5) -> Callable:
    """Crop, resize and flip only, as raw float32 [0, 255] HWC: the train
    transform of ``--device_augment``, where RandAugment and the CLIP
    normalisation run in the train step.  The crop and flip are those of
    :func:`make_train_transform_native`, with the same draws."""
    crop_flip = _crop_flip(image_size, min_scale)

    def transform(data) -> np.ndarray:
        return crop_flip(data).astype(np.float32)

    transform.accepts_bytes = True
    return transform
