"""RandAugment (host-side, PIL-parity) for the input pipeline.

The port's own copy of ``multimodal_dataset_distillation_tpu/ops/randaugment.py``.

Replaces the reference's cv2/numpy reimplementation
(``transform/randaugment.py:6-334``), which itself targets PIL-op parity.
We implement directly against PIL (ImageOps/ImageEnhance/affine), which is
PIL-parity by construction, with the reference's level->argument mappings
(``transform/randaugment.py:208-265``: enhance = level/10*1.8+0.1,
shear = level/10*0.3 w/ random sign, translate = level/10*10 px w/ random
sign, rotate = level/10*30 deg w/ random sign, solarize = level/10*256,
posterize = level/10*4, fill value (128,128,128)) and its sampling rule
(``RandomAugment.__call__``: sample N ops with replacement, each applied
with prob 0.5 at level M).

The training pipeline instantiates ``RandomAugment(2, 5, augs=[...10 ops])``
(``data/__init__.py:200-203``).  Every draw comes from
:func:`..utils.augrng.get` (the per-item RandomState a seeded loader
installs, else the global numpy stream).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from ..utils.augrng import get as _rng

MAX_LEVEL = 10
TRANSLATE_CONST = 10
FILL = (128, 128, 128)


def _to_pil(img) -> Image.Image:
    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def _identity(img, level):
    return img


def _autocontrast(img, level):
    return ImageOps.autocontrast(img, cutoff=0)


def _equalize(img, level):
    return ImageOps.equalize(img)


def _rotate(img, level):
    deg = (level / MAX_LEVEL) * 30
    if _rng().random_sample() < 0.5:
        deg = -deg
    return img.rotate(-deg, resample=Image.BILINEAR, fillcolor=FILL)


def _solarize(img, level):
    thresh = int((level / MAX_LEVEL) * 256)
    return ImageOps.solarize(img, threshold=thresh)


def _posterize(img, level):
    bits = max(int((level / MAX_LEVEL) * 4), 1)
    return ImageOps.posterize(img, bits)


def _enhance(cls):
    def fn(img, level):
        factor = (level / MAX_LEVEL) * 1.8 + 0.1
        return cls(img).enhance(factor)
    return fn


def _shear(axis: int):
    def fn(img, level):
        s = (level / MAX_LEVEL) * 0.3
        if _rng().random_sample() > 0.5:
            s = -s
        mat = (1, s, 0, 0, 1, 0) if axis == 0 else (1, 0, 0, s, 1, 0)
        return img.transform(img.size, Image.AFFINE, mat,
                             resample=Image.BILINEAR, fillcolor=FILL)
    return fn


def _translate(axis: int):
    def fn(img, level):
        t = (level / MAX_LEVEL) * float(TRANSLATE_CONST)
        if _rng().random_sample() > 0.5:
            t = -t
        mat = (1, 0, t, 0, 1, 0) if axis == 0 else (1, 0, 0, 0, 1, t)
        return img.transform(img.size, Image.AFFINE, mat,
                             resample=Image.BILINEAR, fillcolor=FILL)
    return fn


def _cutout(img, level):
    pad = int((level / MAX_LEVEL) * 40) // 2
    if pad == 0:
        return img
    arr = np.array(img)
    h, w = arr.shape[:2]
    ch, cw = _rng().randint(h), _rng().randint(w)
    x1, x2 = max(ch - pad, 0), min(ch + pad, h)
    y1, y2 = max(cw - pad, 0), min(cw + pad, w)
    arr[x1:x2, y1:y2] = FILL
    return Image.fromarray(arr)


OPS = {
    "Identity": _identity,
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Rotate": _rotate,
    "Solarize": _solarize,
    "Color": _enhance(ImageEnhance.Color),
    "Contrast": _enhance(ImageEnhance.Contrast),
    "Brightness": _enhance(ImageEnhance.Brightness),
    "Sharpness": _enhance(ImageEnhance.Sharpness),
    "ShearX": _shear(0),
    "ShearY": _shear(1),
    "TranslateX": _translate(0),
    "TranslateY": _translate(1),
    "Posterize": _posterize,
    "Cutout": _cutout,
}

# the 10-op list used on the VL training path (data/__init__.py:200-203)
VL_AUGS = ["Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
           "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate"]


class RandomAugment:
    def __init__(self, N: int = 2, M: int = 10, isPIL: bool = False,
                 augs: Optional[Sequence[str]] = None):
        self.N = N
        self.M = M
        self.isPIL = isPIL
        self.augs = list(augs) if augs else list(OPS.keys())

    def get_random_ops(self) -> List[tuple]:
        sampled = _rng().choice(self.augs, self.N)
        return [(op, 0.5, self.M) for op in sampled]

    def __call__(self, img):
        pil = _to_pil(img)
        for name, prob, level in self.get_random_ops():
            if _rng().random_sample() > prob:
                continue
            pil = OPS[name](pil, level)
        return pil if self.isPIL else np.asarray(pil)
