"""Differentiable Siamese Augmentation (DSA) on the device.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/diffaug.py`` (the
reference's DiffAugment suite, ``utils.py:362-539``): ``ParamDiffAug``, the
strategy dispatcher (mode ``'S'``: one op family drawn per call; ``'M'``:
every family in turn) and the differentiable ops, scale and rotate (an
affine grid sampled bilinearly), flip, brightness, saturation, contrast,
crop (pad by one, then an integer shift) and cutout.  ``batch_shared`` is
the reference's seeded "batchmode": one transform for the whole batch.

Images are NHWC, as the port's synthetic pixels are
(``engine/distill.py::DistillState.image_syn``).  Every op is
differentiable in the pixels.

Each op is split in two, so that another source of random numbers can
drive it: ``k = OPS[name][0]`` uniforms in [0, 1) per sample (drawn by
:func:`uniforms` from an explicit ``torch.Generator``, or given, such as
the JAX package's own ``_per_batch`` draws) and ``apply_<name>(x, u, p)``,
a function of the pixels and those values ``u`` of shape ``(k, N)``.
``rand_<name>(x, gen, p, batch_shared)`` is the two together.

As in the JAX package and the reference, ``--dsa`` is declared but the
distill path does not call this suite (``PARITY.md:56``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ParamDiffAug:
    """utils.py:362-373 defaults."""

    aug_mode: str = "S"
    prob_flip: float = 0.5
    ratio_scale: float = 1.2
    ratio_rotate: float = 15.0
    ratio_crop_pad: float = 0.125
    ratio_cutout: float = 0.5
    ratio_noise: float = 0.05
    brightness: float = 1.0
    saturation: float = 2.0
    contrast: float = 0.5


def uniforms(k: int, n: int, gen: Optional[torch.Generator],
             batch_shared: bool, device=None) -> torch.Tensor:
    """(k, n) uniforms in [0, 1), drawn on the generator's device and moved
    to ``device``; with ``batch_shared`` one value per row, repeated over
    the batch (utils.py:387-391)."""
    src = gen.device if gen is not None else "cpu"
    u = torch.rand((k, 1 if batch_shared else n), generator=gen, device=src)
    return u.expand(k, n).to(device) if batch_shared else u.to(device)


def _affine_sample(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of NHWC ``x`` on the grid ``theta`` (N, 2, 3) maps
    out of [-1, 1]², corners aligned; samples outside the image are 0."""
    xc = x.permute(0, 3, 1, 2)
    grid = F.affine_grid(theta, list(xc.shape), align_corners=True)
    out = F.grid_sample(xc, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


def _theta(a, b, c, d) -> torch.Tensor:
    zeros = torch.zeros_like(a)
    return torch.stack([torch.stack([a, b, zeros], -1),
                        torch.stack([c, d, zeros], -1)], 1)


def apply_scale(x, u, p: ParamDiffAug):
    """utils.py:413-429: sx, sy ~ U[1/r, r]; theta = diag(sx, sy)."""
    r = p.ratio_scale
    sx = u[0] * (r - 1.0 / r) + 1.0 / r
    sy = u[1] * (r - 1.0 / r) + 1.0 / r
    zeros = torch.zeros_like(sx)
    return _affine_sample(x, _theta(sx, zeros, zeros, sy).to(x.dtype))


def apply_rotate(x, u, p: ParamDiffAug):
    """utils.py:432-443: angle ~ U[-r, r] degrees."""
    ang = (u[0] - 0.5) * 2 * p.ratio_rotate / 180.0 * math.pi
    cos, sin = torch.cos(ang), torch.sin(ang)
    return _affine_sample(x, _theta(cos, -sin, sin, cos).to(x.dtype))


def apply_flip(x, u, p: ParamDiffAug):
    r = u[0][:, None, None, None]
    return torch.where(r < p.prob_flip, x.flip(2), x)


def apply_brightness(x, u, p: ParamDiffAug):
    return x + (u[0][:, None, None, None] - 0.5) * p.brightness


def apply_saturation(x, u, p: ParamDiffAug):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (u[0][:, None, None, None] * p.saturation) + mean


def apply_contrast(x, u, p: ParamDiffAug):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u[0][:, None, None, None] + p.contrast) + mean


def apply_crop(x, u, p: ParamDiffAug):
    """utils.py:489-508: pad by 1, then shift by up to ratio * size."""
    n, h, w, _ = x.shape
    sh = int(h * p.ratio_crop_pad + 0.5)
    sw = int(w * p.ratio_crop_pad + 0.5)
    ty = torch.floor(u[0] * (2 * sh + 1)).long() - sh
    tx = torch.floor(u[1] * (2 * sw + 1)).long() - sw
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dev = x.device
    gy = (torch.arange(h, device=dev)[None, :, None] + ty[:, None, None]
          + 1).clamp(0, h + 1)
    gx = (torch.arange(w, device=dev)[None, None, :] + tx[:, None, None]
          + 1).clamp(0, w + 1)
    return xp[torch.arange(n, device=dev)[:, None, None], gy, gx]


def apply_cutout(x, u, p: ParamDiffAug):
    """utils.py:511-531: zero a ratio-sized box at a random offset."""
    _, h, w, _ = x.shape
    ch = int(h * p.ratio_cutout + 0.5)
    cw = int(w * p.ratio_cutout + 0.5)
    oy = torch.floor(u[0] * (h + (1 - ch % 2))).long()
    ox = torch.floor(u[1] * (w + (1 - cw % 2))).long()
    dev = x.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    y0 = (oy - ch // 2).clamp(0, h)[:, None, None]
    y1 = (oy - ch // 2 + ch).clamp(0, h)[:, None, None]
    x0 = (ox - cw // 2).clamp(0, w)[:, None, None]
    x1 = (ox - cw // 2 + cw).clamp(0, w)[:, None, None]
    box = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return x * (1.0 - box.to(x.dtype))[..., None]


#: op name -> (uniforms per sample, apply function)
OPS: Dict[str, tuple] = {
    "scale": (2, apply_scale),
    "rotate": (1, apply_rotate),
    "flip": (1, apply_flip),
    "brightness": (1, apply_brightness),
    "saturation": (1, apply_saturation),
    "contrast": (1, apply_contrast),
    "crop": (2, apply_crop),
    "cutout": (2, apply_cutout),
}


def _rand(name: str) -> Callable:
    k, apply = OPS[name]

    def op(x, gen: Optional[torch.Generator], p: ParamDiffAug,
           batch_shared: bool):
        return apply(x, uniforms(k, x.shape[0], gen, batch_shared,
                                 x.device), p)

    op.__name__ = f"rand_{name}"
    op.__doc__ = f"``apply_{name}`` on uniforms drawn from ``gen``."
    return op


rand_scale = _rand("scale")
rand_rotate = _rand("rotate")
rand_flip = _rand("flip")
rand_brightness = _rand("brightness")
rand_saturation = _rand("saturation")
rand_contrast = _rand("contrast")
rand_crop = _rand("crop")
rand_cutout = _rand("cutout")

#: strategy family -> its ops, in order (utils.py:533-539)
AUGMENT_FNS: Dict[str, Sequence[str]] = {
    "color": ("brightness", "saturation", "contrast"),
    "crop": ("crop",),
    "cutout": ("cutout",),
    "flip": ("flip",),
    "scale": ("scale",),
    "rotate": ("rotate",),
}


def diff_augment(x: torch.Tensor, strategy: str,
                 gen: Optional[torch.Generator] = None,
                 param: Optional[ParamDiffAug] = None,
                 batch_shared: bool = False) -> torch.Tensor:
    """DiffAugment dispatcher (utils.py:384-409) over NHWC ``x``.

    ``strategy``: underscore-joined family names; ``param.aug_mode`` ``'S'``
    draws one family per call from ``gen``, ``'M'`` applies every family in
    order.  ``batch_shared``: one transform for the whole batch."""
    param = param or ParamDiffAug()
    if not strategy or strategy.lower() == "none":
        return x
    names = strategy.split("_")
    if param.aug_mode == "M":
        families = names
    elif param.aug_mode == "S":
        src = gen.device if gen is not None else "cpu"
        pick = int(torch.randint(len(names), (1,), generator=gen,
                                 device=src))
        families = [names[pick]]
    else:
        raise ValueError(f"unknown aug_mode: {param.aug_mode}")
    for family in families:
        for name in AUGMENT_FNS[family]:
            k, apply = OPS[name]
            x = apply(x, uniforms(k, x.shape[0], gen, batch_shared,
                                  x.device), param)
    return x


# reference-name alias
DiffAugment = diff_augment
