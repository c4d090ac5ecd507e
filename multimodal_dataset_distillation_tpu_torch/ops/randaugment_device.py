"""On-device RandAugment: the 10-op VL suite on the images' device.

The port's own copy of ``multimodal_dataset_distillation_tpu/ops/
randaugment_device.py`` (``:36-233`` there): the same 14 ops with the
reference's level->argument mappings (``transform/randaugment.py:208-265``:
enhance factor = level/10*1.8+0.1, shear = level/10*0.3, translate =
level/10*10 px, rotate = level/10*30 deg, each geometric magnitude with a
random sign; solarize threshold = level/10*256, posterize bits =
max(level/10*4, 1); fill = 128).  Plain PyTorch ops: the JAX module is
plain JAX too.

Images are float32 **[0, 255]** NHWC (before CLIP normalisation).  Every
op takes a batch, a level and a (B,) bool ``negate`` (the sign of a
geometric op's magnitude; the photometric ops ignore it).

Sampling is split from applying, so that a plan drawn elsewhere (the
tests rebuild the JAX package's plan from its key) goes through the same
code: :func:`sample_augment_plan` draws per image and per round ``(op,
apply, negate)`` from a ``torch.Generator`` (RandomAugment.__call__: N ops
with replacement, each applied with probability 0.5), and
:func:`apply_augment_plan` applies each op, batched, to the images that
drew it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

MAX_LEVEL = 10
FILL = 128.0


def _factor(level: float) -> float:
    return (level / MAX_LEVEL) * 1.8 + 0.1


def _blend(a: torch.Tensor, b: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.clamp(b + (a - b) * factor, 0.0, 255.0)


# ---------------------------------------------------------------------------
# photometric ops
# ---------------------------------------------------------------------------

def identity(img, level, negate):
    return img


def autocontrast(img, level, negate):
    """Per-channel min/max rescale (ImageOps.autocontrast, cutoff=0)."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    span = torch.clamp(hi - lo, min=1e-6)
    # a true division, as JAX's (``255.0 / t`` is a reciprocal times 255)
    scale = torch.div(torch.full_like(span, 255.0), span)
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img, level, negate):
    """Per-channel histogram equalisation with PIL's integer step rule:
    ``step = (total - count of the last non-empty bin) // 255``, LUT =
    ``(exclusive cumsum + step // 2) // step``; a channel whose step is 0
    is kept.  Integer arithmetic throughout, over (B*C, 256) bins."""
    b, h, w, c = img.shape
    orig = img.permute(0, 3, 1, 2).reshape(b * c, h * w)
    q = orig.clamp(0, 255).to(torch.int64)   # truncation, as astype(int32)
    hist = torch.zeros(b * c, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, q, torch.ones_like(q))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    step = (h * w - hist.gather(1, last)) // 255
    cum = hist.cumsum(1) - hist
    lut = ((cum + step // 2) // step.clamp(min=1)).clamp(0, 255)
    out = torch.where(step > 0, lut.gather(1, q).to(img.dtype), orig)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def solarize(img, level, negate):
    thresh = (level / MAX_LEVEL) * 256.0
    return torch.where(img >= thresh, 255.0 - img, img)


def posterize(img, level, negate):
    shift = 8 - int(max((level / MAX_LEVEL) * 4.0, 1.0))
    q = img.clamp(0, 255).to(torch.int32)
    return ((q >> shift) << shift).to(img.dtype)


def color(img, level, negate):
    return _blend(img, img.mean(dim=-1, keepdim=True).expand_as(img),
                  _factor(level))


def contrast(img, level, negate):
    """PIL Contrast: blend with the mean of the rounded L-mode image."""
    lum = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    mean = torch.floor(lum + 0.5).mean(dim=(1, 2))[:, None, None, None]
    return _blend(img, mean.expand_as(img), _factor(level))


def brightness(img, level, negate):
    return _blend(img, torch.zeros_like(img), _factor(level))


def sharpness(img, level, negate):
    """PIL Sharpness: blend with the image smoothed by
    [[1,1,1],[1,5,1],[1,1,1]]/13, its border pixels kept from the
    original.  The smoothing is nine shifted products, float32 on every
    device (a cuDNN conv would take TF32)."""
    b, h, w, c = img.shape
    x = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1))
    sm = sum(x[:, :, i:i + h, j:j + w] * ((5.0 if i == j == 1 else 1.0) / 13.0)
             for i in range(3) for j in range(3))
    ii = torch.arange(h, device=img.device)[:, None]
    jj = torch.arange(w, device=img.device)[None, :]
    interior = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
    smoothed = torch.where(interior[..., None], sm.permute(0, 2, 3, 1), img)
    return _blend(img, smoothed, _factor(level))


# ---------------------------------------------------------------------------
# geometric ops: bilinear resample, out-of-range corners filled with 128
# ---------------------------------------------------------------------------

def _affine(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of each image at its ``mat @ [x_out, y_out, 1]`` on
    the ``linspace(-1, 1, n)`` grid (``align_corners=True``), each corner
    out of range taken as 128 before the mix: zero padding of ``img - 128``
    (a fill after the mix, or border padding, is another function)."""
    b, h, w, c = img.shape
    grid = F.affine_grid(mat, [b, c, h, w], align_corners=True)
    out = F.grid_sample((img - FILL).permute(0, 3, 1, 2), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1) + FILL


def _signed(negate: torch.Tensor, mag: float) -> torch.Tensor:
    return torch.where(negate, -mag, mag).to(torch.float32)


def _mat(n: int, device, **entries) -> torch.Tensor:
    """(n, 2, 3) identity affine matrices with ``entries`` (``"ij"`` ->
    (n,) values) set."""
    mat = torch.eye(2, 3, device=device).repeat(n, 1, 1)
    for ij, v in entries.items():
        mat[:, int(ij[0]), int(ij[1])] = v
    return mat


def rotate(img, level, negate):
    th = torch.deg2rad(_signed(negate, (level / MAX_LEVEL) * 30.0))
    cos, sin = torch.cos(th), torch.sin(th)
    return _affine(img, _mat(len(img), img.device, **{
        "00": cos, "01": -sin, "10": sin, "11": cos}))


def shear_x(img, level, negate):
    s = _signed(negate, (level / MAX_LEVEL) * 0.3)
    return _affine(img, _mat(len(img), img.device, **{"01": s}))


def shear_y(img, level, negate):
    s = _signed(negate, (level / MAX_LEVEL) * 0.3)
    return _affine(img, _mat(len(img), img.device, **{"10": s}))


def translate_x(img, level, negate):
    px = _signed(negate, (level / MAX_LEVEL) * 10.0)
    w = img.shape[2]
    return _affine(img, _mat(len(img), img.device,
                             **{"02": 2.0 * px / max(w - 1, 1)}))


def translate_y(img, level, negate):
    px = _signed(negate, (level / MAX_LEVEL) * 10.0)
    h = img.shape[1]
    return _affine(img, _mat(len(img), img.device,
                             **{"12": 2.0 * px / max(h - 1, 1)}))


# the reference train pipeline's 10-op list (data/__init__.py:200-203)
VL_DEVICE_OPS = (identity, autocontrast, equalize, brightness, sharpness,
                 shear_x, shear_y, translate_x, translate_y, rotate)


class AugmentPlan(NamedTuple):
    """Per image (rows) and round (columns): the index into
    :data:`VL_DEVICE_OPS`, whether it applies, and the geometric sign."""

    op: torch.Tensor       # (B, n) int64
    apply: torch.Tensor    # (B, n) bool
    negate: torch.Tensor   # (B, n) bool


def sample_augment_plan(batch: int, n: int,
                        generator: torch.Generator) -> AugmentPlan:
    """Draw a RandomAugment(n, .) plan for ``batch`` images from
    ``generator``, on the generator's device; through a
    :class:`~..parallel.mesh.RowShard`, the whole batch's plan cut to the
    rank's rows."""
    from ..parallel.mesh import rows_of

    dev = generator.device
    shape = (batch, n)

    def ops(size, **kw):
        return torch.randint(0, len(VL_DEVICE_OPS), size, **kw)

    return AugmentPlan(
        rows_of(ops, shape, generator, dev),
        rows_of(torch.rand, shape, generator, dev) < 0.5,
        rows_of(torch.rand, shape, generator, dev) < 0.5)


def apply_augment_plan(images: torch.Tensor, plan: AugmentPlan,
                       m: int = 5) -> torch.Tensor:
    """Apply ``plan`` at level ``m`` to (B, H, W, C) float32 [0, 255]
    images: round by round, each op once on the images that drew it (and
    apply it).  The plan is read to the host once, to group the images."""
    op = torch.where(plan.apply, plan.op, -1).cpu()
    for r in range(op.shape[1]):
        for k, fn in enumerate(VL_DEVICE_OPS):
            rows = (op[:, r] == k).nonzero().flatten()
            if fn is identity or rows.numel() == 0:
                continue
            idx = rows.to(images.device)
            out = fn(images.index_select(0, idx), float(m),
                     plan.negate[:, r].index_select(0, idx))
            images = images.index_copy(0, idx, out)
    return images


def random_augment(images: torch.Tensor, generator: torch.Generator,
                   n: int = 2, m: int = 5) -> torch.Tensor:
    """Batched RandomAugment(n, m) with draws from ``generator``."""
    return apply_augment_plan(
        images, sample_augment_plan(len(images), n, generator), m)
