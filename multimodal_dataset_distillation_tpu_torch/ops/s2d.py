"""Space-to-depth stem rewrite: an exact-math layout transform.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/s2d.py``.  The
NFNet stems run strided and stride-1 3x3 (or 7x7) convs at 112^2 with
16-64 channels.  In space-to-depth coordinates the images enter as
``space_to_depth(x, f)``, (N, f*f*C, H/f, W/f), and every stem conv
becomes an equivalent conv on that block grid with 4x/16x the channels.
The standardized kernel is rearranged, never re-parameterized, so the
parameters, checkpoints and expert buffers are those of the plain stem.

Derivation (as the JAX module's): an original conv with odd kernel k,
stride s and TF-SAME padding (lo pad ``pl = (k - s) // 2``), whose input
is stored as s2d(fi) blocks and its output as s2d(fo) blocks, ``fi = s *
fo``.  Output phase ``e`` and tap ``i`` read block ``P + u`` at offset
``di`` with ``(u, di) = divmod(s*e + i - pl, fi)``.  Over all (e, i) the
block offsets span ``K = u_max - u_min + 1``, with explicit block padding
``(-u_min, u_max)``; each (phase, tap) lands in one (u, di) slot, so the
rearranged kernel is a zero-padded scatter of the original, built from
``fo*fo`` pads and one stack: a pure layout op under autograd, through
which the distillation meta-gradient flows into the kernel.

Channel order: ``F.pixel_unshuffle``'s, ``c*f*f + di*f + dj`` (the JAX
module is phase-major, ``(di*f + dj)*C + c``); the rearranged kernel's
input and output channels follow the same order, so the output of a conv
with ``fo > 1`` is ``space_to_depth(y, fo)`` of the plain conv's ``y``
and its bias is ``bias.repeat_interleave(fo*fo)``.

The gate is an explicit ``stem_s2d`` argument of the NF towers, set from
``cfg.stem_s2d`` through :func:`configure`, where ``MDD_STEM_S2D`` wins
when it is set (the JAX ``configure``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.env import env_bool


def configure(cfg) -> bool:
    """``cfg.stem_s2d``, with ``MDD_STEM_S2D`` winning when it is set."""
    env = env_bool("MDD_STEM_S2D")
    return bool(getattr(cfg, "stem_s2d", False)) if env is None else env


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """NCHW -> (N, f*f*C, H/f, W/f), channel ``c*f*f + di*f + dj`` (the
    values of ``F.pixel_unshuffle``), channels-last in memory."""
    n, c, h, w = x.shape
    assert h % f == 0 and w % f == 0, (h, w, f)
    y = x.permute(0, 2, 3, 1).reshape(n, h // f, f, w // f, f, c)
    y = y.permute(0, 1, 3, 5, 2, 4).reshape(n, h // f, w // f, c * f * f)
    return y.permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth` (``F.pixel_shuffle``'s values),
    channels-last in memory."""
    n, cc, a, b = x.shape
    c = cc // (f * f)
    y = x.permute(0, 2, 3, 1).reshape(n, a, b, c, f, f)
    y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, a * f, b * f, c)
    return y.permute(0, 3, 1, 2)


def block_geometry(k: int, stride: int, fi: int, fo: int
                   ) -> Tuple[int, int, int]:
    """(K, u_min, u_max) of the block-space kernel for an original (k,
    stride, TF-SAME) conv with s2d(fi) input and s2d(fo) output."""
    assert k % 2 == 1, "odd kernels only"
    assert fi == stride * fo, (fi, stride, fo)
    pl = max(k - stride, 0) // 2
    offs = [stride * e + i - pl for e in range(fo) for i in range(k)]
    u_min = min(o // fi for o in offs)
    u_max = max(o // fi for o in offs)
    return u_max - u_min + 1, u_min, u_max


def rearrange_kernel(w: torch.Tensor, stride: int, fi: int,
                     fo: int) -> torch.Tensor:
    """An original OIHW kernel -> its block-space equivalent, shape
    (fo*fo*Cout, fi*fi*Cin, K, K), channels in the module's order."""
    cout, cin, k, k2 = w.shape
    assert k == k2, "square kernels only"
    big_k, u_min, _ = block_geometry(k, stride, fi, fo)
    pl = max(k - stride, 0) // 2
    span = big_k * fi
    phases = []
    for e in range(fo):
        a_e = stride * e - pl - fi * u_min   # row slot of tap 0
        for f in range(fo):
            a_f = stride * f - pl - fi * u_min
            wef = F.pad(w, (a_f, span - k - a_f, a_e, span - k - a_e))
            # (Cout, Cin, K, fi, K, fi) -> (Cout, Cin, fi, fi, K, K)
            wef = wef.reshape(cout, cin, big_k, fi, big_k, fi)
            wef = wef.permute(0, 1, 3, 5, 2, 4)
            phases.append(wef.reshape(cout, cin * fi * fi, big_k, big_k))
    w2 = torch.stack(phases, dim=1)   # (Cout, fo*fo, fi*fi*Cin, K, K)
    return w2.reshape(cout * fo * fo, cin * fi * fi, big_k, big_k)


def block_padding(k: int, stride: int, fi: int, fo: int) -> Tuple[int, int]:
    """Explicit block-space padding (lo, hi) replicating the TF-SAME pad."""
    _, u_min, u_max = block_geometry(k, stride, fi, fo)
    return (-u_min, u_max)
