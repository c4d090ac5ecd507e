"""Merged-tangent convolution for the grad-of-jvp meta-backward.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/fused_jvp.py``.
The forward-HVP backward (``engine/distill.py``, ``fr_bwd="rof"``) takes
the gradient of a directional derivative: the inner loss runs on
forward-mode dual tensors (``torch.autograd.forward_ad``) whose tangents
sit on the student parameters, and a reverse pass differentiates the
loss's tangent.  Under the default conv rule every conv site then runs
three convolutions::

    P  = conv(x,  w)      # primal
    T1 = conv(dx, w)      # activation-tangent term
    T2 = conv(x,  dw)     # weight-tangent term

and the reverse pass doubles each again.  :func:`conv` computes the
share-``x`` pair as ONE convolution with per-group doubled output
channels::

    ym   = conv(x, [w | dw])          # per-group concat along out-ch
    P, Z = split(ym);  dy = Z + conv(dx, w)

which reads ``x`` once in the tangent forward and transposes to one dgrad
and one wgrad on the concatenated cotangent.  Exact: each output channel
of a convolution is the same sum in the same order whatever the other
channels are.

The rule is written with :func:`~torch.autograd.forward_ad.unpack_dual`
and ``make_dual`` around plain ``F.conv2d`` calls, so reverse mode
records it like any other op.  It is a library call: the JAX package
computes it outside any Pallas kernel too.  :func:`activate` scopes it as
the JAX flag does: ``WSConv`` routes to :func:`conv` only while the
distiller runs the inner jvp of the meta-backward, and on an operand
without a weight tangent :func:`conv` is the plain conv.

:func:`has_tangent` is the forward-AD test the towers' normalisations and
softmaxes use to leave their fused ATen ops for plain-op forms while a
tangent rides on their input (``models/layers.py::layer_norm``,
``ops/contrastive.py::log_softmax``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from ..utils.env import env_bool

_ACTIVE = False


def resolve(cfg) -> bool:
    """``cfg.fused_jvp``, with the ``MDD_FUSED_JVP`` override when set."""
    env = env_bool("MDD_FUSED_JVP")
    if env is not None:
        return env
    return bool(getattr(cfg, "fused_jvp", False))


def active() -> bool:
    """True inside an :func:`activate` block that turned the rule on."""
    return _ACTIVE


@contextlib.contextmanager
def activate(on: bool = True):
    """Route ``WSConv`` through :func:`conv` inside the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = bool(on)
    try:
        yield
    finally:
        _ACTIVE = prev


def has_tangent(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a forward-mode tangent at the current dual
    level (False outside one)."""
    return fwAD.unpack_dual(t).tangent is not None


def merge_kernels(w: torch.Tensor, dw: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """Per-group concat of OIHW ``w`` and ``dw`` along the output channels.

    Group ``i``'s output channels are the contiguous slice
    ``[i*opg:(i+1)*opg]``; a plain concat would hand group ``i`` the wrong
    kernel halves, so the concat happens inside each group: the merged
    kernel maps group ``i`` to ``[w_gi | dw_gi]``."""
    out = w.shape[0]
    opg = out // groups
    wm = torch.cat([w.reshape(groups, opg, *w.shape[1:]),
                    dw.reshape(groups, opg, *w.shape[1:])], dim=1)
    return wm.reshape(2 * out, *w.shape[1:])


def split_out(ym: torch.Tensor, groups: int,
              out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Undo :func:`merge_kernels` on an NCHW conv output's channels.  The
    split runs on the NHWC view, so a channels-last ``ym`` gives
    channels-last halves (views when ``groups`` is 1)."""
    n, _, h, w = ym.shape
    opg = out // groups
    t = ym.permute(0, 2, 3, 1).reshape(n, h, w, groups, 2, opg)
    return tuple(t[..., i, :].reshape(n, h, w, out).permute(0, 3, 1, 2)
                 for i in range(2))


def conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
         groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, w, None, stride, padding, groups=groups)`` with the
    merged-tangent forward-mode rule (NCHW x OIHW)."""
    wp, dw = fwAD.unpack_dual(w)
    if dw is None:  # no weight tangent: nothing to merge
        return F.conv2d(x, w, None, stride, padding, 1, groups)
    xp, dx = fwAD.unpack_dual(x)
    ym = F.conv2d(xp, merge_kernels(wp, dw, groups), None, stride, padding,
                  1, groups)
    y, z = split_out(ym, groups, wp.shape[0])
    if dx is not None:  # not the tower's first conv
        z = z + F.conv2d(dx, wp, None, stride, padding, 1, groups)
    return fwAD.make_dual(y, z)
