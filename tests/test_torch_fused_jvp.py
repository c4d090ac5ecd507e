"""The merged-tangent conv rule (``ops/fused_jvp.py``) against plain
forward mode and against the JAX rule; its scoping and override.

The port of tests/test_fused_jvp.py.  The rule computes the share-x
{primal, weight-tangent} conv pair of the grad-of-jvp meta-backward as one
conv with per-group doubled output channels; the math must be exact, each
output channel of a convolution being computed independently of the
others.  Float64 throughout (``jax.enable_x64()`` on the JAX side, as the
JAX test runs): 1e-12 for the rule, 1e-10 for a reverse pass over it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from multimodal_dataset_distillation_tpu.ops import fused_jvp as jfused
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.models.layers import (
    WSConv,
    tf_same_pad,
)
from multimodal_dataset_distillation_tpu_torch.ops import fused_jvp
from test_torch_threads import share_cores  # noqa: F401 (autouse)

# (groups, stride, kernel, in channels, out channels, image size)
CASES = [(1, 1, 1, 8, 16, 8),     # 1x1 "matmul" conv
         (1, 2, 3, 8, 16, 8),     # dense strided (stem-like)
         (4, 1, 3, 8, 16, 8),     # grouped 3x3 (NF bottleneck form)
         (2, 2, 3, 16, 8, 9),     # grouped strided, odd size, narrowing
         (8, 1, 3, 64, 64, 5),    # 8 channels per group (NF-RegNet-B1)
         (1, 4, 4, 3, 12, 12)]    # ConvNeXt-like patchify stem


def _operands(groups, inch, outch, kern, size, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, inch, size, size)
    w = rs.randn(outch, inch // groups, kern, kern)
    return x, w, rs.randn(*x.shape), rs.randn(*w.shape)


def _conv(conv, stride, groups, kern):
    return lambda x, w: conv(tf_same_pad(x, kern, stride), w, stride=stride,
                             groups=groups)


def _jvp(fn, x, w, dx, dw):
    """(y, ydot) of ``fn`` under dual tensors; ``dx`` None: no tangent."""
    with fwAD.dual_level():
        xd = x if dx is None else fwAD.make_dual(x, dx)
        out = fwAD.unpack_dual(fn(xd, fwAD.make_dual(w, dw)))
    return out.primal, out.tangent


@pytest.mark.parametrize("groups,stride,kern,inch,outch,size", CASES)
def test_rule_matches_plain_forward_mode(groups, stride, kern, inch, outch,
                                         size):
    """(y, dy) of the merged rule == forward mode through plain
    ``F.conv2d``, with both tangents and with the weight's alone (the
    tower's first conv)."""
    x, w, dx, dw = map(torch.as_tensor,
                       _operands(groups, inch, outch, kern, size))
    fused = _conv(fused_jvp.conv, stride, groups, kern)
    plain = _conv(F.conv2d, stride, groups, kern)
    for xdot in (dx, None):
        for a, b in zip(_jvp(fused, x, w, xdot, dw),
                        _jvp(plain, x, w, xdot, dw)):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("groups,stride,kern,inch,outch,size", CASES)
def test_rule_matches_jax(groups, stride, kern, inch, outch, size):
    """The port's rule against ``jax.jvp`` of the JAX ``fused_jvp.conv`` on
    the same seeded inputs (NCHW/OIHW here, NHWC/HWIO there), and the
    port's merged kernel against the JAX one: the concat inside each
    group."""
    x, w, dx, dw = _operands(groups, inch, outch, kern, size)
    nhwc, hwio = (0, 2, 3, 1), (2, 3, 1, 0)
    with jax.enable_x64():
        jconv = functools.partial(jfused.conv, strides=(stride, stride),
                                  padding="SAME", groups=groups)
        jy, jdy = jax.jvp(jconv, (jnp.asarray(x.transpose(nhwc)),
                                  jnp.asarray(w.transpose(hwio))),
                          (jnp.asarray(dx.transpose(nhwc)),
                           jnp.asarray(dw.transpose(hwio))))
        jm = jfused._merge_kernels(jnp.asarray(w.transpose(hwio)),
                                   jnp.asarray(dw.transpose(hwio)), groups)
    y, dy = _jvp(_conv(fused_jvp.conv, stride, groups, kern),
                 *map(torch.as_tensor, (x, w, dx, dw)))
    for got, want in ((y, jy), (dy, jdy)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-12, atol=1e-12)
    merged = fused_jvp.merge_kernels(torch.as_tensor(w), torch.as_tensor(dw),
                                     groups)
    np.testing.assert_array_equal(merged.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jm))


def test_split_out_inverts_merge():
    """The conv over the merged kernel splits into the two convs, in a
    channels-last layout for a channels-last input."""
    x, w, _, dw = map(torch.as_tensor, _operands(4, 16, 8, 3, 6))
    x = x.contiguous(memory_format=torch.channels_last)
    ym = F.conv2d(x, fused_jvp.merge_kernels(w, dw, 4), padding=1, groups=4)
    y, z = fused_jvp.split_out(ym, 4, 8)
    torch.testing.assert_close(y, F.conv2d(x, w, padding=1, groups=4))
    torch.testing.assert_close(z, F.conv2d(x, dw, padding=1, groups=4))
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_grad_of_jvp_two_layer():
    """The composition the engine uses (``fr_bwd="rof"``): a reverse pass
    over the dual-tensor jvp, through a dense strided conv and a grouped
    one with a nonlinearity between; 1e-10."""
    rs = np.random.RandomState(1)
    x, w1, w2, v1, v2 = (torch.as_tensor(rs.randn(*s)) for s in (
        (2, 8, 8, 8), (16, 8, 3, 3), (16, 4, 3, 3), (16, 8, 3, 3),
        (16, 4, 3, 3)))

    def grad_of_jvp(conv):
        cs, cg = _conv(conv, 2, 1, 3), _conv(conv, 1, 4, 3)
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        with fwAD.dual_level():
            h = torch.tanh(cs(leaves[0], fwAD.make_dual(leaves[1], v1)))
            h = torch.tanh(cg(h, fwAD.make_dual(leaves[2], v2)))
            dh = fwAD.unpack_dual((h * h).sum()).tangent
        return torch.autograd.grad(dh, leaves)

    for a, b, name in zip(grad_of_jvp(fused_jvp.conv),
                          grad_of_jvp(F.conv2d), ("x", "w1", "w2")):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def test_wsconv_routing():
    """WSConv takes the merged rule only while active, and the kernel
    route of a grouped 3x3 ahead of it (the JAX routing order); outside a
    dual level the rule is the plain conv."""
    calls = []
    orig = fused_jvp.conv

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    torch.manual_seed(0)
    dense = WSConv(8, 16, 3, stride=2).double()
    grouped = WSConv(16, 16, 3, groups=2, gconv=True).double()
    for m in (dense, grouped):
        torch.nn.init.normal_(m.weight)
    x = torch.randn(2, 8, 8, 8, dtype=torch.float64)
    want = grouped(dense(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_jvp, "conv", spy)
        with fused_jvp.activate(True):
            got = grouped(dense(x))
    assert len(calls) == 1   # the dense conv; the grouped one is the kernel's
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_activate_scoping():
    assert not fused_jvp.active()
    with fused_jvp.activate(True):
        assert fused_jvp.active()
        with fused_jvp.activate(False):
            assert not fused_jvp.active()
        assert fused_jvp.active()
    assert not fused_jvp.active()


def test_resolve_env_override(monkeypatch):
    monkeypatch.delenv("MDD_FUSED_JVP", raising=False)
    assert fused_jvp.resolve(Config())          # default on, as in JAX
    assert not fused_jvp.resolve(Config(fused_jvp=False))
    assert fused_jvp.resolve(Config(fused_jvp=True))
    monkeypatch.setenv("MDD_FUSED_JVP", "0")
    assert not fused_jvp.resolve(Config(fused_jvp=True))
    monkeypatch.setenv("MDD_FUSED_JVP", "1")
    assert fused_jvp.resolve(Config(fused_jvp=False))
