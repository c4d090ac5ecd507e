"""Port parity: the grouped 3x3 conv of ``ops/gconv.py`` against
``multimodal_dataset_distillation_tpu/ops/pallas_gconv.py``.

On the CPU the port's wrappers run their plain versions, so these tests
hold the plain versions against the Pallas kernels (interpret mode) and
the JAX reference, and the autograd Functions' wiring (first and second
order) against JAX's AD of the primitive.  The CUDA kernels themselves run
only on the card: ``tests/test_torch_gconv_cuda.py`` (marker ``cuda``) and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg


def _data(G, cpg, N=2, H=5, seed=0):
    rs = np.random.RandomState(seed)
    c = G * cpg
    x = rs.randn(N, H, H, c).astype(np.float32)
    w = (rs.randn(3, 3, cpg, c) * 0.1).astype(np.float32)
    return x, w


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


@pytest.mark.parametrize("G", [2, 6])
def test_plain_versions_match_pallas_kernels(G):
    """The plain versions against the TPU kernels in interpret mode, at
    the kernels' fast-path shapes (group width 64)."""
    x, w = _data(G, 64)
    y = pg._pallas_spatial(jnp.asarray(x), jnp.asarray(w), groups=G,
                           interpret=True)
    np.testing.assert_allclose(tg.gconv3x3_fwd(_t(x), _t(w), G).numpy(),
                               np.asarray(y), rtol=1e-4, atol=1e-4)
    ybar = np.random.RandomState(2).randn(*y.shape).astype(np.float32)
    dw = pg._pallas_wgrad(jnp.asarray(x), jnp.asarray(ybar), groups=G,
                          interpret=True)
    np.testing.assert_allclose(
        tg.gconv3x3_wgrad(_t(x), _t(ybar), G).numpy(), np.asarray(dw),
        rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("G,cpg,opg", [(2, 8, 8), (3, 8, 4), (4, 4, 16)])
def test_plain_versions_match_jax_reference(G, cpg, opg):
    """Any group count and widths (cpg != opg included)."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 5, G * cpg).astype(np.float32)
    w = (rs.randn(3, 3, cpg, G * opg) * 0.1).astype(np.float32)
    y = pg._ref_spatial(jnp.asarray(x), jnp.asarray(w), groups=G)
    np.testing.assert_allclose(tg.gconv3x3_fwd(_t(x), _t(w), G).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    ybar = rs.randn(*y.shape).astype(np.float32)
    dw = pg._ref_wgrad(jnp.asarray(x), jnp.asarray(ybar), groups=G)
    np.testing.assert_allclose(
        tg.gconv3x3_wgrad(_t(x), _t(ybar), G).numpy(), np.asarray(dw),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        tg.rot_swap(_t(w), G).numpy(), np.asarray(pg._rot_swap(
            jnp.asarray(w), G)))


def _sin_loss_torch(x, w, G):
    return torch.sin(tg.gconv3x3(x, w, G)).sum()


def _sin_loss_jax(G):
    return lambda x, w: jnp.sum(jnp.sin(pg._ref_spatial(x, w, groups=G)))


@pytest.mark.parametrize("G,cpg", [(2, 8), (3, 8)])
def test_first_order_grads_match_jax(G, cpg):
    x, w = _data(G, cpg, N=3)
    gx, gw = jax.grad(_sin_loss_jax(G), argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(w))
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    tx, tw = torch.autograd.grad(_sin_loss_torch(xt, wt, G), (xt, wt))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-5)


def test_double_backward_hvp_matches_jax():
    """Hessian-vector product through GConv3x3's backward (which is built
    from GConv3x3/GConv3x3Wgrad applies) against JAX's jvp-of-grad."""
    G, cpg = 2, 8
    x, w = _data(G, cpg, N=3)
    rs = np.random.RandomState(1)
    dx = rs.randn(*x.shape).astype(np.float32)
    dw = (rs.randn(*w.shape) * 0.1).astype(np.float32)
    f = _sin_loss_jax(G)
    grad = lambda p: jax.grad(lambda q: f(q[0], q[1]))(p)
    _, (hx, hw) = jax.jvp(grad, ((jnp.asarray(x), jnp.asarray(w)),),
                          ((jnp.asarray(dx), jnp.asarray(dw)),))
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    gx, gw = torch.autograd.grad(_sin_loss_torch(xt, wt, G), (xt, wt),
                                 create_graph=True)
    tx, tw = torch.autograd.grad((gx * _t(dx)).sum() + (gw * _t(dw)).sum(),
                                 (xt, wt))
    np.testing.assert_allclose(tx.numpy(), np.asarray(hx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(hw), rtol=1e-4,
                               atol=1e-4)


def test_gradcheck_and_gradgradcheck_float64():
    """Both Functions, to second order, against finite differences."""
    rs = np.random.RandomState(0)
    G, cpg, opg = 2, 2, 3
    x = _t(rs.randn(1, 3, 4, G * cpg), torch.float64, grad=True)
    w = _t(rs.randn(3, 3, cpg, G * opg), torch.float64, grad=True)
    ybar = _t(rs.randn(1, 3, 4, G * opg), torch.float64, grad=True)
    conv = lambda a, b: tg.GConv3x3.apply(a, b, G)
    wgrad = lambda a, b: tg.GConv3x3Wgrad.apply(a, b, G)
    assert torch.autograd.gradcheck(conv, (x, w))
    assert torch.autograd.gradgradcheck(conv, (x, w))
    assert torch.autograd.gradcheck(wgrad, (x, ybar))
    assert torch.autograd.gradgradcheck(wgrad, (x, ybar))


def test_wrappers_validate_inputs():
    x, w = _data(2, 8)
    with pytest.raises(ValueError, match="disagree"):
        tg.gconv3x3_fwd(_t(x), _t(w), 4)
    with pytest.raises(ValueError, match="dtype or device"):
        tg.gconv3x3_fwd(_t(x), _t(w, torch.float64), 2)
    with pytest.raises(ValueError, match="disagree"):
        tg.gconv3x3_wgrad(_t(x), _t(x[:, :4]), 2)
    # neither the CPU nor a card: no kernel and no silent plain version
    xm = torch.empty(x.shape, device="meta")
    wm = torch.empty(w.shape, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tg.gconv3x3_fwd(xm, wm, 2)


@pytest.mark.parametrize("shape,G", [((100, 28, 28, 128), 2),
                                     ((100, 14, 14, 384), 6),
                                     ((100, 7, 7, 384), 6),
                                     ((2, 5, 5, 24), 3)])
def test_wgrad_splits_cover_every_pixel_once(shape, G):
    n, h, w, c = shape
    m = n * h * w
    splits, chunk = tg.wgrad_splits(m, G, c // G, c // G)
    assert chunk % 16 == 0
    assert (splits - 1) * chunk < m <= splits * chunk
    assert splits * G >= 1
