"""Port parity: the grouped 3x3 conv of ``ops/gconv.py`` against
``multimodal_dataset_distillation_tpu/ops/pallas_gconv.py``.

On the CPU the port's wrappers run their plain versions, so these tests
hold the plain versions against the Pallas kernels (interpret mode) and
the JAX reference, and the autograd Functions' wiring (first and second
order) against JAX's AD of the primitive.  The CUDA kernels themselves run
only on the card: ``tests/test_torch_gconv_cuda.py`` (marker ``cuda``) and
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)


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
    """The generic wgrad's splits (split s sums tiles [s * T // S, (s + 1)
    * T // S)) take every tile once, none empty, and the tiles every pixel
    once."""
    n, h, w, c = shape
    tile = tg.generic_tile(n, h, w)
    tiles = tg.generic_tiles(n, h, w, tile)
    for dtype in (torch.float32, torch.bfloat16):
        splits = tg.generic_wgrad_splits(tiles, G, c // G, c // G, dtype)
        spans = [range(s * tiles // splits, (s + 1) * tiles // splits)
                 for s in range(splits)]
        assert [t for span in spans for t in span] == list(range(tiles))
        assert all(len(span) > 0 for span in spans)
    tn, th, tw = tile
    seen = [(i, r, q) for t in range(tiles)
            for n0, h0, w0 in [tg.generic_tile_origin(t, h, w, tile)]
            for i in range(n0, min(n, n0 + tn))
            for r in range(h0, min(h, h0 + th))
            for q in range(w0, min(w, w0 + tw))]
    assert sorted(seen) == [(i, r, q) for i in range(n) for r in range(h)
                            for q in range(w)]


def test_dispatch_rule_picks_by_dtype_and_shape():
    """bfloat16 with 64 input and 64 output channels per group takes the
    tensor-core kernels; float32, other widths and other dtypes the
    generic ones; images too wide for the halo tiles' shared memory too."""
    for kind in ("fwd", "wgrad"):
        assert tg.use_tc(kind, torch.bfloat16, 64, 64, 28)
        assert tg.use_tc(kind, torch.bfloat16, 64, 64, 1)
        assert not tg.use_tc(kind, torch.float32, 64, 64, 28)
        assert not tg.use_tc(kind, torch.float16, 64, 64, 28)
        assert not tg.use_tc(kind, torch.bfloat16, 32, 64, 28)
        assert not tg.use_tc(kind, torch.bfloat16, 64, 128, 28)
        widest = max(w for w in range(1, 2048)
                     if tg.use_tc(kind, torch.bfloat16, 64, 64, w))
        assert (tg.tc_smem_bytes(kind, widest) <= tg._SMEM_BLOCK_MAX
                < tg.tc_smem_bytes(kind, widest + 1))
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tg.tc_smem_bytes("dgrad", 7)


def test_every_nfnet_l0_grouped_site_takes_the_tensor_core_route():
    """NFNet-L0 at 224^2: the 19 grouped 3x3 stride-1 sites (3 at 28^2, 11
    at 14^2, 5 at 7^2), all at 64 channels per group in and out, so in
    bfloat16 every conv, dgrad (same widths, swapped) and wgrad of the main
    path is on the tensor-core kernels."""
    from multimodal_dataset_distillation_tpu_torch.models.layers import WSConv
    from multimodal_dataset_distillation_tpu_torch.models.nfnet import (
        NFNET_L0, NormFreeNet)
    net = NormFreeNet(NFNET_L0, gconv=True)
    sites = []

    def record(mod, inp):
        sites.append((mod.weight.shape[1], mod.weight.shape[0] // mod.groups,
                      inp[0].shape[-1]))

    for mod in net.modules():
        if isinstance(mod, WSConv) and mod.use_gconv:
            mod.register_forward_pre_hook(record)
    with torch.no_grad():
        net(torch.zeros(1, 3, 224, 224))
    assert sorted(w for _, _, w in sites) == [7] * 5 + [14] * 11 + [28] * 3
    for cpg, opg, width in sites:
        for kind in ("fwd", "wgrad"):
            assert tg.use_tc(kind, torch.bfloat16, cpg, opg, width)
            assert tg.use_tc(kind, torch.bfloat16, opg, cpg, width)


@pytest.mark.parametrize("shape,G", [((100, 28, 28, 128), 2),
                                     ((100, 14, 14, 384), 6),
                                     ((100, 7, 7, 384), 6),
                                     ((3, 9, 5, 128), 2),
                                     ((11, 7, 7, 384), 6),
                                     ((1, 30, 31, 128), 2)])
@pytest.mark.parametrize("sms", [132, 114])
def test_tc_plans_cover_every_pixel_once(shape, G, sms):
    """The tensor-core kernels' grids: the forward's persistent blocks walk
    every 128-pixel tile exactly once, evenly and all resident at once;
    the wgrad's splits cover every tile exactly once, about one block per
    SM."""
    n, h, w, _ = shape
    m = n * h * w
    tiles = math.ceil(m / tg.TC_TILE)
    blocks = tg.fwd_tc_blocks(m, G, tg.tc_smem_bytes("fwd", w),
                              tg._FWD_TC_BLOCKS_PER_SM, sms)
    walks = [range(b, tiles, blocks) for b in range(blocks)]
    assert sorted(t for walk in walks for t in walk) == list(range(tiles))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert 1 <= blocks * G <= max(G, sms * tg._FWD_TC_BLOCKS_PER_SM)
    splits, per = tg.wgrad_tc_splits(m, G, sms)
    spans = [range(s * per, min(tiles, (s + 1) * per)) for s in range(splits)]
    assert [t for span in spans for t in span] == list(range(tiles))
    assert all(len(span) > 0 for span in spans)
    assert splits * G <= max(G, sms)
    assert sum(min(m, tg.TC_TILE * span.stop) - tg.TC_TILE * span.start
               for span in spans) == m


def test_cpu_wrappers_take_the_plain_version_on_either_route():
    """On the CPU the route argument is moot: both give the plain
    version's result, and no kernel is counted."""
    x, w = _data(2, 64, N=1, H=3)
    before = dict(tg.LAUNCHES)
    ref = tg.gconv3x3_ref(_t(x), _t(w), 2)
    for tc in (None, True, False):
        np.testing.assert_array_equal(
            tg.gconv3x3_fwd(_t(x), _t(w), 2, tc=tc).numpy(), ref.numpy())
    assert tg.LAUNCHES == before
