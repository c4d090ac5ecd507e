"""The 8-channel-per-group kernels (``csrc/gconv3x3_narrow.cu``) on the CPU:
the rule that sends NF-RegNet-B1's grouped convs to them, the Python
mirror of their shared memory, their grid plans, and the wrappers' CPU path
and the autograd Functions at those widths against the JAX package's
``gconv3x3`` (which takes its lax reference at odd group counts).  The
kernels themselves run only on the card (``tests/test_torch_gconv_cuda.py``,
marker ``cuda``, and ``chip_smoke.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gconv_narrow.py -q
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

F32, BF16 = torch.float32, torch.bfloat16
# NF-RegNet-B1's stride-1 grouped 3x3 sites at 224^2: (H, C, groups) ->
# count (tests/test_torch_zoo.py::test_nf_regnet_grouped_sites)
REGNET_SITES = {(56, 88, 11): 1, (28, 184, 23): 3, (14, 360, 45): 6,
                (7, 736, 92): 6}
# a ragged pixel count (75, under one tile) and group count (3, one chunk)
RAGGED = (3, 5, 3)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rule_takes_the_narrow_kernels_at_every_nf_regnet_b1_site(dtype):
    """Every grouped site of NF-RegNet-B1, forward (also the dgrad: same
    widths, swapped) and wgrad, in both dtypes."""
    t = torch.zeros(4)
    for h, c, groups in REGNET_SITES:
        assert c == 8 * groups
        assert tg.use_narrow(dtype, 8, 8, h)
        assert not tg.use_tc("fwd", dtype, 8, 8, h)
        assert not tg.use_tf32("fwd", dtype, 8, 8, h)
        for kind in ("fwd", "wgrad"):
            assert tg._route("g", kind, None, dtype, 8, 8, h, t) == "narrow"


def test_rule_keeps_the_64_wide_routes_at_nfnet_l0():
    t = torch.zeros(4)
    for width in (7, 14, 28):
        assert not tg.use_narrow(F32, 64, 64, width)
        assert not tg.use_narrow(BF16, 64, 64, width)
        for kind in ("fwd", "wgrad"):
            assert tg._route("g", kind, None, BF16, 64, 64, width, t) == "tc"
            assert tg._route("g", kind, None, F32, 64, 64, width, t) == "tf32"


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_tc_false_forces_the_generic_kernel_and_tc_true_raises(dtype):
    t = torch.zeros(4)
    for kind in ("fwd", "wgrad"):
        assert tg._route("g", kind, False, dtype, 8, 8, 14, t) == "generic"
        with pytest.raises(ValueError, match="tensor-core kernel takes"):
            tg._route("g", kind, True, dtype, 8, 8, 14, t)


def test_rule_refuses_other_widths_dtypes_and_too_wide_images():
    t = torch.zeros(4)
    for cpg, opg in ((8, 16), (16, 8), (4, 4), (16, 16)):
        assert not tg.use_narrow(F32, cpg, opg, 14)
        assert tg._route("g", "fwd", None, F32, cpg, opg, 14, t) == "generic"
    for dtype in (torch.float16, torch.float64):
        assert not tg.use_narrow(dtype, 8, 8, 14)
    for dtype, widest in ((F32, 295), (BF16, 547)):
        assert tg.use_narrow(dtype, 8, 8, widest)
        assert not tg.use_narrow(dtype, 8, 8, widest + 1)
        need = [tg.narrow_smem_bytes(kind, dtype.itemsize, widest + 1)
                for kind in ("fwd", "wgrad")]
        assert max(need) > tg._SMEM_BLOCK_MAX
        for kind in ("fwd", "wgrad"):
            assert tg._route("g", kind, None, dtype, 8, 8, widest + 1,
                             t) == "generic"


@pytest.mark.parametrize("kind,itemsize,width,nbytes", [
    ("fwd", 2, 56, 72_848), ("fwd", 2, 7, 57_872),
    ("fwd", 4, 56, 102_544), ("fwd", 4, 7, 74_256),
    ("wgrad", 2, 56, 91_280), ("wgrad", 4, 56, 102_416)])
def test_shared_memory_mirror(kind, itemsize, width, nbytes):
    """``smem_bytes`` of gconv3x3_narrow.cu: rows of 64 channels and 16
    bytes of padding (a ring of one tile's halo and the next tile's new
    rows, rounded up to 8; the bf16 forward's output tile or the wgrads'
    two ybar tiles), 2-byte tap masks per pixel, a 16-byte zero row; the
    card holds the mirror against the source's own (chip_smoke.py, phase
    1).  As many blocks as the launch bounds allow fit on an SM at
    NF-RegNet-B1's widest site."""
    assert tg.narrow_smem_bytes(kind, itemsize, width) == nbytes
    per_sm = tg._SMEM_SM // (nbytes + tg._SMEM_RESERVED)
    assert per_sm >= tg._NARROW_BLOCKS_PER_SM[kind, itemsize]
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tg.narrow_tile("dgrad", itemsize)


@pytest.mark.parametrize("groups", [11, 23, 45, 92, 3, 8, 16, 1])
def test_chunks_cover_every_group_once(groups):
    """Blocks across the channels: at most 8 groups each, every group in
    exactly one, sizes that differ by at most one (G = 11 -> 5 and 6, not
    8 and 3)."""
    chunks = tg.narrow_chunk_groups(groups)
    assert len(chunks) == tg.narrow_chunks(groups) == math.ceil(groups / 8)
    assert [g for c in chunks for g in c] == list(range(groups))
    sizes = [len(c) for c in chunks]
    assert max(sizes) <= tg.NARROW_CHUNK
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n,h,groups", [
    (100, 56, 11), (100, 28, 23), (100, 14, 45), (100, 7, 92),
    (128, 56, 11), (104, 7, 92), RAGGED])
@pytest.mark.parametrize("kind", ["fwd", "wgrad"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", [132, 114])
def test_runs_cover_every_pixel_once(n, h, groups, kind, itemsize, sms):
    """Both kernels' runs (``walk_run`` of gconv3x3_narrow.cu): run r covers
    tiles [r * tiles // runs, (r + 1) * tiles // runs), every pixel in
    exactly one tile of one run, no run empty, runs within one tile of
    each other, and no more blocks (runs x chunks) than fit on the card at
    once."""
    m = n * h * h
    tile = tg.narrow_tile(kind, itemsize)
    tiles = math.ceil(m / tile)
    runs = tg.narrow_runs(kind, m, groups, itemsize, h, sms)
    spans = [range(r * tiles // runs, (r + 1) * tiles // runs)
             for r in range(runs)]
    assert [t for span in spans for t in span] == list(range(tiles))
    lengths = [len(span) for span in spans]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    pixels = [p for span in spans for t in span
              for p in range(t * tile, min(m, (t + 1) * tile))]
    assert pixels == list(range(m))
    resident = tg._NARROW_BLOCKS_PER_SM[kind, itemsize] * sms
    assert runs * tg.narrow_chunks(groups) <= max(tg.narrow_chunks(groups),
                                                  resident)


def _sin_loss_jax(groups):
    return lambda x, w: jnp.sum(jnp.sin(pg.gconv3x3(x, w, groups)))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# two of NF-RegNet-B1's sites, cut to two images
CUT = [(2, 7, 92), (2, 14, 45)]


def _inputs(n, h, groups, seed=0):
    rs = np.random.RandomState(seed)
    c = 8 * groups
    x = rs.randn(n, h, h, c).astype(np.float32)
    w = (rs.randn(3, 3, 8, c) / math.sqrt(72)).astype(np.float32)
    ybar = rs.randn(n, h, h, c).astype(np.float32)
    return x, w, ybar


@pytest.mark.parametrize("n,h,groups", CUT)
def test_cpu_wrappers_match_jax_gconv3x3(n, h, groups):
    """The wrappers' CPU path (the plain versions, which are the kernels'
    yardstick on the card): forward, dgrad (forward on rot_swap) and wgrad
    against the JAX primitives; no launch counted."""
    x, w, ybar = _inputs(n, h, groups)
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(torch.from_numpy(x), torch.from_numpy(w),
                           groups).numpy(),
           pg.gconv3x3(jnp.asarray(x), jnp.asarray(w), groups))
    _close(tg.gconv3x3_fwd(torch.from_numpy(ybar),
                           tg.rot_swap(torch.from_numpy(w), groups),
                           groups).numpy(),
           pg.gconv3x3(jnp.asarray(ybar),
                       pg._rot_swap(jnp.asarray(w), groups), groups))
    _close(tg.gconv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(ybar),
                             groups).numpy(),
           pg.gconv3x3_wgrad(jnp.asarray(x), jnp.asarray(ybar), groups))
    assert tg.LAUNCHES == before


@pytest.mark.parametrize("n,h,groups", CUT)
def test_first_order_grads_match_jax_at_8_channels(n, h, groups):
    x, w, _ = _inputs(n, h, groups)
    gx, gw = jax.grad(_sin_loss_jax(groups), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tx, tw = torch.autograd.grad(
        torch.sin(tg.gconv3x3(xt, wt, groups)).sum(), (xt, wt))
    _close(tx.numpy(), gx)
    _close(tw.numpy(), gw)


@pytest.mark.parametrize("n,h,groups", CUT)
def test_double_backward_matches_jax_at_8_channels(n, h, groups):
    """The HVP through GConv3x3's backward (GConv3x3 and GConv3x3Wgrad
    applies, so on the card every conv of it is an 8-channel kernel)
    against JAX's jvp of the gradient."""
    x, w, _ = _inputs(n, h, groups)
    rs = np.random.RandomState(1)
    vx = rs.randn(*x.shape).astype(np.float32)
    vw = (rs.randn(*w.shape) / math.sqrt(72)).astype(np.float32)
    f = _sin_loss_jax(groups)
    _, (hx, hw) = jax.jvp(
        lambda p: jax.grad(lambda q: f(q[0], q[1]))(p),
        ((jnp.asarray(x), jnp.asarray(w)),),
        ((jnp.asarray(vx), jnp.asarray(vw)),))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    gx, gw = torch.autograd.grad(
        torch.sin(tg.gconv3x3(xt, wt, groups)).sum(), (xt, wt),
        create_graph=True)
    tx, tw = torch.autograd.grad(
        (gx * torch.from_numpy(vx)).sum() + (gw * torch.from_numpy(vw)).sum(),
        (xt, wt))
    _close(tx.numpy(), hx)
    _close(tw.numpy(), hw)
