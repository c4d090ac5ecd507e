"""The generic grouped-conv kernels (``csrc/gconv3x3.cu``: ``mma.sync``
tensor cores on 2-D tiles, any group width and image width) on the CPU:
their float32 arithmetic (three TF32 passes) against the JAX package's
Pallas kernels in interpret mode, the Python plans that the kernels follow
(tiles, persistent forward blocks, wgrad splits, shared memory), the route
of every grouped NFNet-L0 site from 224^2 to 576^2, and the slice's path
as a whole: one float32 expert step of a depth-cut NFNet-L0 at 288^2
against the JAX trainer.  The kernels themselves run only on the card
(``tests/test_torch_gconv_cuda.py``, marker ``cuda``, and
``chip_smoke.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gconv_generic.py -q
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import expert as jexpert
from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.engine import expert
from multimodal_dataset_distillation_tpu_torch.models import layers, nfnet, zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)

F32, BF16 = torch.float32, torch.bfloat16
# NFNet-L0's stride-1 grouped 3x3 sites: image size / site width -> count
NFNET_STRIDES = {8: 3, 16: 11, 32: 5}
# the shapes these tests and the card tests give the generic kernels:
# (cpg, opg), the zoo's (64/64 NFNet-L0, 8/8 NF-RegNet-B1) among them
WIDTHS = [(64, 64), (8, 8), (24, 40), (4, 16), (8, 4), (3, 130), (72, 8),
          (16, 16)]


def _data(N, H, W, G, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H, W, G * 64).astype(np.float32)
    w = (rs.randn(3, 3, 64, G * 64) / math.sqrt(9 * 64)).astype(np.float32)
    ybar = rs.randn(N, H, W, G * 64).astype(np.float32)
    return x, w, ybar


# ---------------------------------------------------------------------------
# (a) the float32 arithmetic against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,H,W", [(2, 36, 36), (1, 4, 72)])
def test_three_pass_forward_matches_pallas_spatial(N, H, W):
    """The generic float32 forward's arithmetic (hi*hi + (hi*lo + lo*hi) of
    the TF32 parts) at NFNet-L0's 288^2 stage-1 shape and at a 72-wide one
    (past the TF32 forward's 64) against the Pallas forward in interpret
    mode: 1e-5 of the largest value, as tests/test_torch_gconv_tf32_fwd.py."""
    x, w, _ = _data(N, H, W, 2, seed=W)
    want = np.asarray(pg._pallas_spatial(jnp.asarray(x), jnp.asarray(w),
                                         groups=2, interpret=True))
    got = tg.gconv3x3_fwd_tf32_ref(torch.tensor(x), torch.tensor(w), 2)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_three_pass_wgrad_matches_pallas_wgrad():
    """The generic float32 wgrad's arithmetic at the 288^2 stage-1 shape
    (N=2, 36^2 x 128, G=2: 36 wide, past the TF32 wgrad's 32) against the
    Pallas wgrad in interpret mode, to tests/test_torch_gconv_tf32.py's
    tolerance."""
    x, _, ybar = _data(2, 36, 36, 2, seed=1)
    want = pg._pallas_wgrad(jnp.asarray(x), jnp.asarray(ybar), groups=2,
                            interpret=True)
    got = tg.gconv3x3_wgrad_tf32_ref(torch.tensor(x), torch.tensor(ybar), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("cpg,opg", [(24, 40), (3, 130), (8, 8)])
def test_three_pass_is_float32_accurate_at_other_widths(cpg, opg):
    """At the widths only the generic route takes, against float64: the
    three-pass forward and wgrad miss by no more than twice what plain
    float32 misses (or 2e-6 of the largest value)."""
    rs = np.random.RandomState(cpg)
    G = 3
    x = torch.tensor(rs.randn(2, 9, 7, G * cpg).astype(np.float32))
    w = torch.tensor((rs.randn(3, 3, cpg, G * opg)
                      / math.sqrt(9 * cpg)).astype(np.float32))
    yb = torch.tensor(rs.randn(2, 9, 7, G * opg).astype(np.float32))
    for plain, three, exact in (
            (tg.gconv3x3_ref(x, w, G), tg.gconv3x3_fwd_tf32_ref(x, w, G),
             tg.gconv3x3_ref(x.double(), w.double(), G)),
            (tg.gconv3x3_wgrad_ref(x, yb, G),
             tg.gconv3x3_wgrad_tf32_ref(x, yb, G),
             tg.gconv3x3_wgrad_ref(x.double(), yb.double(), G))):
        scale = float(exact.abs().max())
        err = [float((v.double() - exact).abs().max()) / scale
               for v in (plain, three)]
        assert err[1] <= max(2 * err[0], 2e-6)


# ---------------------------------------------------------------------------
# (b) the plans cover every output pixel once; (c) shared memory
# ---------------------------------------------------------------------------

_PLAN_SHAPES = [
    # odd widths: one past the other routes' limits, and their neighbours
    (2, 3, 33), (2, 3, 65), (2, 4, 243), (1, 3, 322), (3, 5, 548),
    # NFNet-L0's sites at 224^2 and 288^2, NF-RegNet-B1's at 224^2
    (100, 28, 28), (100, 14, 14), (100, 7, 7), (128, 36, 36), (100, 18, 18),
    (104, 9, 9), (100, 56, 56), (100, 72, 72),
    # degenerate images
    (2, 1, 13), (5, 17, 1), (3, 9, 7), (1, 1, 1),
]


def _tile_pixels(n, h, w, tile, t):
    n0, h0, w0 = tg.generic_tile_origin(t, h, w, tile)
    tn, th, tw = tile
    return [(i, r, q) for i in range(n0, min(n, n0 + tn))
            for r in range(h0, min(h, h0 + th))
            for q in range(w0, min(w, w0 + tw))]


@pytest.mark.parametrize("n,h,w", _PLAN_SHAPES)
def test_tiles_cover_every_output_pixel_once(n, h, w):
    """The tile the planner picks fits the kernels' bounds (at most 128
    pixels, 192 halo pixels: the shared memory does not grow with the
    width), and the tiles, in the kernels' order, cover every pixel once."""
    tile = tg.generic_tile(n, h, w)
    tn, th, tw = tile
    assert tg.generic_tile_fits(*tile)
    assert tn == 1 or (th, tw) == (h, w)
    tiles = tg.generic_tiles(n, h, w, tile)
    seen = [p for t in range(tiles) for p in _tile_pixels(n, h, w, tile, t)]
    assert len(seen) == n * h * w
    assert sorted(seen) == [(i, r, q) for i in range(n) for r in range(h)
                            for q in range(w)]


@pytest.mark.parametrize("n,h,w", _PLAN_SHAPES)
@pytest.mark.parametrize("groups,cpg,opg", [(2, 64, 64), (11, 8, 8),
                                            (92, 8, 8), (3, 24, 40)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_forward_walks_and_wgrad_splits_take_every_tile_once(
        n, h, w, groups, cpg, opg, dtype):
    """The forward's persistent blocks (block b walks tiles b, b + blocks,
    ...) take every tile once, evenly, all resident at once; the wgrad's
    splits (split s takes tiles [s T // S, (s + 1) T // S)) take every tile
    once, none empty, about as many blocks as fit on the card."""
    tiles = tg.generic_tiles(n, h, w, tg.generic_tile(n, h, w))
    cols = math.ceil(opg / tg.generic_cols(opg))
    blocks = tg.generic_fwd_blocks(tiles, groups, cpg, opg, dtype)
    walks = [range(b, tiles, blocks) for b in range(blocks)]
    assert sorted(t for walk in walks for t in walk) == list(range(tiles))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert 1 <= blocks * groups * cols <= max(groups * cols,
                                              tg._SMS * 2)
    splits = tg.generic_wgrad_splits(tiles, groups, cpg, opg, dtype)
    spans = [range(s * tiles // splits, (s + 1) * tiles // splits)
             for s in range(splits)]
    assert [t for span in spans for t in span] == list(range(tiles))
    assert all(len(span) > 0 for span in spans)
    stages = math.ceil(cpg * dtype.itemsize / 64)
    assert splits * stages * cols * groups <= max(stages * cols * groups,
                                                  2 * tg._SMS)


@pytest.mark.parametrize("kind", ["fwd", "wgrad"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_shared_memory_fits_two_blocks_at_every_width(kind, dtype):
    """generic_smem_bytes depends on neither the group widths nor the image
    width (it takes no width: the tiles bound the halo), fits a block's
    227 KB, and two blocks fit an SM (the kernels' launch bounds); the
    mirror is ``smem_bytes`` of gconv3x3.cu, which chip_smoke.py's phase 1
    holds it against on the card."""
    sizes = {tg.generic_smem_bytes(kind, dtype, cpg, opg)
             for cpg, opg in WIDTHS}
    assert len(sizes) == 1
    (size,) = sizes
    assert size <= tg._SMEM_BLOCK_MAX
    assert 2 * (size + tg._SMEM_RESERVED) <= tg._SMEM_SM
    size_of = {(F32, "fwd"): 115_200, (BF16, "fwd"): 115_200,
               (F32, "wgrad"): 113_664, (BF16, "wgrad"): 70_656}
    assert size == size_of[dtype, kind]
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tg.generic_smem_bytes("dgrad", dtype, 64, 64)


# ---------------------------------------------------------------------------
# (d) the route of every grouped NFNet-L0 site
# ---------------------------------------------------------------------------

def _nfnet_sites(size, monkeypatch):
    """(cpg, opg, width) of every grouped 3x3 stride-1 site of NFNet-L0 at
    size^2, read off a forward pass on the meta device."""
    sites = []

    def record(x, w, groups):
        sites.append((w.shape[2], w.shape[3] // groups, x.shape[2]))
        return x.new_empty((*x.shape[:3], w.shape[3]))

    monkeypatch.setattr(layers, "gconv3x3", record)
    with torch.device("meta"):
        net = nfnet.NormFreeNet(nfnet.NFNET_L0, gconv=True)
        with torch.no_grad():
            net(torch.empty(1, 3, size, size))
    return sites


@pytest.mark.parametrize("size", [224, 288, 384, 576])
def test_every_nfnet_l0_site_has_a_route(size, monkeypatch):
    """At 224^2, 288^2, 384^2 and 576^2, in both dtypes, the forward, dgrad
    and wgrad of every grouped site take a route without raising: the
    64-wide kernel of the dtype while the image fits its halo, the generic
    one past it and nowhere else (float32 from 288^2 on: the stage-1 wgrads
    at 36 wide; the forwards and dgrads past 64 wide, from 576^2 on)."""
    sites = _nfnet_sites(size, monkeypatch)
    widths = sorted(w for _, _, w in sites)
    want = sorted(w for stride, n in NFNET_STRIDES.items()
                  for w in [size // stride] * n)
    assert widths == want
    t = torch.zeros(4)
    generic = set()
    for cpg, opg, width in sites:
        assert (cpg, opg) == (64, 64)
        for dtype in (F32, BF16):
            for kind, ci, co in (("fwd", cpg, opg), ("fwd", opg, cpg),
                                 ("wgrad", cpg, opg)):
                route = tg._route("site", kind, None, dtype, ci, co, width, t)
                fits = (tg.use_tc(kind, dtype, ci, co, width)
                        or tg.use_tf32(kind, dtype, ci, co, width))
                assert (route == "generic") == (not fits)
                assert route in (("tc", "generic") if dtype == BF16
                                 else ("tf32", "generic"))
                if route == "generic":
                    generic.add((kind, str(dtype)[6:], width))
    expect = {224: set(),
              288: {("wgrad", "float32", 36)},
              384: {("wgrad", "float32", 48)},
              576: {("wgrad", "float32", 72), ("wgrad", "float32", 36),
                    ("fwd", "float32", 72)}}
    assert generic == expect[size]


# ---------------------------------------------------------------------------
# (e) the slice as a whole: one float32 expert step at 288^2
# ---------------------------------------------------------------------------

SIZE, B = 288, 2
HYPER = dict(lr_img=0.05, lr_txt=0.05, momentum=0.9, weight_decay=5e-4)


@pytest.fixture
def cut_nfnet_l0(monkeypatch):
    """NFNet-L0 at its published widths with its depths cut to (1, 1, 1,
    1) and DropPath off, in both packages' zoos, for this test only."""
    jcfg = dataclasses.replace(jnfnet.NFNET_L0, depths=(1, 1, 1, 1),
                               drop_path_rate=0.0)
    cfg = dataclasses.replace(nfnet.NFNET_L0, depths=(1, 1, 1, 1),
                              drop_path_rate=0.0)
    monkeypatch.setattr(jnfnet, "NFNET_L0", jcfg)
    monkeypatch.setitem(zoo._NF, "nfnet", cfg)
    pg.set_enabled(True)
    yield
    pg.set_enabled(False)


def test_float32_expert_step_at_288_matches_jax(cut_nfnet_l0, monkeypatch):
    """One float32 ``BiEncoderTrainer.train_batch`` of the depth-cut
    NFNet-L0 bi-encoder at 288^2, batch 2, against the JAX trainer with
    ``pallas_gconv`` on (its primitive, which lowers to its lax reference
    off the TPU): the same weights (JAX init, skipinit gains lifted off
    zero so every grouped conv shapes the loss, through
    ``models/convert.py``) and the same batch.  Loss and every trained
    parameter at tests/test_torch_nfnet.py's tolerance (2e-4 relative,
    2e-5 absolute).  The port's grouped convs go through the kernel
    wrappers (their plain versions on the CPU); their widths are the
    card's routes: the stage-1 wgrad at 36 wide takes the generic kernel,
    every other call the TF32 ones (forward and dgrad per site, one
    stride-1 grouped site per stage at this depth)."""
    jmodel = JVLBiEncoder(image_encoder_name="nfnet", text_embedding=768,
                          image_embedding=2304, proj_dropout=0.0)
    variables = jexpert.init_bi_encoder(
        jmodel, JConfig(image_encoder="nfnet", image_size=SIZE),
        jax.random.PRNGKey(0))
    rs = np.random.RandomState(7)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    variables = {"params": jax.tree_util.tree_map_with_path(
        lift, variables["params"])}
    images = rs.randn(B, SIZE, SIZE, 3).astype(np.float32)
    texts = rs.randn(B, 768).astype(np.float32)

    model = VLBiEncoder("nfnet", 768, 2304, proj_dropout=0.0, gconv=True,
                        image_size=SIZE)
    for tower in ("image_encoder", "text_projection"):
        getattr(model, tower).load_state_dict(params_from_jax(
            variables["params"][tower], getattr(model, tower)))
    calls = []
    for name in ("gconv3x3_fwd", "gconv3x3_wgrad"):
        raw = getattr(tg, name)

        def counted(a, b, groups, tc=None, raw=raw, name=name):
            calls.append((name, a, b, groups))
            return raw(a, b, groups, tc)
        monkeypatch.setattr(tg, name, counted)

    jtr = jexpert.BiEncoderTrainer(jmodel, variables, seed=0,
                                   compute_dtype="float32", **HYPER)
    jloss, _ = jtr.train_batch(images, texts)
    tr = expert.BiEncoderTrainer(model, seed=0, compute_dtype="float32",
                                 **HYPER)
    loss, _ = tr.train_batch(images, texts)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4)
    want = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    for tower in ("image_encoder", "text_projection"):
        ref = params_from_jax(want[tower], getattr(model, tower))
        for k, v in getattr(model, tower).state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{tower}.{k}")
    # the routes these calls take on the card
    routes = {}
    t = torch.zeros(4)
    for name, a, b, groups in calls:
        kind = "wgrad" if name == "gconv3x3_wgrad" else "fwd"
        cpg = a.shape[-1] // groups
        opg = b.shape[-1] // groups
        route = tg._route(name, kind, None, a.dtype, cpg, opg, a.shape[2], t)
        routes.setdefault((kind, route, a.shape[2]), 0)
        routes[kind, route, a.shape[2]] += 1
    # one stride-1 grouped site per stage at depth 1: 36, 18 and 9 wide
    assert routes == {("fwd", "tf32", 36): 2, ("fwd", "tf32", 18): 2,
                      ("fwd", "tf32", 9): 2, ("wgrad", "generic", 36): 1,
                      ("wgrad", "tf32", 18): 1, ("wgrad", "tf32", 9): 1}
