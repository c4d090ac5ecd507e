"""The float32 tensor-core weight gradient (``csrc/gconv3x3_tf32.cu``) on
the CPU: its dispatch rule, the Python mirror of its shared memory, its
split plan, and its arithmetic (three TF32 passes, hi*hi + hi*lo + lo*hi)
emulated in PyTorch with :func:`tf32_split` against the JAX package's
Pallas wgrad and against float64.  The kernel itself runs only on the card
(``tests/test_torch_gconv_cuda.py``, marker ``cuda``, and
``chip_smoke.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gconv_tf32.py -q
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)


def _three_pass(x, ybar, groups, passes=3):
    """The kernel's sum: the plain wgrad of the TF32 parts, in float32."""
    xh, xl = tg.tf32_split(x)
    yh, yl = tg.tf32_split(ybar)
    terms = [(xh, yh), (xh, yl), (xl, yh)][:passes]
    return sum(tg.gconv3x3_wgrad_ref(a, b, groups) for a, b in terms)


def _data(N, H, W, G, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, H, W, G * 64).astype(np.float32),
            rs.randn(N, H, W, G * 64).astype(np.float32))


def test_dispatch_rule_sends_the_float32_wgrad_to_tf32():
    """float32 wgrad at 64/64 -> TF32, and the float32 forward at 64/64 ->
    its TF32 kernel too; float32 at other widths -> the generic kernels; bfloat16
    -> the bf16 tensor-core kernels; a width whose halo exceeds shared
    memory -> the generic kernels."""
    f32, bf16 = torch.float32, torch.bfloat16
    t = torch.zeros(4)
    for width in (7, 14, 28):
        assert tg.use_tf32("wgrad", f32, 64, 64, width)
        assert tg._route("w", "wgrad", None, f32, 64, 64, width, t) == "tf32"
        assert tg._route("w", "wgrad", True, f32, 64, 64, width, t) == "tf32"
        assert tg._route("w", "wgrad", False, f32, 64, 64, width, t) == "generic"
        assert tg._route("w", "fwd", None, f32, 64, 64, width, t) == "tf32"
        assert tg._route("w", "wgrad", None, bf16, 64, 64, width, t) == "tc"
        assert not tg.use_tf32("wgrad", bf16, 64, 64, width)
        assert tg.use_tf32("fwd", f32, 64, 64, width)
    for cpg, opg in ((32, 64), (64, 32), (24, 40)):
        assert not tg.use_tf32("wgrad", f32, cpg, opg, 7)
        assert tg._route("w", "wgrad", None, f32, cpg, opg, 7, t) == "generic"
    widest = max(w for w in range(1, 512) if tg.use_tf32("wgrad", f32, 64,
                                                           64, w))
    assert (tg.tf32_smem_bytes(widest) <= tg._SMEM_BLOCK_MAX
            < tg.tf32_smem_bytes(widest + 1))
    assert not tg.use_tf32("wgrad", f32, 64, 64, widest + 1)
    assert tg._route("w", "wgrad", None, f32, 64, 64, widest + 1, t) == "generic"
    assert tg._route("w", "fwd", True, f32, 64, 64, 7, t) == "tf32"
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tg._route("w", "fwd", True, f32, 32, 64, 7, t)
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tg._route("w", "wgrad", True, f32, 64, 64, widest + 1, t)


@pytest.mark.parametrize("width,nbytes", [(7, 206_592), (14, 213_760),
                                          (28, 228_096)])
def test_shared_memory_mirror(width, nbytes):
    """tf32_smem_bytes is gconv3x3_tf32.cu's wgrad_smem_bytes: 1024 bytes
    of align slack, ybar hi + lo (2 x 32 KiB), 2 raw ybar tiles (2 x 32
    KiB), 2 halos of 128 + 2W + 2 rows of 256 bytes, 2 x 128 two-byte
    masks, a 256-byte zero row (the card checks the .cu's own number)."""
    halo = 128 + 2 * width + 2
    assert nbytes == 1024 + 4 * 32_768 + 2 * halo * 256 + 512 + 256
    assert tg.tf32_smem_bytes(width) == nbytes <= tg._SMEM_BLOCK_MAX


@pytest.mark.parametrize("shape,G", [((100, 28, 28, 128), 2),
                                     ((100, 14, 14, 384), 6),
                                     ((100, 7, 7, 384), 6),
                                     ((3, 7, 7, 192), 3),
                                     ((25, 28, 28, 128), 2)])
@pytest.mark.parametrize("sms", [132, 114])
def test_split_plan_covers_every_pixel_once(shape, G, sms):
    """The TF32 wgrad's grid (wgrad_tc_splits): split s sums tiles
    [s * per, (s + 1) * per); together they take every 128-pixel tile once,
    every pixel once, no split empty, about one block per SM."""
    n, h, w, _ = shape
    m = n * h * w
    tiles = math.ceil(m / tg.TC_TILE)
    splits, per = tg.wgrad_tc_splits(m, G, sms)
    covered = [p for s in range(splits)
               for t in range(s * per, min(tiles, (s + 1) * per))
               for p in range(t * tg.TC_TILE, min(m, (t + 1) * tg.TC_TILE))]
    assert covered == list(range(m))
    assert all(s * per < tiles for s in range(splits))
    assert splits * G <= max(G, sms)


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi has 10 mantissa bits (13 low bits zero), rounded to nearest with
    ties away from zero; hi + lo recovers the value to ~2^-22."""
    one = 1.0 + 2.0 ** -11            # half an ulp of TF32 above 1: a tie
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0, -2.5e-30],
                     dtype=torch.float32)
    hi, lo = tg.tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert hi.tolist()[:5] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                               3.0, 0.0]
    r = torch.tensor(np.random.RandomState(0).randn(4096), dtype=torch.float32)
    hi, lo = tg.tf32_split(r)
    rel = ((hi.double() + lo.double() - r.double()).abs()
           / r.double().abs()).max()
    assert rel <= 2.0 ** -21


def test_three_pass_matches_pallas_wgrad():
    """The kernel's arithmetic at G=2, 64/64, N=2, H=W=7 against the JAX
    Pallas wgrad in interpret mode, to the plain version's tolerance."""
    x, ybar = _data(2, 7, 7, 2)
    want = pg._pallas_wgrad(jnp.asarray(x), jnp.asarray(ybar), groups=2,
                            interpret=True)
    got = _three_pass(torch.tensor(x), torch.tensor(ybar), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("N,H,G", [(2, 7, 2), (3, 14, 1)])
def test_three_pass_is_float32_accurate_and_one_pass_is_not(N, H, G):
    """Against float64: three passes miss by at most 2x what plain float32
    misses; one pass (hi*hi) misses by far more, over the float32
    tolerance of chip_smoke.py (1e-4 of the largest value)."""
    x, ybar = (torch.tensor(a) for a in _data(N, H, H, G, seed=N))
    exact = tg.gconv3x3_wgrad_ref(x.double(), ybar.double(), G)
    scale = float(exact.abs().max())

    def err(v):
        return float((v.double() - exact).abs().max()) / scale

    plain = err(tg.gconv3x3_wgrad_ref(x, ybar, G))
    three = err(_three_pass(x, ybar, G))
    one = err(_three_pass(x, ybar, G, passes=1))
    assert three <= 2 * plain
    assert one > 1e-4 > 100 * three
