"""The float32 tensor-core forward (``csrc/gconv3x3_tf32.cu``: the weight
pre-pass and ``gconv3x3_fwd_tf32_kernel``; also the input gradient, on
``rot_swap(w)``) on the CPU: its dispatch rule, the Python mirror of its
shared memory, its grid plan, the pre-pass's K-major layout, and its
arithmetic (three TF32 passes, hi*hi + hi*lo + lo*hi) through
:func:`gconv3x3_fwd_tf32_ref` against the JAX package's Pallas forward and
against float64.  The kernel itself runs only on the card
(``tests/test_torch_gconv_cuda.py``, marker ``cuda``, and ``chip_smoke.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gconv_tf32_fwd.py -q
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)

F32, BF16 = torch.float32, torch.bfloat16


def _data(N, H, W, G, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H, W, G * 64).astype(np.float32)
    w = (rs.randn(3, 3, 64, G * 64) / math.sqrt(9 * 64)).astype(np.float32)
    return x, w


def _widest():
    return max(w for w in range(1, 512) if tg.use_tf32("fwd", F32, 64, 64, w))


def test_rule_admits_the_float32_forward_up_to_the_widest_width():
    """float32 at 64/64 takes the TF32 forward at every width whose halo
    tiles fit a block's shared memory (up to 64), and not one past it;
    bfloat16 keeps the bf16 tensor-core forward, other group widths the
    generic kernels."""
    t = torch.zeros(4)
    widest = _widest()
    assert widest == 64
    assert all(tg.use_tf32("fwd", F32, 64, 64, w) for w in range(1, 65))
    assert (tg.tf32_fwd_smem_bytes(widest) <= tg._SMEM_BLOCK_MAX
            < tg.tf32_fwd_smem_bytes(widest + 1))
    assert not tg.use_tf32("fwd", F32, 64, 64, widest + 1)
    assert tg._route("f", "fwd", None, F32, 64, 64, widest, t) == "tf32"
    assert tg._route("f", "fwd", None, F32, 64, 64, widest + 1, t) == "generic"
    assert tg._route("f", "fwd", False, F32, 64, 64, 7, t) == "generic"
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tg._route("f", "fwd", True, F32, 64, 64, widest + 1, t)
    for width in (7, 14, 28):
        assert tg._route("f", "fwd", None, BF16, 64, 64, width, t) == "tc"
        assert not tg.use_tf32("fwd", BF16, 64, 64, width)
        for cpg, opg in ((32, 64), (64, 32), (24, 40)):
            assert not tg.use_tf32("fwd", F32, cpg, opg, width)
            assert tg._route("f", "fwd", None, F32, cpg, opg, width,
                             t) == "generic"


@pytest.mark.parametrize("width,nbytes", [(7, 173_312), (14, 180_480),
                                          (28, 194_816)])
def test_fwd_shared_memory_mirror(width, nbytes):
    """tf32_fwd_smem_bytes is gconv3x3_tf32.cu's fwd_smem_bytes at
    NFNet-L0's widths: 1024 bytes of align slack, a ring of 3 tap weights
    of hi + lo (3 x 32 KiB), 2 halos of 128 + 2W + 2 rows of 256 bytes, a
    256-byte zero row (the card checks the .cu's own number)."""
    halo = 128 + 2 * width + 2
    assert nbytes == 1024 + 3 * 32_768 + 2 * halo * 256 + 256
    assert tg.tf32_fwd_smem_bytes(width) == nbytes <= tg._SMEM_BLOCK_MAX
    assert tg.tf32_smem_bytes(width) != nbytes   # the wgrad's stays its own


@pytest.mark.parametrize("shape,G", [((100, 28, 28, 128), 2),
                                     ((100, 14, 14, 384), 6),
                                     ((100, 7, 7, 384), 6),
                                     ((3, 9, 5, 128), 2),
                                     ((1, 30, 64, 128), 2)])
@pytest.mark.parametrize("sms", [132, 114])
def test_tf32_forward_plan_walks_every_tile_once(shape, G, sms):
    """The TF32 forward's persistent blocks (one per SM: its shared memory
    allows no second) walk every 128-pixel tile exactly once, evenly."""
    n, h, w, _ = shape
    m = n * h * w
    tiles = math.ceil(m / tg.TC_TILE)
    blocks = tg.fwd_tc_blocks(m, G, tg.tf32_fwd_smem_bytes(w),
                              tg._FWD_TF32_BLOCKS_PER_SM, sms)
    walks = [range(b, tiles, blocks) for b in range(blocks)]
    assert sorted(t for walk in walks for t in walk) == list(range(tiles))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert 1 <= blocks * G <= max(G, sms * tg._FWD_TF32_BLOCKS_PER_SM)


@pytest.mark.parametrize("G", [1, 2, 6])
def test_prepass_layout_is_k_major_of_w_and_of_rot_swap(G):
    """The pre-pass's layout (before the 128-byte swizzle): per group and
    tap, output o's 64 input channels contiguous, hi and lo the TF32 split
    of HWIO w; on rot_swap(w) (the dgrad's weight) the same slots hold the
    original weight spatially flipped with its channels in HWIO order.
    This is the layout in plain PyTorch; the CUDA pre-pass that writes it
    swizzled is checked only end to end, by the card tests of the
    forward."""
    _, w = _data(1, 1, 1, G, seed=G)
    wt = torch.tensor(w)
    hi, lo = tg.tf32_fwd_weight(wt, G)
    assert hi.shape == lo.shape == (G, 9, 64, 64)
    w_hi, w_lo = tg.tf32_split(wt)
    w9 = w_hi.reshape(9, 64, G, 64)                    # tap, c, g, o
    for g in range(G):
        for tap in (0, 4, 8):
            assert torch.equal(hi[g, tap], w9[tap, :, g, :].T)
            assert torch.equal(lo[g, tap],
                               w_lo.reshape(9, 64, G, 64)[tap, :, g, :].T)
    assert float(((hi.double() + lo.double())
                  - torch.tensor(w).double().reshape(9, 64, G, 64)
                  .permute(2, 0, 3, 1)).abs().max()) <= 2.0 ** -21
    rs_hi, _ = tg.tf32_fwd_weight(tg.rot_swap(wt, G), G)
    assert torch.equal(rs_hi, w9.flip(0).permute(2, 0, 1, 3))


def test_three_pass_forward_matches_pallas_spatial():
    """The kernel's arithmetic at G=2, 64/64, N=2, H=W=7 against the JAX
    Pallas forward in interpret mode: 1e-5 of the largest value (both are
    float32 sums in other orders; the dropped lo*lo term is 2^-22 of each
    product)."""
    x, w = _data(2, 7, 7, 2)
    want = np.asarray(pg._pallas_spatial(jnp.asarray(x), jnp.asarray(w),
                                         groups=2, interpret=True))
    got = tg.gconv3x3_fwd_tf32_ref(torch.tensor(x), torch.tensor(w), 2)
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["fwd", "dgrad"])
@pytest.mark.parametrize("N,H,W,G", [(2, 7, 7, 2), (3, 6, 5, 1)])
def test_three_pass_forward_is_float32_accurate_and_one_pass_is_not(
        kind, N, H, W, G):
    """Against float64, on w (the forward) and on rot_swap(w) (the input
    gradient): three passes miss by about 1e-6 of the largest value, no
    more than twice what plain float32 misses; one pass (hi*hi) misses by
    more than chip_smoke.py's float32 tolerance, 1e-4 of it."""
    x, w = (torch.tensor(a) for a in _data(N, H, W, G, seed=N))
    if kind == "dgrad":
        w = tg.rot_swap(w, G)
    exact = tg.gconv3x3_ref(x.double(), w.double(), G)
    scale = float(exact.abs().max())

    def err(v):
        return float((v.double() - exact).abs().max()) / scale

    xh, _ = tg.tf32_split(x)
    wh, _ = tg.tf32_split(w)
    plain = err(tg.gconv3x3_ref(x, w, G))
    three = err(tg.gconv3x3_fwd_tf32_ref(x, w, G))
    one = err(tg.gconv3x3_ref(xh, wh, G))
    assert three <= max(2 * plain, 2e-6)
    assert one > 1e-4 > 50 * three
