"""The grouped 3x3 conv kernels (``csrc/gconv3x3.cu``, the generic route:
``mma.sync`` tensor cores on 2-D tiles, any group width and image width,
``csrc/gconv3x3_tc.cu``, bfloat16 tensor cores, ``csrc/gconv3x3_tf32.cu``,
the float32 forward and wgrad on the tensor cores, and
``csrc/gconv3x3_narrow.cu``, 8 channels per group in both dtypes) on the
card.

Marker ``cuda``: these skip where ``torch.cuda.is_available()`` is false.
This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_gconv_cuda.py

Tolerances are fractions of the largest plain value: 1e-4 in float32 (both
sides accumulate in float32, in other orders), 2e-2 in bfloat16 (the
kernel rounds its float32 sums to bfloat16; the plain version is float32
on the same bfloat16 operands).
"""

import pytest
import torch

from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels run only there)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    err = float((got.float() - want).abs().max())
    assert err <= TOL[dtype] * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,cpg,opg", [(3, 24, 40), (2, 64, 64)])
def test_kernels_match_plain_on_card(card, dtype, G, cpg, opg):
    """Forward, input gradient and weight gradient against their plain
    versions, at a ragged shape (tails in pixels, channels and groups) and
    at NFNet's group width."""
    x = torch.randn(3, 9, 7, G * cpg, device="cuda", generator=card)
    w = 0.1 * torch.randn(3, 3, cpg, G * opg, device="cuda", generator=card)
    ybar = torch.randn(3, 9, 7, G * opg, device="cuda", generator=card)
    x, w, ybar = x.to(dtype), w.to(dtype), ybar.to(dtype)
    xf, wf, ybf = x.float(), w.float(), ybar.float()
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G), tg.gconv3x3_ref(xf, wf, G), dtype)
    xr = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, wf, G), xr, ybf)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G), dx, dtype)
    _close(tg.gconv3x3_wgrad(x, ybar, G),
           tg.gconv3x3_wgrad_ref(xf, ybf, G), dtype)
    torch.cuda.synchronize()
    # bfloat16 at group width 64 takes the tensor-core routes, float32 at
    # that width the TF32 ones
    fwd = ("_tc" if tg.use_tc("fwd", dtype, cpg, opg, 7) else
           "_tf32" if tg.use_tf32("fwd", dtype, cpg, opg, 7) else "")
    wgrad = ("_tc" if tg.use_tc("wgrad", dtype, cpg, opg, 7) else
             "_tf32" if tg.use_tf32("wgrad", dtype, cpg, opg, 7) else "")
    assert tg.LAUNCHES["gconv3x3_fwd" + fwd] == before["gconv3x3_fwd" + fwd] + 2
    assert (tg.LAUNCHES["gconv3x3_wgrad" + wgrad]
            == before["gconv3x3_wgrad" + wgrad] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,G", [
    (4, 56, 11),     # NF-RegNet-B1's first grouped site, at 56^2
    (8, 28, 23),     # its second shape
    (16, 14, 45),    # its third
    (16, 7, 92),     # its fourth: an even group count, 7^2
    (3, 5, 11),      # a ragged pixel count
])
def test_cuda_core_kernels_at_8_channels_per_group(card, dtype, N, H, G):
    """NF-RegNet-B1's grouped convs: 8 channels per group in and out, odd
    group counts, on the generic kernels in both dtypes
    (``tc=False``: the rule takes the 8-channel kernels there): forward,
    input gradient and weight gradient against the plain versions."""
    c = G * 8
    assert not tg.use_tc("fwd", dtype, 8, 8, H)
    assert not tg.use_tf32("fwd", dtype, 8, 8, H)
    x = torch.randn(N, H, H, c, device="cuda", generator=card).to(dtype)
    w = (torch.randn(3, 3, 8, c, device="cuda", generator=card)
         / 8.5).to(dtype)
    ybar = torch.randn(N, H, H, c, device="cuda", generator=card).to(dtype)
    xf, wf, ybf = x.float(), w.float(), ybar.float()
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G, tc=False), tg.gconv3x3_ref(xf, wf, G),
           dtype)
    xr = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, wf, G), xr, ybf)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G, tc=False), dx, dtype)
    _close(tg.gconv3x3_wgrad(x, ybar, G, tc=False),
           tg.gconv3x3_wgrad_ref(xf, ybf, G), dtype)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gconv3x3_fwd"] == before["gconv3x3_fwd"] + 2
    assert tg.LAUNCHES["gconv3x3_wgrad"] == before["gconv3x3_wgrad"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,G", [
    (4, 56, 11),     # NF-RegNet-B1's first grouped site, at 56^2
    (8, 28, 23),     # its second shape
    (16, 14, 45),    # its third
    (16, 7, 92),     # its fourth: an even group count, 7^2
    (3, 5, 11),      # a ragged pixel count
])
def test_narrow_kernels_match_plain_on_card(card, dtype, N, H, G):
    """The same shapes on the route the rule takes, the 8-channel kernels
    (a block spans up to 8 groups; 11, 23, 45 and 92 split into chunks of
    5-8): forward, input gradient and weight gradient against the plain
    versions, and no other kernel launched."""
    c = G * 8
    assert tg.use_narrow(dtype, 8, 8, H)
    x = torch.randn(N, H, H, c, device="cuda", generator=card).to(dtype)
    w = (torch.randn(3, 3, 8, c, device="cuda", generator=card)
         / 8.5).to(dtype)
    ybar = torch.randn(N, H, H, c, device="cuda", generator=card).to(dtype)
    xf, wf, ybf = x.float(), w.float(), ybar.float()
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G), tg.gconv3x3_ref(xf, wf, G), dtype)
    xr = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, wf, G), xr, ybf)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G), dx, dtype)
    _close(tg.gconv3x3_wgrad(x, ybar, G),
           tg.gconv3x3_wgrad_ref(xf, ybf, G), dtype)
    torch.cuda.synchronize()
    after = dict(before, gconv3x3_fwd_narrow=before["gconv3x3_fwd_narrow"] + 2,
                 gconv3x3_wgrad_narrow=before["gconv3x3_wgrad_narrow"] + 1)
    assert tg.LAUNCHES == after


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_wgrad_is_bit_identical_on_repeat(card, dtype):
    """The split wgrad adds its per-block partials in a fixed order (and
    the float32 one its four pixel phases in a fixed pattern): two calls
    give the same bits."""
    x = torch.randn(100, 28, 28, 184, device="cuda", generator=card).to(dtype)
    ybar = torch.randn(100, 28, 28, 184, device="cuda",
                       generator=card).to(dtype)
    assert torch.equal(tg.gconv3x3_wgrad(x, ybar, 23),
                       tg.gconv3x3_wgrad(x, ybar, 23))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_backward_at_8_channels_per_group(card, dtype):
    """The HVP through GConv3x3 at NF-RegNet-B1's width: every conv of the
    backward and of the backward's backward on the 8-channel kernels,
    against autograd through the plain version in the same dtype."""
    G = 11
    x = torch.randn(2, 7, 7, G * 8, device="cuda", generator=card)
    w = torch.randn(3, 3, 8, G * 8, device="cuda", generator=card) / 8.5
    vx, vw = torch.randn_like(x), torch.randn_like(w) / 8.5

    def hvp(conv):
        xx = x.to(dtype).requires_grad_()
        ww = w.to(dtype).requires_grad_()
        gx, gw = torch.autograd.grad(torch.sin(conv(xx, ww, G)).sum(),
                                     (xx, ww), create_graph=True)
        return torch.autograd.grad(
            (gx * vx.to(dtype)).sum() + (gw * vw.to(dtype)).sum(), (xx, ww))

    before = dict(tg.LAUNCHES)
    got = hvp(tg.gconv3x3)
    torch.cuda.synchronize()
    ran = {k for k in tg.LAUNCHES if tg.LAUNCHES[k] != before[k]}
    assert ran == {"gconv3x3_fwd_narrow", "gconv3x3_wgrad_narrow"}
    for a, b in zip(got, hvp(tg.gconv3x3_ref)):
        _close(a, b.float(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,widest", [(torch.float32, 295),
                                          (torch.bfloat16, 547)])
def test_narrow_widest_width_and_one_past(card, dtype, widest):
    """The widest image whose halo fits a block's shared memory runs on the
    8-channel kernels; one pixel wider goes to the generic ones;
    both match the plain version."""
    for width, sfx in ((widest, "_narrow"), (widest + 1, "")):
        x = torch.randn(2, 3, width, 16, device="cuda",
                        generator=card).to(dtype)
        w = (torch.randn(3, 3, 8, 16, device="cuda", generator=card)
             / 8.5).to(dtype)
        before = dict(tg.LAUNCHES)
        _close(tg.gconv3x3_fwd(x, w, 2), tg.gconv3x3_ref(x.float(),
                                                         w.float(), 2), dtype)
        _close(tg.gconv3x3_wgrad(x, x, 2),
               tg.gconv3x3_wgrad_ref(x.float(), x.float(), 2), dtype)
        torch.cuda.synchronize()
        assert tg.LAUNCHES == dict(
            before, **{f"gconv3x3_fwd{sfx}": before[f"gconv3x3_fwd{sfx}"] + 1,
                       f"gconv3x3_wgrad{sfx}":
                           before[f"gconv3x3_wgrad{sfx}"] + 1})


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,G", [
    (3, 9, 5, 2),     # H != W, N*H*W = 135: one full tile and a 7-pixel tail
    (11, 7, 7, 6),    # W = 7: a 128-pixel tile spans ~2.6 images; G = 6
    (2, 1, 13, 2),    # H = 1: the dy = +-1 taps are all padding
    (5, 17, 1, 2),    # W = 1: the dx = +-1 taps are all padding
    (1, 30, 31, 2),   # W = 31 > 28: the widest halo of these cases
])
def test_tc_kernels_match_plain_on_card(card, N, H, W, G):
    """The tensor-core kernels (bfloat16, 64 channels per group) against the
    plain versions at the shapes the halo tiling puts at risk: forward,
    input gradient (forward on rot_swap) and weight gradient."""
    c = G * 64
    x = torch.randn(N, H, W, c, device="cuda", generator=card).bfloat16()
    w = (torch.randn(3, 3, 64, c, device="cuda", generator=card)
         / 24.0).bfloat16()
    ybar = torch.randn(N, H, W, c, device="cuda", generator=card).bfloat16()
    xf, wf, ybf = x.float(), w.float(), ybar.float()
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G, tc=True), tg.gconv3x3_ref(xf, wf, G),
           torch.bfloat16)
    xr = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, wf, G), xr, ybf)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G, tc=True), dx,
           torch.bfloat16)
    _close(tg.gconv3x3_wgrad(x, ybar, G, tc=True),
           tg.gconv3x3_wgrad_ref(xf, ybf, G), torch.bfloat16)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gconv3x3_fwd_tc"] == before["gconv3x3_fwd_tc"] + 2
    assert tg.LAUNCHES["gconv3x3_wgrad_tc"] == before["gconv3x3_wgrad_tc"] + 1


@pytest.mark.cuda
def test_tc_wgrad_is_bit_identical_on_repeat(card):
    """The split-K wgrad adds its per-block partials in a fixed order: two
    calls on the same inputs give the same bits."""
    x = torch.randn(100, 14, 14, 384, device="cuda", generator=card).bfloat16()
    ybar = torch.randn(100, 14, 14, 384, device="cuda",
                       generator=card).bfloat16()
    a = tg.gconv3x3_wgrad(x, ybar, 6, tc=True)
    b = tg.gconv3x3_wgrad(x, ybar, 6, tc=True)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,G", [
    (100, 28, 28, 2),   # NFNet-L0's three grouped-conv shapes at mb=100
    (100, 14, 14, 6),
    (100, 7, 7, 6),
    (3, 7, 7, 3),       # 147 pixels: one full tile and a 19-pixel tail
    (2, 1, 13, 2),      # H = 1: the dy = +-1 taps are all padding
    (5, 17, 1, 2),      # W = 1: the dx = +-1 taps are all padding
    (1, 30, 31, 2),     # W = 31: the widest halo these cases take
])
def test_tf32_wgrad_matches_plain_on_card(card, N, H, W, G):
    """The float32 tensor-core wgrad (three TF32 passes) against the plain
    version in float32, to the float32 tolerance; the route takes it
    unasked, and the generic wgrad stays reachable by ``tc=False``."""
    c = G * 64
    x = torch.randn(N, H, W, c, device="cuda", generator=card)
    ybar = torch.randn(N, H, W, c, device="cuda", generator=card)
    want = tg.gconv3x3_wgrad_ref(x, ybar, G)
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_wgrad(x, ybar, G), want, torch.float32)
    _close(tg.gconv3x3_wgrad(x, ybar, G, tc=False), want, torch.float32)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gconv3x3_wgrad_tf32"] == before["gconv3x3_wgrad_tf32"] + 1
    assert tg.LAUNCHES["gconv3x3_wgrad"] == before["gconv3x3_wgrad"] + 1


@pytest.mark.cuda
def test_tf32_wgrad_is_bit_identical_on_repeat(card):
    x = torch.randn(100, 14, 14, 384, device="cuda", generator=card)
    ybar = torch.randn(100, 14, 14, 384, device="cuda", generator=card)
    a = tg.gconv3x3_wgrad(x, ybar, 6)
    b = tg.gconv3x3_wgrad(x, ybar, 6)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_float32_double_backward_on_tf32_wgrad(card):
    """The float32 HVP at group width 64: every wgrad of its backward (and
    of the backward's backward) runs on the TF32 kernel."""
    G, cpg = 2, 64
    x = torch.randn(2, 6, 6, G * cpg, device="cuda", generator=card)
    w = torch.randn(3, 3, cpg, G * cpg, device="cuda", generator=card) / 24.0
    vx, vw = torch.randn_like(x), torch.randn_like(w) / 24.0

    def hvp(conv):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(torch.sin(conv(xx, ww, G)).sum(),
                                     (xx, ww), create_graph=True)
        return torch.autograd.grad((gx * vx).sum() + (gw * vw).sum(),
                                   (xx, ww))

    before = dict(tg.LAUNCHES)
    got = hvp(tg.gconv3x3)
    assert tg.LAUNCHES["gconv3x3_wgrad_tf32"] > before["gconv3x3_wgrad_tf32"]
    assert tg.LAUNCHES["gconv3x3_wgrad"] == before["gconv3x3_wgrad"]
    # every forward, dgrad and double-backward conv on the TF32 forward
    assert tg.LAUNCHES["gconv3x3_fwd_tf32"] > before["gconv3x3_fwd_tf32"]
    assert tg.LAUNCHES["gconv3x3_fwd"] == before["gconv3x3_fwd"]
    for a, b in zip(got, hvp(tg.gconv3x3_ref)):
        _close(a, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,G", [
    (100, 28, 28, 2),   # NFNet-L0's three grouped-conv shapes at mb=100
    (100, 14, 14, 6),
    (100, 7, 7, 6),
    (3, 9, 5, 2),       # H != W, N*H*W = 135: one full tile and a 7-pixel tail
    (11, 7, 7, 6),      # W = 7: a 128-pixel tile spans ~2.6 images; G = 6
    (3, 7, 7, 3),       # 147 pixels: one full tile and a 19-pixel tail
    (2, 1, 13, 2),      # H = 1: the dy = +-1 taps are all padding
    (5, 17, 1, 2),      # W = 1: the dx = +-1 taps are all padding
    (2, 3, 64, 2),      # W = 64: the widest image the TF32 forward takes
])
def test_tf32_fwd_matches_plain_on_card(card, N, H, W, G):
    """The float32 tensor-core forward (three TF32 passes) and the input
    gradient (the same kernel on rot_swap(w)) against the plain version in
    float32 with TF32 off, to the float32 tolerance; the route takes it
    unasked, and the generic forward stays reachable by ``tc=False``."""
    c = G * 64
    x = torch.randn(N, H, W, c, device="cuda", generator=card)
    w = torch.randn(3, 3, 64, c, device="cuda", generator=card) / 24.0
    ybar = torch.randn(N, H, W, c, device="cuda", generator=card)
    want = tg.gconv3x3_ref(x, w, G)
    xr = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, w, G), xr, ybar)
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G), want, torch.float32)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G), dx, torch.float32)
    _close(tg.gconv3x3_fwd(x, w, G, tc=False), want, torch.float32)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gconv3x3_fwd_tf32"] == before["gconv3x3_fwd_tf32"] + 2
    assert tg.LAUNCHES["gconv3x3_fwd"] == before["gconv3x3_fwd"] + 1


@pytest.mark.cuda
def test_tf32_fwd_is_bit_identical_on_repeat(card):
    """No split-K and no atomics: two calls give the same bits."""
    x = torch.randn(100, 14, 14, 384, device="cuda", generator=card)
    w = torch.randn(3, 3, 64, 384, device="cuda", generator=card) / 24.0
    assert torch.equal(tg.gconv3x3_fwd(x, w, 6), tg.gconv3x3_fwd(x, w, 6))


@pytest.mark.cuda
def test_tf32_fwd_widest_width_and_one_past(card):
    """The widest width the rule admits runs on the TF32 forward; one
    pixel wider goes to the generic kernel; both match the plain version."""
    widest = max(w for w in range(1, 512)
                 if tg.use_tf32("fwd", torch.float32, 64, 64, w))
    for width, key in ((widest, "gconv3x3_fwd_tf32"),
                       (widest + 1, "gconv3x3_fwd")):
        x = torch.randn(2, 3, width, 128, device="cuda", generator=card)
        w = torch.randn(3, 3, 64, 128, device="cuda", generator=card) / 24.0
        before = dict(tg.LAUNCHES)
        _close(tg.gconv3x3_fwd(x, w, 2), tg.gconv3x3_ref(x, w, 2),
               torch.float32)
        assert tg.LAUNCHES[key] == before[key] + 1
        assert sum(tg.LAUNCHES.values()) == sum(before.values()) + 1


@pytest.mark.cuda
def test_double_backward_on_card(card):
    """A Hessian-vector product through GConv3x3 (its backward is built
    from the two Functions, so it runs on the kernels) against autograd
    through the plain version."""
    G, cpg = 2, 16
    x = torch.randn(2, 5, 6, G * cpg, device="cuda", generator=card)
    w = 0.1 * torch.randn(3, 3, cpg, G * cpg, device="cuda", generator=card)
    vx, vw = torch.randn_like(x), 0.1 * torch.randn_like(w)

    def hvp(conv):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(torch.sin(conv(xx, ww, G)).sum(),
                                     (xx, ww), create_graph=True)
        return torch.autograd.grad((gx * vx).sum() + (gw * vw).sum(),
                                   (xx, ww))

    for got, want in zip(hvp(tg.gconv3x3), hvp(tg.gconv3x3_ref)):
        _close(got, want, torch.float32)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.randn(1, 4, 4, 16, device="cuda", dtype=torch.float64)
    w = torch.randn(3, 3, 8, 16, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tg.gconv3x3_fwd(x, w, 2)
    xs = torch.randn(1, 4, 8, 16, device="cuda")[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        tg.gconv3x3_fwd(xs, w.float(), 2)
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tg.gconv3x3_fwd(x.float(), w.float(), 2, tc=True)
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tg.gconv3x3_wgrad(x[..., :8].float(), x[..., :8].float(), 2,
                          tc=True)


def _generic_checks(x, w, ybar, G, dtype):
    """Forward, dgrad and wgrad on the generic route (``tc=False``) against
    the plain versions; exactly 2 generic forwards and 1 generic wgrad."""
    xf, wf, ybf = x.float(), w.float(), ybar.float()
    before = dict(tg.LAUNCHES)
    _close(tg.gconv3x3_fwd(x, w, G, tc=False), tg.gconv3x3_ref(xf, wf, G),
           dtype)
    xr = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tg.gconv3x3_ref(xr, wf, G), xr, ybf)
    _close(tg.gconv3x3_fwd(ybar, tg.rot_swap(w, G), G, tc=False), dx, dtype)
    _close(tg.gconv3x3_wgrad(x, ybar, G, tc=False),
           tg.gconv3x3_wgrad_ref(xf, ybf, G), dtype)
    torch.cuda.synchronize()
    assert tg.LAUNCHES == dict(
        before, gconv3x3_fwd=before["gconv3x3_fwd"] + 2,
        gconv3x3_wgrad=before["gconv3x3_wgrad"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,G,cpg,opg", [
    (3, 9, 7, 3, 24, 40),     # ragged: tails in pixels, channels, columns
    (2, 36, 36, 2, 64, 64),   # NFNet-L0's stage-1 site at 288^2
    (3, 9, 7, 2, 64, 64),
    (2, 5, 6, 4, 4, 16),      # channel rows under 16 bytes: plain loads
    (2, 5, 6, 3, 8, 4),
    (2, 14, 14, 11, 8, 8),    # NF-RegNet-B1's width
    (1, 3, 5, 2, 3, 130),     # opg past one 64-wide column block, odd cpg
    (1, 4, 4, 2, 72, 8),      # cpg past the 64-byte stages
])
def test_generic_kernels_match_plain_on_card(card, dtype, N, H, W, G, cpg,
                                             opg):
    """The generic kernels (tensor cores on 2-D tiles) against the plain
    versions at every kind of shape they take."""
    x = torch.randn(N, H, W, G * cpg, device="cuda", generator=card)
    w = torch.randn(3, 3, cpg, G * opg, device="cuda",
                    generator=card) / (3 * cpg ** 0.5)
    ybar = torch.randn(N, H, W, G * opg, device="cuda", generator=card)
    _generic_checks(x.to(dtype), w.to(dtype), ybar.to(dtype), G, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cpg,kind,width", [
    (torch.bfloat16, 64, "fwd", 243),     # one past the bf16 wgmma forward
    (torch.bfloat16, 64, "wgrad", 322),   # and its wgrad
    (torch.float32, 64, "fwd", 65),       # one past the TF32 forward
    (torch.float32, 64, "wgrad", 33),     # and its wgrad
    (torch.float32, 8, "fwd", 296),       # one past the 8-channel kernels
    (torch.bfloat16, 8, "fwd", 548),
])
def test_generic_route_one_past_each_limit(card, dtype, cpg, kind, width):
    """One pixel past the widest width of each other route, the rule sends
    the call to the generic kernel unasked, and it matches the plain
    version."""
    G = 2
    assert tg._route("t", kind, None, dtype, cpg, cpg, width,
                     torch.zeros(4)) == "generic"
    assert tg._route("t", kind, None, dtype, cpg, cpg, width - 1,
                     torch.zeros(4)) != "generic"
    x = torch.randn(2, 3, width, G * cpg, device="cuda",
                    generator=card).to(dtype)
    w = (torch.randn(3, 3, cpg, G * cpg, device="cuda", generator=card)
         / (3 * cpg ** 0.5)).to(dtype)
    before = tg.LAUNCHES[f"gconv3x3_{kind}"]
    if kind == "fwd":
        _close(tg.gconv3x3_fwd(x, w, G),
               tg.gconv3x3_ref(x.float(), w.float(), G), dtype)
    else:
        _close(tg.gconv3x3_wgrad(x, x, G),
               tg.gconv3x3_wgrad_ref(x.float(), x.float(), G), dtype)
    torch.cuda.synchronize()
    assert tg.LAUNCHES[f"gconv3x3_{kind}"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_wgrad_is_bit_identical_on_repeat(card, dtype):
    """The generic wgrad adds its per-split partials in a fixed order: two
    calls give the same bits (NFNet-L0's stage-1 site at 288^2, where the
    rule takes it unasked in float32)."""
    x = torch.randn(100, 36, 36, 128, device="cuda", generator=card).to(dtype)
    ybar = torch.randn(100, 36, 36, 128, device="cuda",
                       generator=card).to(dtype)
    a = tg.gconv3x3_wgrad(x, ybar, 2, tc=False)
    assert torch.equal(a, tg.gconv3x3_wgrad(x, ybar, 2, tc=False))
    if dtype == torch.float32:
        assert torch.equal(a, tg.gconv3x3_wgrad(x, ybar, 2))


@pytest.mark.cuda
def test_float32_double_backward_at_288_stage_one(card):
    """The float32 HVP at NFNet-L0's 36-wide stage-1 site (288^2): its
    wgrads on the generic kernel (past the TF32 wgrad's 32), its forwards
    and dgrads on the TF32 forward, against autograd through the plain
    version."""
    G, cpg = 2, 64
    x = torch.randn(2, 36, 36, G * cpg, device="cuda", generator=card)
    w = torch.randn(3, 3, cpg, G * cpg, device="cuda", generator=card) / 24.0
    vx, vw = torch.randn_like(x), torch.randn_like(w) / 24.0

    def hvp(conv):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(torch.sin(conv(xx, ww, G)).sum(),
                                     (xx, ww), create_graph=True)
        return torch.autograd.grad((gx * vx).sum() + (gw * vw).sum(),
                                   (xx, ww))

    before = dict(tg.LAUNCHES)
    got = hvp(tg.gconv3x3)
    torch.cuda.synchronize()
    ran = {k for k in tg.LAUNCHES if tg.LAUNCHES[k] != before[k]}
    assert ran == {"gconv3x3_wgrad", "gconv3x3_fwd_tf32"}
    for a, b in zip(got, hvp(tg.gconv3x3_ref)):
        _close(a, b, torch.float32)
