"""The grouped 3x3 conv kernels (``csrc/gconv3x3.cu``) on the card.

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
    assert tg.LAUNCHES["gconv3x3_fwd"] == before["gconv3x3_fwd"] + 2
    assert tg.LAUNCHES["gconv3x3_wgrad"] == before["gconv3x3_wgrad"] + 1


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
