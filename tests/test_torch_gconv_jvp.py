"""Forward-mode rules of the grouped-conv Functions (``ops/gconv.py``).

``GConv3x3`` and ``GConv3x3Wgrad`` carry the bilinear product rule as
their ``jvp`` (the port's ``ad.defbilinear``, JAX
``ops/pallas_gconv.py:336, 343``), built from ``.apply`` of the same two
Functions, so that grad-of-jvp (``fr_bwd="rof"``, dual tensors of
``torch.autograd.forward_ad``) and jvp-of-grad (``fr_bwd="for"``,
``torch.func``) stay on the kernels to any order.

On the CPU the Functions run their plain versions: each rule is held
against ``torch.func.jvp`` of :func:`gconv3x3_ref` /
:func:`gconv3x3_wgrad_ref`, and both second-order orientations against
the same on ``F.conv2d``, in float64 at 1e-12 of the largest value.  The
count of wrapper calls per grouped site and inner step of a distill step
in each orientation is the one ``chip_smoke.py`` asserts on the card.
Cases marked ``cuda`` run the kernels against the plain versions there
(``check_hvp``'s tolerances); this file imports no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_gconv_jvp.py
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from multimodal_dataset_distillation_tpu_torch.ops import gconv as tg
from test_torch_threads import share_cores  # noqa: F401 (autouse)

# (groups, channels per group in, out)
SHAPES = [(2, 4, 4), (3, 8, 8), (2, 3, 5)]


def _operands(groups, cpg, opg, dtype=torch.float64, device="cpu", seed=0):
    rs = np.random.RandomState(seed)

    def t(*shape):
        return torch.as_tensor(rs.randn(*shape), dtype=dtype, device=device)

    x = t(2, 5, 6, groups * cpg)
    w = t(3, 3, cpg, groups * opg) / np.sqrt(9 * cpg)
    yb = t(2, 5, 6, groups * opg)
    return x, w, yb, t(*x.shape), t(*w.shape) / np.sqrt(9 * cpg), \
        t(*yb.shape)


def _apply(fn, groups):
    return lambda a, b: fn(a.contiguous(), b.contiguous(), groups)


def _close(got, want, rel=1e-12):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("groups,cpg,opg", SHAPES)
@pytest.mark.parametrize("which", ["conv", "wgrad"])
def test_jvp_rule_matches_plain(groups, cpg, opg, which):
    """(y, ydot) of each Function under dual tensors and under
    ``torch.func.jvp``, with both tangents and with one, against
    ``torch.func.jvp`` of the plain version."""
    x, w, yb, xd, wd, ybd = _operands(groups, cpg, opg)
    fn, ref, b, bd = {
        "conv": (tg.GConv3x3.apply, tg.gconv3x3_ref, w, wd),
        "wgrad": (tg.GConv3x3Wgrad.apply, tg.gconv3x3_wgrad_ref, yb, ybd),
    }[which]
    f, r = _apply(fn, groups), _apply(ref, groups)
    for tangents in ((xd, bd), (None, bd), (xd, None)):
        zero = [torch.zeros_like(p) if t is None else t
                for p, t in zip((x, b), tangents)]
        want = torch.func.jvp(r, (x, b), tuple(zero))
        got = torch.func.jvp(f, (x, b), tuple(zero))
        with fwAD.dual_level():
            duals = [p if t is None else fwAD.make_dual(p, t)
                     for p, t in zip((x, b), tangents)]
            out = fwAD.unpack_dual(f(*duals))
        for g in (got, tuple(out)):
            _close(g[0], want[0])
            _close(g[1], want[1])


def _net(conv, groups):
    def net(x, w1, w2):
        h = torch.tanh(conv(x, w1, groups))
        return (torch.sin(conv(h, w2, groups)) * h).sum()
    return net


def _grad_of_jvp(net, x, w1, w2, v1, v2):
    """Gradients over (x, w1, w2) of d/de net(x, w1 + e v1, w2 + e v2),
    through dual tensors (``fr_bwd="rof"``)."""
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
    with fwAD.dual_level():
        out = net(leaves[0], fwAD.make_dual(leaves[1], v1),
                  fwAD.make_dual(leaves[2], v2))
        h = fwAD.unpack_dual(out).tangent
    return torch.autograd.grad(h, leaves)


def _jvp_of_grad(net, x, w1, w2, v1, v2):
    """The jvp in the direction (v1, v2) of the gradient over (x, w1, w2),
    through ``torch.func`` (``fr_bwd="for"``)."""
    def grads(a, b):
        return torch.func.grad(net, argnums=(0, 1, 2))(x, a, b)
    return torch.func.jvp(grads, (w1, w2), (v1, v2))[1]


def _two_convs(groups, cpg, dtype=torch.float64, device="cpu"):
    x, w1, _, _, v1, _ = _operands(groups, cpg, cpg, dtype, device, 1)
    _, w2, _, _, v2, _ = _operands(groups, cpg, cpg, dtype, device, 2)
    return x, w1, w2, v1, v2


@pytest.mark.parametrize("groups,cpg", [(2, 4), (3, 8)])
@pytest.mark.parametrize("orientation", ["grad_of_jvp", "jvp_of_grad"])
def test_second_order_matches_f_conv2d(groups, cpg, orientation):
    """Both orientations through two chained Function convs equal the same
    through the plain version (``F.conv2d``), float64, 1e-12; and equal
    each other."""
    ops = _two_convs(groups, cpg)
    second = {"grad_of_jvp": _grad_of_jvp, "jvp_of_grad": _jvp_of_grad}
    got = second[orientation](_net(tg.gconv3x3, groups), *ops)
    want = second[orientation](_net(tg.gconv3x3_ref, groups), *ops)
    other = second[({*second} - {orientation}).pop()](
        _net(tg.gconv3x3, groups), *ops)
    for g, w, o in zip(got, want, other):
        _close(g, w)
        _close(o, w, 1e-10)


def _count_calls(monkeypatch):
    calls = {"fwd": 0, "wgrad": 0}
    for kind in calls:
        name = f"gconv3x3_{kind}"
        orig = getattr(tg, name)

        def counted(*a, _orig=orig, _kind=kind, **k):
            calls[_kind] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tg, name, counted)
    return calls


@pytest.mark.parametrize("mode", [dict(fr_bwd="rof", fused_jvp=True),
                                  dict(fr_bwd="rof", fused_jvp=False),
                                  dict(fr_bwd="for")],
                         ids=["rof_fused", "rof_plain", "for"])
def test_calls_per_site_and_inner_step(monkeypatch, mode):
    """The distill step's grouped-conv calls in each orientation: per
    grouped site and inner step 8 forward-kernel calls (the inner
    gradient's forward and dgrad, then the backward's forward, its two
    tangent convs and three dgrads, or under "for" the forward, the dgrad
    and the jvp's four) and 4 wgrad calls: the counts ``chip_smoke.py``
    holds the card's launches to."""
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller)
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        VLBiEncoder, init_bi_encoder)
    from multimodal_dataset_distillation_tpu_torch.models.layers import (
        WSConv)
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        flatten_params)

    steps = 2
    model = init_bi_encoder(VLBiEncoder("nf_tiny", 32, 128, gconv=True), 0)
    sites = sum(m.use_gconv for m in model.modules()
                if isinstance(m, WSConv))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("skipinit_gain"):
                p.fill_(0.3)
    rs = np.random.RandomState(0)
    cfg = Config(image_encoder="nf_tiny", image_size=16, num_queries=4,
                 syn_steps=steps, mini_batch_size=2, pallas_gconv=True,
                 **mode)
    d = Distiller(cfg, model, rs.randn(4, 16, 16, 3), rs.randn(4, 32),
                  device="cpu")
    segs = [flatten_params(t) for t in (model.image_encoder,
                                        model.text_projection)]
    calls = _count_calls(monkeypatch)
    d.step(segs[0], segs[1], segs[0] + 0.01, segs[1] + 0.01,
           d.sample_indices(rs))
    assert calls == {"fwd": 8 * sites * steps, "wgrad": 4 * sites * steps}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels run only there)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups,cpg", [(2, 64), (11, 8)])
@pytest.mark.parametrize("orientation", ["grad_of_jvp", "jvp_of_grad"])
def test_second_order_on_card(card, dtype, groups, cpg, orientation):
    """Both orientations through the kernels against the plain version on
    the same operands in the same dtype: 1e-4 of the largest plain value
    in float32, 2e-2 in bfloat16 (``chip_smoke.check_hvp``'s)."""
    ops = _two_convs(groups, cpg, dtype, card)
    second = {"grad_of_jvp": _grad_of_jvp, "jvp_of_grad": _jvp_of_grad}
    before = dict(tg.LAUNCHES)
    got = second[orientation](_net(tg.gconv3x3, groups), *ops)
    torch.cuda.synchronize()
    assert sum(tg.LAUNCHES.values()) > sum(before.values())
    want = second[orientation](_net(tg.gconv3x3_ref, groups), *ops)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err
