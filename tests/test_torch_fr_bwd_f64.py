"""The meta-backward's orientations against the reverse unroll, float64.

``hvp_mode="forward"`` takes each inner step's second derivatives in the
orientation ``fr_bwd`` names, as the JAX ``fr_core_bwd``: ``"rof"``, the
gradient of the forward-mode directional derivative (with the
merged-tangent conv of ``ops/fused_jvp.py`` under ``fused_jvp``, or the
plain conv rule without), and ``"for"``, the jvp of the gradient
(``torch.func``).  Each is held against the ``create_graph=True`` unroll
(``hvp_mode="reverse"``, the oracle) on every distillable tower of the
zoo, at 1e-9 relative in float64: loss and the four meta-gradients.

Towers at toy depth with their published block kinds (the cuts of
tests/test_torch_zoo_distill*.py): NF_TINY (the grouped 3x3s on the
``GConv3x3`` Functions), ConvNet-tiny, ResNet-18-GN, ViT-Tiny/16 (3
blocks), NF-ResNet50 and NF-RegNet-B1 (one or two blocks a stage, the
latter on the kernels' Functions at 8 channels per group), ConvNeXt-Tiny
(one block a stage) and CLIP ViT-B/32 (2 blocks at 64^2).  Seeded port
weights; skipinit gains and ConvNeXt's layer scales moved off their
init so that every residual branch shapes the loss; projection dropout
on, so the recomputes must redraw the same masks.  Then the float64
finite-difference check on the inner LRs of JAX tests/test_distill.py's
``test_hvp_forward_finite_difference`` in each orientation, the
LayerNorm / softmax / GroupNorm forms under grad-of-jvp against
reverse-over-reverse at 1e-12, and an unknown ``fr_bwd`` refused.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
)
from multimodal_dataset_distillation_tpu_torch.models import (
    clip_vision,
    convnext,
    nfnet,
    resnet,
    vit,
    zoo,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.layers import (
    GroupNorm,
    layer_norm,
)
from multimodal_dataset_distillation_tpu_torch.ops.contrastive import (
    _symmetric_ce,
    softmax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import flatten_params
from test_torch_threads import share_cores  # noqa: F401 (autouse)

NQ, MB, STEPS, TXT = 4, 2, 2, 32
CFG = dict(num_queries=NQ, syn_steps=STEPS, mini_batch_size=MB,
           expert_epochs=1, lr_img=10.0, lr_txt=10.0, lr_lr=1e-2,
           lr_teacher_img=0.05, lr_teacher_txt=0.05, seed=0,
           inner_dtype="float64", pallas_gconv=True)
# (cut of the port's network or None, image size)
TOWERS = {
    "nf_tiny": (None, 32),
    "convnet_tiny": (None, 32),
    "resnet18_gn": (lambda s: resnet.ResNet("basic", (1, 1, 1, 1), 512,
                                            "groupnorm", True), 32),
    "vit": (lambda s: vit.VisionTransformer(depth=3, image_size=s), 32),
    "nf_resnet50": (lambda s: nfnet.NormFreeNet(dataclasses.replace(
        nfnet.NF_RESNET50, depths=(1, 1, 1, 1))), 32),
    "nf_regnet": (lambda s: nfnet.NormFreeNet(dataclasses.replace(
        nfnet.NF_REGNET_B1, depths=(2, 2, 1, 1)), gconv=True), 32),
    "convnext": (lambda s: convnext.ConvNeXt(depths=(1, 1, 1, 1)), 32),
    "clip": (lambda s: clip_vision.ClipVisionTransformer(dataclasses.replace(
        clip_vision.CLIP_VIT_B32, num_layers=2), image_size=s), 64),
}
MODES = {"rof_fused": dict(fr_bwd="rof", fused_jvp=True),
         "rof_plain": dict(fr_bwd="rof", fused_jvp=False),
         "for": dict(fr_bwd="for")}
NAMES = ("loss", "pixels", "texts", "lr_img", "lr_txt")
# towers whose attention computes in float32 (see _attention_f64)
ATTENTION = ("vit", "clip")


def _model(name):
    cut, size = TOWERS[name]
    model = VLBiEncoder(name, TXT, zoo.feature_dim(name), proj_dropout=0.1,
                        gconv=True, image_size=size)
    if cut is not None:
        model.image_encoder.model = cut(size)
    init_bi_encoder(model, seed=3)
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith(("skipinit_gain", "gamma")):
                p.copy_(torch.as_tensor(0.3 + 0.05 * rs.randn(*p.shape)))
    return model.double()


def _distiller(name, model, **kw):
    size = TOWERS[name][1]
    rs = np.random.RandomState(1)
    cfg = Config(image_encoder=name, image_size=size, **{**CFG, **kw})
    d = Distiller(cfg, model, rs.randn(NQ, size, size, 3),
                  rs.randn(NQ, TXT), device="cpu")
    seg = []
    for tower in (model.image_encoder, model.text_projection):
        th0 = flatten_params(tower)
        seg.append((th0, th0 + 0.01 * torch.as_tensor(
            rs.randn(th0.numel()))))
    (i0, it), (t0, tt) = seg
    return d, (i0, t0, it, tt)


def _meta_grads(d, seg, seeds=((11, 12), (13, 14))):
    st = d.state
    leaves = [t.detach().clone().requires_grad_() for t in
              (st.image_syn, st.text_syn, st.syn_lr_img, st.syn_lr_txt)]
    idx = torch.as_tensor(d.sample_indices(np.random.RandomState(2)))
    loss, _ = d.grand_loss(*leaves, *seg, idx, list(seeds))
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


@contextlib.contextmanager
def _attention_f64(on):
    """ViT's and CLIP's attention (and CLIP's last projection) compute in
    float32 whatever the compute dtype, as flax's ``preferred_element_type``
    does under x64 too: ``.float()`` in the port.  With ``on``, a float64
    tensor's ``.float()`` stays float64, so that those towers run in
    float64 throughout."""
    with pytest.MonkeyPatch.context() as mp:
        if on:
            f = torch.Tensor.float
            mp.setattr(torch.Tensor, "float", lambda t, *a, **k: (
                t if t.dtype == torch.float64 else f(t, *a, **k)))
        yield


@pytest.fixture(scope="module", params=[(n, True) for n in TOWERS] + [
    (n, False) for n in ATTENTION], ids=lambda p: p[0] + ("" if p[1] else
                                                          "-f32attention"))
def tower(request):
    """(name, whether float64 throughout, model, the reverse unroll's loss
    and meta-gradients)."""
    name, f64 = request.param
    model = _model(name)
    d, seg = _distiller(name, model, hvp_mode="reverse")
    with _attention_f64(f64):
        return name, f64, model, _meta_grads(d, seg)


def _close(got, want, rel, what):
    for g, w, n in zip(got, want, NAMES):
        scale = float(w.abs().max())
        assert torch.isfinite(g).all() and scale > 0, (what, n)
        err = float((g - w).abs().max())
        assert err <= rel * scale, f"{what} {n}: {err:.3e} > {rel} x {scale:.3e}"


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_reverse_unroll(tower, mode):
    """1e-9 of the largest reverse value in float64 throughout; 2e-6 with
    the attention towers' float32 islands, which round at ~4e-7 relative
    in other places in the two unrolls."""
    name, f64, model, want = tower
    d, seg = _distiller(name, model, hvp_mode="forward", **MODES[mode])
    with _attention_f64(f64):
        got = _meta_grads(d, seg)
    _close(got, want, 1e-9 if f64 else 2e-6, f"{name} {mode}")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("inner_scale", ["fixed", "syn_lr"])
def test_inner_lr_finite_difference(mode, inner_scale):
    """Central differences of grand_loss in each inner LR against the
    meta-gradient, float64 (JAX tests/test_distill.py:375-398): eps 1e-6,
    1e-4 relative."""
    model = _model("nf_tiny")
    d, seg = _distiller("nf_tiny", model, hvp_mode="forward",
                        inner_scale=inner_scale, **MODES[mode])
    st = d.state
    idx = torch.as_tensor(d.sample_indices(np.random.RandomState(2)))
    seeds = [(5, 6), (7, 8)]

    def loss_at(lr_i, lr_t):
        return d.grand_loss(st.image_syn, st.text_syn, lr_i, lr_t, *seg,
                            idx, seeds)[0]

    lrs = [st.syn_lr_img.clone().requires_grad_(),
           st.syn_lr_txt.clone().requires_grad_()]
    grads = torch.autograd.grad(loss_at(*lrs), lrs)
    eps = 1e-6
    for k, name in enumerate(("lr_img", "lr_txt")):
        up, down = [t.detach().clone() for t in lrs], [
            t.detach().clone() for t in lrs]
        up[k] += eps
        down[k] -= eps
        with torch.no_grad():
            fd = float(loss_at(*up) - loss_at(*down)) / (2 * eps)
        an = float(grads[k])
        assert np.isfinite(fd) and np.isfinite(an)
        assert abs(fd - an) < 1e-4 * max(1.0, abs(fd)), (name, fd, an)


def _rof_vs_ror(fn, *shapes):
    """Gradients of the directional derivative of ``fn`` (grad-of-jvp
    through dual tensors) and of <grad fn, v> (reverse-over-reverse), over
    every input, on seeded float64 operands."""
    rs = np.random.RandomState(0)
    xs = [torch.as_tensor(rs.randn(*s)) for s in shapes]
    vs = [torch.as_tensor(rs.randn(*s)) for s in shapes]
    a = [x.clone().requires_grad_() for x in xs]
    with fwAD.dual_level():
        out = fn(*[fwAD.make_dual(t, v) for t, v in zip(a, vs)])
        h = fwAD.unpack_dual(out).tangent
    rof = torch.autograd.grad(h, a)
    b = [x.clone().requires_grad_() for x in xs]
    g = torch.autograd.grad(fn(*b), b, create_graph=True)
    ror = torch.autograd.grad(sum((gi * v).sum() for gi, v in zip(g, vs)), b)
    return rof, ror


@pytest.mark.parametrize("op", ["layer_norm", "softmax", "symmetric_ce",
                                "symmetric_ce_masked", "group_norm"])
def test_forward_ad_forms_match_reverse_over_reverse(op):
    """The towers' LayerNorm, softmax, contrastive loss and channels-last
    GroupNorm under grad-of-jvp against reverse-over-reverse, 1e-12.
    ``F.layer_norm`` there gives wrong second derivatives without an
    error, ``log_softmax`` raises, and ``F.group_norm`` fails on a
    channels-last tangent: the port's forms must not."""
    ln = torch.nn.LayerNorm(6, eps=1e-5).double()
    gn = GroupNorm(2, 6, eps=1e-6).double()
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)

    def weighted(y):
        return (torch.sin(y) * torch.linspace(0.5, 1.5, y.shape[-1],
                                              dtype=y.dtype)).sum()

    fn, shapes = {
        "layer_norm": (lambda x, w, b: weighted(
            layer_norm(x, _Params(ln, w, b))), ((3, 5, 6), (6,), (6,))),
        "softmax": (lambda x: weighted(softmax(x, -1) * x), ((3, 5, 6),)),
        "symmetric_ce": (_symmetric_ce, ((4, 4),)),
        "symmetric_ce_masked": (lambda x: _symmetric_ce(x, mask, 3),
                                ((4, 4),)),
        "group_norm": (lambda x, w, b: weighted(torch.func.functional_call(
            gn, {"weight": w, "bias": b},
            (x.contiguous(memory_format=torch.channels_last),)).permute(
                0, 2, 3, 1)), ((2, 6, 3, 3), (6,), (6,))),
    }[op]
    rof, ror = _rof_vs_ror(fn, *shapes)
    for a, b in zip(rof, ror):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


class _Params:
    """A LayerNorm's settings with other weight and bias tensors."""

    def __init__(self, mod, weight, bias):
        self.normalized_shape, self.eps = mod.normalized_shape, mod.eps
        self.weight, self.bias = weight, bias


def test_bad_fr_bwd_raises():
    with pytest.raises(ValueError, match="fr_bwd"):
        _distiller("convnet_tiny", _model("convnet_tiny"), fr_bwd="fwd")
