"""Port parity: the space-to-depth stem (``ops/s2d.py``, ``WSConv``'s
``s2d_in``/``s2d_out``, the NF towers' ``stem_s2d``) against the JAX
package's ``ops/s2d.py`` and its stems.

The rearranged conv at every geometry of tests/test_s2d_stem.py (the four
deep_quad convs and the 7x7/2 and 3x3/2 single-conv stems), forward and
gradient against the plain TF-SAME conv of both packages, 1e-5 relative
with an absolute floor of 1e-5 of the largest value; the rearranged kernel
equal to the JAX one up to the channel order.  All three NF stems with
``stem_s2d`` on against off and against the JAX stem with its gate on,
forward and image gradient.  The ``MDD_STEM_S2D`` override, the fallback
for sizes the block does not divide, and a float32 outer step of the
port's Distiller with the s2d stem against the plain one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.ops import s2d as js2d
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.models import nfnet
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.layers import (
    WSConv,
    tf_same_pad,
)
from multimodal_dataset_distillation_tpu_torch.ops import s2d

from test_torch_zoo import assert_close, jax_variables, load_port, nchw
from test_torch_threads import share_cores  # noqa: F401 (autouse)

# (k, stride, fi, fo, cin, cout): tests/test_s2d_stem.py's STEM_GEOMS and
# OTHER_STEM_GEOMS
GEOMS = [(3, 2, 4, 2, 3, 16), (3, 1, 2, 2, 16, 32), (3, 1, 2, 2, 32, 64),
         (3, 2, 2, 1, 64, 128), (7, 2, 2, 1, 3, 64), (3, 2, 2, 1, 3, 32)]


def _close(got, want, tol=1e-5):
    assert_close(got, want, rtol=tol, floor=tol)


def _jax_perm(c, f):
    """perm with port_channels = jax_channels[..., perm]: the port's
    channel c*f*f + p sits at JAX's p*C + c."""
    return np.array([p * c + ch for ch in range(c) for p in range(f * f)])


@pytest.mark.parametrize("f", [2, 4])
def test_roundtrip_and_channel_order(f):
    x = np.random.RandomState(0).randn(2, 8, 12, 5).astype(np.float32)
    xt = nchw(x)
    y = s2d.space_to_depth(xt, f)
    assert y.shape == (2, 5 * f * f, 8 // f, 12 // f)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, F.pixel_unshuffle(xt, f), rtol=0, atol=0)
    torch.testing.assert_close(s2d.depth_to_space(y, f), xt, rtol=0, atol=0)
    want = np.asarray(js2d.space_to_depth(jnp.asarray(x), f))
    np.testing.assert_array_equal(
        y.permute(0, 2, 3, 1).numpy(), want[..., _jax_perm(5, f)])


@pytest.mark.parametrize("k,stride,fi,fo,cin,cout", GEOMS)
def test_block_geometry_and_kernel_match_jax(k, stride, fi, fo, cin, cout):
    assert s2d.block_geometry(k, stride, fi, fo) == js2d.block_geometry(
        k, stride, fi, fo)
    assert s2d.block_padding(k, stride, fi, fo) == js2d.block_padding(
        k, stride, fi, fo)
    w = np.random.RandomState(k + cin).randn(k, k, cin, cout).astype(
        np.float32)
    want = np.asarray(js2d.rearrange_kernel(jnp.asarray(w), stride, fi, fo))
    got = s2d.rearrange_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1)),
                               stride, fi, fo).numpy()
    # JAX (K, K, in, out) phase-major -> the port's (out, in, K, K)
    want = want[:, :, _jax_perm(cin, fi)][..., _jax_perm(cout, fo)]
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))


def _plain(x, w, stride):
    return F.conv2d(tf_same_pad(x, w.shape[-1], stride), w, stride=stride)


def _rearranged(x, w, stride, fi, fo):
    lo, hi = s2d.block_padding(w.shape[-1], stride, fi, fo)
    y = F.conv2d(F.pad(s2d.space_to_depth(x, fi), (lo, hi, lo, hi)),
                 s2d.rearrange_kernel(w, stride, fi, fo))
    return y if fo == 1 else s2d.depth_to_space(y, fo)


def _jax_conv(x, w, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("k,stride,fi,fo,cin,cout", GEOMS)
def test_rearranged_conv_forward_and_gradient(k, stride, fi, fo, cin, cout):
    """Forward, and the gradients of sum(sin(y)) in both operands (the
    meta-gradient reaches the pixels and the kernel through the stem),
    against the plain conv of the port and of the JAX package."""
    rs = np.random.RandomState(cin + k)
    x = rs.randn(2, 16, 16, cin).astype(np.float32)
    w = (0.1 * rs.randn(k, k, cin, cout)).astype(np.float32)

    def grads(conv):
        xt = nchw(x).requires_grad_()
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()
                              ).requires_grad_()
        y = conv(xt, wt)
        gx, gw = torch.autograd.grad(torch.sin(y).sum(), (xt, wt))
        return (y.detach().permute(0, 2, 3, 1).numpy(),
                gx.permute(0, 2, 3, 1).numpy(),
                gw.permute(2, 3, 1, 0).numpy())

    got = grads(lambda a, b: _rearranged(a, b, stride, fi, fo))
    plain = grads(lambda a, b: _plain(a, b, stride))
    jy = _jax_conv(jnp.asarray(x), jnp.asarray(w), stride)
    jg = jax.grad(lambda a, b: jnp.sum(jnp.sin(_jax_conv(a, b, stride))),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for g, p, j in zip(got, plain, (jy, *jg)):
        _close(g, p)
        _close(g, np.asarray(j))


def test_wsconv_s2d_mode_is_the_plain_conv():
    """WSConv's s2d mode: the same parameters, the bias tiled in the
    output's channel order."""
    torch.manual_seed(0)
    conv = WSConv(16, 32, 3)
    with torch.no_grad():
        conv.weight.normal_()
        conv.bias.normal_()
        conv.gain.uniform_(0.5, 1.5)
    x = torch.randn(2, 16, 16, 16).contiguous(
        memory_format=torch.channels_last)
    y = conv(s2d.space_to_depth(x, 2), 2, 2)
    _close(s2d.depth_to_space(y, 2).detach(), conv(x).detach())


STEMS = {"deep_quad": {}, "7x7_pool": dict(stem_chs=8),
         "3x3": dict(stem_chs=8, group_size=8)}


def _stem_cfg(mod, stem_type):
    return dataclasses.replace(mod.NF_TINY, stem_type=stem_type,
                               **STEMS[stem_type])


@pytest.fixture(scope="module", params=list(STEMS))
def stem_pair(request):
    """(stem type, JAX model, variables, images, JAX forward and image
    gradient with the gate on)."""
    stem_type = request.param
    jm = jnfnet.NormFreeNet(_stem_cfg(jnfnet, stem_type))
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    v = jax_variables(jm, x, seed=1)
    js2d.set_enabled(True)
    try:
        y = jm.apply(v, jnp.asarray(x))
        g = jax.grad(lambda xx: jnp.sum(jm.apply(v, xx) ** 2))(
            jnp.asarray(x))
    finally:
        js2d.set_enabled(False)
    return stem_type, v, x, np.asarray(y), np.asarray(g)


def _port_fwd_grad(stem_type, v, x, on):
    m = load_port(nfnet.NormFreeNet(_stem_cfg(nfnet, stem_type),
                                    stem_s2d=on), v)
    xt = nchw(x).requires_grad_()
    y = m(xt)
    (g,) = torch.autograd.grad((y ** 2).sum(), xt)
    return y.detach().numpy(), g.permute(0, 2, 3, 1).numpy()


def test_nf_stems_s2d_on_match_off_and_jax(stem_pair):
    stem_type, v, x, jy, jg = stem_pair
    y_on, g_on = _port_fwd_grad(stem_type, v, x, True)
    y_off, g_off = _port_fwd_grad(stem_type, v, x, False)
    assert_close(y_on, y_off, rtol=2e-5, floor=2e-5)
    assert_close(g_on, g_off, rtol=1e-4, floor=1e-5)
    assert_close(y_on, jy)
    assert_close(g_on, jg, rtol=1e-4, floor=1e-5)


@pytest.mark.parametrize("stem_type", list(STEMS))
def test_sizes_the_block_does_not_divide_take_the_plain_stem(stem_type):
    """30^2 is not divisible by 4; 30^2 is by 2, so the single-conv stems
    check 31^2 against their plain form: bit for bit (the same convs)."""
    size = 30 if stem_type == "deep_quad" else 31
    torch.manual_seed(0)
    on = nfnet.NormFreeNet(_stem_cfg(nfnet, stem_type), stem_s2d=True)
    off = nfnet.NormFreeNet(_stem_cfg(nfnet, stem_type))
    init_bi_encoder(on, 0)
    off.load_state_dict(on.state_dict())
    x = torch.randn(2, 3, size, size)
    torch.testing.assert_close(on(x), off(x), rtol=0, atol=0)


@pytest.mark.parametrize("env,cfg_on,want", [
    (None, True, True), (None, False, False), ("0", True, False),
    ("off", True, False), ("1", False, True), ("TRUE", False, True),
    ("", True, True)])
def test_env_override_wins_over_the_config(monkeypatch, env, cfg_on, want):
    if env is None:
        monkeypatch.delenv("MDD_STEM_S2D", raising=False)
    else:
        monkeypatch.setenv("MDD_STEM_S2D", env)
    cfg = Config(image_encoder="nf_tiny", image_size=32, stem_s2d=cfg_on,
                 device="cpu", text_encoder_config="tiny")
    assert s2d.configure(cfg) is want
    model = build_bi_encoder(cfg)
    assert model.image_encoder.model.stem.s2d is want


def test_distill_step_with_s2d_stem_matches_plain(monkeypatch):
    """A float32 outer step of the port's Distiller (forward-HVP) with the
    nf_tiny student: the s2d stem against the plain one, same weights."""
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller,
    )
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        flatten_params,
    )

    monkeypatch.delenv("MDD_STEM_S2D", raising=False)
    rs = np.random.RandomState(0)
    images = rs.randn(4, 32, 32, 3).astype(np.float32)
    texts = rs.randn(4, 128).astype(np.float32)
    out = []
    for on in (False, True):
        cfg = Config(image_encoder="nf_tiny", image_size=32, num_queries=4,
                     mini_batch_size=2, syn_steps=2, expert_epochs=1,
                     text_encoder_config="tiny", stem_s2d=on, device="cpu",
                     lr_img=10.0, inner_scale="syn_lr")
        model = init_bi_encoder(build_bi_encoder(cfg), 0)
        d = Distiller(cfg, model, images, texts, device="cpu")
        i0 = flatten_params(model.image_encoder)
        t0 = flatten_params(model.text_projection)
        g = torch.Generator().manual_seed(1)
        seg = (i0, t0, i0 + 0.01 * torch.randn(i0.shape, generator=g),
               t0 + 0.01 * torch.randn(t0.shape, generator=g))
        st = d.state
        leaves = [t.detach().clone().requires_grad_() for t in
                  (st.image_syn, st.text_syn, st.syn_lr_img, st.syn_lr_txt)]
        idx = torch.as_tensor(d.sample_indices(np.random.RandomState(2)))
        loss, _ = d.grand_loss(*leaves, *seg, idx, d.draw_seeds(2))
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=0)
    for a, b in zip(g1, g0):
        err = float((a - b).norm() / b.norm())
        assert err < 1e-4, err
