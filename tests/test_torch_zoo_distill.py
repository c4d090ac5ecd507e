"""Port parity: the outer distillation step over the zoo's stateless towers
against the JAX Distiller, and the configurations neither package
distils.

ConvNet-tiny, ViT-Tiny/16 at 32^2 (5 tokens) and NF-RegNet-B1 at 32^2
(its cpg-8 grouped convs on the ``GConv3x3`` Functions, their plain
versions on the CPU), the last two cut in depth to keep the JAX side's
compile of the second-order step inside this file's time (~100 s at
NF-RegNet-B1's 20 blocks): ViT 3 blocks of 12, NF-RegNet-B1 stages of
2/2/1/1 blocks (two grouped sites, at 11 and 23 groups, and both stride-2
grouped transitions), each at its published widths, stem and block
kinds.  Their full depth is held forward in tests/test_torch_zoo.py and
in training in tests/test_torch_zoo_train.py. the same weights (the flax tree with seeded values,
carried across by ``models/convert.py``), synthetic data, minibatch indices and expert
segment go through both packages' ``Distiller``; nq=4, mb=2, syn_steps=2,
float32, dropout off (the towers draw nothing; ``proj_dropout=0``).

Tolerances as tests/test_torch_distill.py (tests/test_reference_parity.py):
2e-4 on per-step students, 5e-3 on the loss and the meta-gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine.distill import (
    Distiller as JDistiller,
)
from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.models import vit as jvit
from multimodal_dataset_distillation_tpu.models import zoo as jzoo
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
    build_bi_encoder as jbuild,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
)
from multimodal_dataset_distillation_tpu_torch.models import nfnet, vit, zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    build_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    params_from_jax,
)

from test_torch_zoo import jax_variables
from test_torch_threads import share_cores  # noqa: F401 (autouse)

NQ, MB, STEPS, SIZE, TXT = 4, 2, 2, 32, 64
CFG = dict(image_size=SIZE, num_queries=NQ, syn_steps=STEPS,
           mini_batch_size=MB, expert_epochs=1, lr_img=10.0, lr_txt=10.0,
           lr_lr=1e-2, lr_teacher_img=0.01, lr_teacher_txt=0.05, seed=0,
           inner_scale="syn_lr")


# the depth cuts (module docstring): JAX network, the port's network
CUT = {
    "vit": (lambda: jvit.VisionTransformer(depth=3),
            lambda: vit.VisionTransformer(depth=3, image_size=SIZE)),
    "nf_regnet": (
        lambda: jnfnet.NormFreeNet(dataclasses.replace(
            jnfnet.NF_REGNET_B1, depths=(2, 2, 1, 1))),
        lambda: nfnet.NormFreeNet(dataclasses.replace(
            nfnet.NF_REGNET_B1, depths=(2, 2, 1, 1)), gconv=True)),
}


@pytest.fixture(scope="module", params=["convnet_tiny", "vit", "nf_regnet"])
def parity(request):
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        if name in CUT:
            build = jzoo._build
            mp.setattr(jzoo, "_build", lambda n, transfer=False: (
                CUT[name][0]() if n == name else build(n, transfer)))
        return _parity(name)


def _parity(name):
    dim = zoo.feature_dim(name)
    jmodel = JVLBiEncoder(image_encoder_name=name, text_embedding=TXT,
                          image_embedding=dim, proj_dropout=0.0)
    rng = np.random.RandomState(0)
    image_syn = rng.randn(NQ, SIZE, SIZE, 3).astype(np.float32)
    text_syn = rng.randn(NQ, TXT).astype(np.float32)
    variables = jax_variables(jmodel, image_syn, text_syn, seed=5)
    jd = JDistiller(JConfig(image_encoder=name, **CFG), jmodel, variables,
                    image_syn, text_syn)
    p = variables["params"]
    i0 = np.asarray(ravel_pytree(p["image_encoder"])[0])
    t0 = np.asarray(ravel_pytree(p["text_projection"])[0])
    seg = (i0, t0, (i0 + 0.01 * rng.randn(*i0.shape)).astype(np.float32),
           (t0 + 0.01 * rng.randn(*t0.shape)).astype(np.float32))
    idx = jd.sample_indices(np.random.RandomState(1))
    keys = jax.random.split(jax.random.PRNGKey(7), STEPS)
    s0 = jd.state
    args = (s0.image_syn, s0.text_syn, s0.syn_lr_img, s0.syn_lr_txt,
            *map(jnp.asarray, seg), jnp.asarray(idx), keys)
    j_unroll = [np.asarray(a) for a in jd.unroll(*args[:6],
                                                 jnp.asarray(idx), keys)]
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        jd.grand_loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)

    model = VLBiEncoder(name, TXT, dim, proj_dropout=0.0, gconv=True,
                        image_size=SIZE)
    if name in CUT:
        model.image_encoder.model = CUT[name][1]()
    for part in ("image_encoder", "text_projection"):
        getattr(model, part).load_state_dict(
            params_from_jax(p[part], getattr(model, part)))
    towers = (model.image_encoder, model.text_projection) * 2
    return dict(name=name, model=model, data=(image_syn, text_syn),
                seg=[flat_from_jax(s, m) for s, m in zip(seg, towers)],
                idx=idx, j_unroll=j_unroll, j_loss=float(j_loss),
                j_grads=[np.asarray(g) for g in j_grads])


def _port(p):
    cfg = Config(image_encoder=p["name"], pallas_gconv=True, **CFG)
    d = Distiller(cfg, p["model"], *p["data"], device="cpu")
    st = d.state
    leaves = [t.detach().clone().requires_grad_() for t in
              (st.image_syn, st.text_syn, st.syn_lr_img, st.syn_lr_txt)]
    flats = [torch.as_tensor(s) for s in p["seg"]]
    return d, leaves, flats, torch.as_tensor(p["idx"])


def test_unroll_matches_jax(parity):
    p = parity
    d, leaves, flats, idx = _port(p)
    his, hts = d.unroll(*leaves, flats[0], flats[1], idx,
                        d.draw_seeds(STEPS))
    j_his, j_hts = p["j_unroll"]
    for got, want, tower in ((his, j_his, p["model"].image_encoder),
                             (hts, j_hts, p["model"].text_projection)):
        np.testing.assert_allclose(got.numpy(), flat_from_jax(want, tower),
                                   rtol=2e-4, atol=2e-6)


def test_meta_gradients_match_jax(parity):
    p = parity
    d, leaves, flats, idx = _port(p)
    loss, _ = d.grand_loss(*leaves, *flats, idx, d.draw_seeds(STEPS))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), p["j_loss"], rtol=5e-3)
    for g, jg, name in zip(grads, p["j_grads"],
                           ("pixels", "texts", "lr_img", "lr_txt")):
        scale = np.abs(jg).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=5e-3,
                                   atol=5e-3 * scale, err_msg=name)


@pytest.mark.parametrize("kw,jax_error,match", [
    (dict(image_encoder="resnet18"), "ModifyScopeVariableError",
     "BatchNorm"),
    (dict(image_encoder="resnet50"), "ModifyScopeVariableError",
     "BatchNorm"),
    (dict(image_encoder="convnet", only_has_image_projection=True),
     "ScopeParamNotFoundError", "--only_has_image_projection")])
def test_what_jax_cannot_distill_is_refused(kw, jax_error, match):
    """The JAX Distiller raises on its first step with a BatchNorm tower
    (batch_stats are frozen and immutable there) and with an image
    projection (it passes the image tower's parameters alone); the port's
    Distiller refuses both when it is built."""
    cfg = JConfig(image_size=16, num_queries=4, mini_batch_size=2,
                  syn_steps=1, text_encoder_config="tiny", **kw)
    jmodel = jbuild(cfg.replace(distill=True))
    rs = np.random.RandomState(0)
    images = rs.randn(4, 16, 16, 3).astype(np.float32)
    texts = rs.randn(4, 128).astype(np.float32)
    v = jax_variables(jmodel, images, texts)
    jd = JDistiller(cfg, jmodel, v, images, texts)
    i0 = np.asarray(ravel_pytree(v["params"]["image_encoder"])[0])
    t0 = np.asarray(ravel_pytree(v["params"]["text_projection"])[0])
    with pytest.raises(Exception) as err:
        jd.step(i0, t0, i0 + 0.01, t0 + 0.01, jd.sample_indices(rs))
    assert type(err.value).__name__ == jax_error
    pcfg = Config(image_size=16, num_queries=4, mini_batch_size=2,
                  syn_steps=1, text_encoder_config="tiny", device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        Distiller(pcfg, build_bi_encoder(pcfg), images, texts, device="cpu")
