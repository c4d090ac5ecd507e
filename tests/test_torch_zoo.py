"""Port parity: every image tower of the zoo and the DC ``get_network``
surface against the JAX package.

JAX variables (the flax tree, with seeded values: scales, gains, biases
and BatchNorm running averages away from their init values, so that
their placement is exercised) go through ``models/convert.params_from_jax`` into the port's
modules; the same seeded numpy images go through both, in eval mode and in
train mode (BatchNorm on batch statistics, its running averages moved as
flax moves them).  Tolerances as tests/test_torch_nfnet.py: 2e-4 relative
with an absolute floor of 2e-5 of the largest output (the convs and
matmuls sum in other orders).  Also: the feature-width table, the
``--transfer`` and image-projection heads, and ``get_eval_pool``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.models import zoo as jzoo
from multimodal_dataset_distillation_tpu.models.clip_model import (
    build_bi_encoder as jbuild,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.models import zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import (
    flatten_params,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

TOWERS = ["nfnet", "nf_tiny", "nf_resnet50", "nf_regnet", "vit", "vit_tiny",
          "resnet50", "resnet18", "resnet18_gn", "convnet", "convnet_tiny"]
# NFNet-L0 and NF_TINY forward: tests/test_torch_nfnet.py; vit_tiny is vit
FORWARD = [n for n in TOWERS if n not in ("nfnet", "nf_tiny", "vit_tiny")]


def seeded_leaf(name, shape, rs):
    """A numpy value for a flax leaf, from the seed: kernels and embeddings
    at unit fan-in variance, norm scales and conv gains 1 +- 0.3,
    skipinit gains 0.5 +- 0.1, biases, BatchNorm means and CLS tokens
    +- 0.1, BatchNorm variances e^(+-0.3), position embeddings 0.02."""
    z = rs.randn(*shape)
    if name in ("kernel", "embedding"):
        z = z / np.sqrt(max(1, int(np.prod(shape[:-1]))))
    elif name in ("gain", "scale"):
        z = 1.0 + 0.3 * z
    elif name == "skipinit_gain":
        z = 0.5 + 0.1 * z
    elif name == "var":
        z = np.exp(0.3 * z)
    elif name == "pos_embed":
        z = 0.02 * z
    else:   # bias, mean, cls_token
        z = 0.1 * z
    return np.asarray(z, np.float32)


def jax_variables(module, *args, seed=0, **kw):
    """Variables of a flax module for ``args``, with the tree of its
    ``init`` (shapes only: ``jax.eval_shape``, no flax initializer runs)
    and seeded values (:func:`seeded_leaf`)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), **kw))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: seeded_leaf(path[-1].key, leaf.shape, rs), shapes)


def jit_apply(module):
    """``module.apply`` compiled once (flax's eager apply compiles op by op,
    the most of a deep tower's cost on the CPU)."""
    return jax.jit(module.apply, static_argnames=("train", "mutable",
                                                  "method"))


def load_port(module, variables):
    """Carry JAX ``variables`` (params and, if any, batch_stats) into the
    port's ``module``."""
    module.load_state_dict(params_from_jax(
        variables["params"], module, variables.get("batch_stats")))
    return module


def assert_close(got, want, rtol=2e-4, floor=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _tower_pair(name, size, seed=0):
    """(JAX ImageTower, its variables, the port's ImageTower loaded with
    them, images)."""
    x = np.random.RandomState(seed).randn(3, size, size, 3).astype(np.float32)
    jt = jzoo.ImageTower(name)
    v = jax_variables(jt, x, seed=seed)
    tower = load_port(zoo.ImageTower(name, gconv=True, image_size=size), v)
    return jt, v, tower, x


# train mode through ResNet-50's 53 BatchNorms on batch statistics: the
# JAX package's own float32 output is 3.5e-4 of the largest output away
# from a float64 run of the same tower at this size (XLA's CPU reductions
# sum the statistics sequentially; the port's is 6e-5 away), so it is held
# at 1e-3 of the largest output; every other case at 2e-5 of it
TRAIN_FLOOR = {"resnet50": 1e-3}


@pytest.mark.parametrize("name", FORWARD)
def test_tower_forward_matches_jax(name):
    """Eval mode (BatchNorm on its running averages), and train mode where
    it differs (BatchNorm on batch statistics; the other towers draw
    nothing in train mode and compute as in eval): outputs, and the
    running averages flax's train step writes."""
    size = 64 if name.startswith("resnet") else 32
    jt, v, tower, x = _tower_pair(name, size)
    apply = jit_apply(jt)
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    assert_close(got, apply(v, jnp.asarray(x), train=False))
    assert tuple(got.shape) == (3, zoo.IMAGE_FEATURE_DIMS[name])
    if "batch_stats" not in v:
        return
    want, state = apply(v, jnp.asarray(x), train=True,
                        mutable=("batch_stats",))
    with torch.no_grad():
        assert_close(tower(torch.from_numpy(x), train=True), want,
                     floor=TRAIN_FLOOR.get(name, 2e-5))
    want = params_from_jax(v["params"], tower, state["batch_stats"])
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert_close(tower.state_dict()[k], want[k],
                     floor=TRAIN_FLOOR.get(name, 2e-5))


# every spec of the JAX tests/test_models.py grammar test, and the rest of
# the grammar: each depth/width/activation/norm/pooling variant that builds
# another net than the default ConvNet (AR, IN and AP build it), KIP, GAP,
# the smallest and largest VGG and a BN one, the ResNet18 family
SPECS = ["MLP", "LeNet", "AlexNet", "ConvNet", "ConvNetD1", "ConvNetD2",
         "ConvNetD4", "ConvNetW32", "ConvNetW64", "ConvNetAS", "ConvNetAL",
         "ConvNetNN", "ConvNetBN", "ConvNetLN", "ConvNetGN", "ConvNetNP",
         "ConvNetMP", "ConvNetKIP", "ConvNetGAP", "VGG11", "VGG11BN", "VGG19",
         "ResNet18", "ResNet18_AP", "ResNet18BN_AP"]


@pytest.mark.parametrize("spec", SPECS)
def test_get_network_matches_jax(spec):
    """The same class and outputs for each ``get_network`` spec, in eval
    mode and (for the nets with BatchNorm) in train mode.  The VGGs at
    64^2: at 32^2 their last block normalises 2x2 maps per image and
    channel, where float32 sums in other orders part by more than the
    tolerance."""
    size = 64 if spec.startswith("VGG") else 32
    jnet = jzoo.get_network(spec, 3, 10)
    net = zoo.get_network(spec, 3, 10, (size, size))
    assert type(net).__name__ == type(jnet).__name__
    x = np.random.RandomState(1).randn(4, size, size, 3).astype(np.float32)
    v = jax_variables(jnet, x, seed=1, train=False)
    load_port(net, v)
    apply = jit_apply(jnet)
    with torch.no_grad():
        assert_close(net(nchw(x)), apply(v, jnp.asarray(x), train=False))
    if "batch_stats" in v:
        want, _ = apply(v, jnp.asarray(x), train=True,
                        mutable=("batch_stats",))
        with torch.no_grad():
            assert_close(net(nchw(x), train=True), want)
    # the flat route agrees with the state-dict route
    flat = np.concatenate([np.asarray(a).reshape(-1) for a in
                           jax.tree_util.tree_leaves(v["params"])])
    np.testing.assert_array_equal(flat_from_jax(flat, net),
                                  flatten_params(net).numpy())


@pytest.mark.parametrize("mode", list("MWDAPNSC") + ["X"])
def test_get_eval_pool_matches_jax(mode):
    for model in ("ConvNet", "ConvNetBN", "ResNet18"):
        want = jzoo.get_eval_pool(mode, model, "VGG11")
        assert zoo.get_eval_pool(mode, model, "VGG11") == want
        for spec in want:
            zoo.get_network(spec, 3, 10)   # every pool member builds


def test_feature_dims_match_jax():
    for name in TOWERS:
        assert zoo.IMAGE_FEATURE_DIMS[name] == jzoo.IMAGE_FEATURE_DIMS[name]
        _, dim = jzoo.create_image_encoder(name)
        assert zoo.feature_dim(name) == dim
    tower, dim = zoo.create_image_encoder("nfnet", True, image_size=32)
    assert dim == 1000 and tower.model.head.fc.out_features == 1000
    assert zoo.feature_dim("nfnet", True) == jzoo.create_image_encoder(
        "nfnet", True)[1] == 1000
    # the port's table is JAX's, every tower included
    assert zoo.IMAGE_FEATURE_DIMS == jzoo.IMAGE_FEATURE_DIMS


@pytest.mark.parametrize("kw", [
    dict(image_encoder="nfnet", transfer=True),
    dict(image_encoder="convnet", only_has_image_projection=True),
    dict(image_encoder="vit", transfer=True),
    dict(image_encoder="nf_regnet")])
def test_bi_encoder_heads_match_jax(kw):
    """``--transfer`` (nfnet's 1000-class head) and the image projection:
    the same widths and the same embeddings and loss as the JAX
    bi-encoder, from the same weights."""
    size = 32
    jmodel = jbuild(JConfig(image_size=size, text_encoder_config="tiny",
                            **kw))
    model = build_bi_encoder(Config(image_size=size, device="cpu",
                                    text_encoder_config="tiny",
                                    pallas_gconv=True, **kw))
    assert model.text_projection.projection.out_features == (
        jmodel.image_embedding)
    assert (model.image_projection is not None) == (
        jmodel.only_image_projection)
    rs = np.random.RandomState(2)
    x = rs.randn(3, size, size, 3).astype(np.float32)
    t = rs.randn(3, 128).astype(np.float32)
    v = jax_variables(jmodel, x, t, seed=2)
    for part, mod in model.named_children():
        if mod is not None:
            mod.load_state_dict(params_from_jax(v["params"][part], mod))
    apply = jit_apply(jmodel)
    with torch.no_grad():
        assert_close(model.encode_image(torch.from_numpy(x)),
                     apply(v, jnp.asarray(x),
                           method=type(jmodel).encode_image))
        loss, _ = model(torch.from_numpy(x), torch.from_numpy(t))
    jloss, _ = apply(v, jnp.asarray(x), jnp.asarray(t))
    assert_close(float(loss), float(jloss))


def test_nf_regnet_grouped_sites():
    """NF-RegNet-B1's stride-1 grouped 3x3s, which take the gconv kernels:
    16 sites at 8 channels per group, 88/184/360/736 channels (11/23/45/92
    groups), at 56/28/14/7 pixels for a 224^2 image, as the JAX tree's
    shapes say."""
    tower = zoo.ImageTower("nf_regnet", gconv=True)
    seen = {}

    def hook(mod, inp, out):
        key = (inp[0].shape[-1], mod.weight.shape[0], mod.groups)
        seen[key] = seen.get(key, 0) + 1

    sites = [m for m in tower.modules()
             if getattr(m, "use_gconv", False)]
    for m in sites:
        m.register_forward_hook(hook)
    with torch.no_grad():
        tower(torch.zeros(1, 224, 224, 3))
    assert seen == {(56, 88, 11): 1, (28, 184, 23): 3, (14, 360, 45): 6,
                    (7, 736, 92): 6}
    assert all(m.weight.shape[1] == 8 for m in sites)
    tmpl = jax.eval_shape(lambda: jzoo.ImageTower("nf_regnet").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))["params"]
    jgroups = sorted(
        (leaf.shape[3], leaf.shape[3] // leaf.shape[2])
        for path, leaf in jax.tree_util.tree_leaves_with_path(tmpl)
        if path[-2].key == "conv2" and path[-1].key == "kernel"
        and not path[-3].key.endswith("block0"))
    assert jgroups == sorted((c, g) for _, c, g in seen for _ in range(
        seen[(_, c, g)]))
