"""Port parity: the NF towers and their layers against the JAX package.

JAX parameters (flax init, gains and skipinit gains moved off their init
values so their placement is exercised) go through
``models/convert.params_from_jax`` into the port's modules; the same numpy
inputs go through both.  Tolerance 2e-4/2e-5 as
tests/test_nfnet_torch_mirror.py.  Also: the port's flat order is the
reference ``parameters()`` order the JAX package's ``.pt`` codec writes,
and the package imports nothing of JAX.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from multimodal_dataset_distillation_tpu.models import layers as jlayers
from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.models import torch_order
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu.models.projection import (
    ProjectionHead as JProjectionHead,
)
from multimodal_dataset_distillation_tpu_torch.models import layers, nfnet
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    flat_to_jax,
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.models.projection import (
    ProjectionHead,
)
from multimodal_dataset_distillation_tpu_torch.models.zoo import ImageTower
from multimodal_dataset_distillation_tpu_torch.utils.flat import (
    FlatParams,
    flatten_params,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _jiggle(params, seed=0):
    """Move gains and skipinit gains off 1/0."""
    rs = np.random.RandomState(seed)

    def f(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        leaf = np.asarray(leaf, np.float32)
        if name in ("gain", "skipinit_gain", "scale"):
            return (leaf + 0.3 * rs.randn(*leaf.shape)).astype(np.float32)
        if name == "bias":
            return (leaf + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(f, params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("k,stride,groups,gconv", [
    (3, 1, 1, False), (3, 2, 1, False), (1, 1, 1, False), (3, 2, 2, False),
    (3, 1, 2, True), (3, 1, 4, False)])
def test_wsconv_matches_jax(k, stride, groups, gconv):
    """TF-SAME padding (asymmetric at stride 2), timm eps placement,
    grouped convs, and the kernel route for grouped 3x3 stride 1."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    jconv = jlayers.WSConv(24, (k, k), strides=(stride, stride),
                           feature_group_count=groups)
    params = _jiggle(jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    conv = layers.WSConv(16, 24, k, stride=stride, groups=groups, gconv=gconv)
    assert conv.use_gconv == gconv
    conv.load_state_dict(params_from_jax(params, conv))
    got = conv(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_squeeze_excite_and_projection_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 5, 40).astype(np.float32)
    jse = jlayers.SqueezeExcite(40, rd_ratio=0.25)
    params = _jiggle(jse.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    se = layers.SqueezeExcite(40, rd_ratio=0.25)
    assert se.fc1.weight.shape == (8, 40, 1, 1)  # timm's 1x1-conv layout
    se.load_state_dict(params_from_jax(params, se))
    np.testing.assert_allclose(
        se(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1),
        np.asarray(jse.apply({"params": params}, jnp.asarray(x))),
        rtol=2e-4, atol=2e-5)

    t = rs.randn(3, 48).astype(np.float32)
    jhead = JProjectionHead(embedding_dim=48, projection_dim=32)
    params = _jiggle(jhead.init(jax.random.PRNGKey(2), jnp.asarray(t))["params"])
    head = ProjectionHead(48, 32)
    head.load_state_dict(params_from_jax(params, head))
    np.testing.assert_allclose(
        head(torch.from_numpy(t)).detach().numpy(),
        np.asarray(jhead.apply({"params": params}, jnp.asarray(t))),
        rtol=2e-4, atol=2e-5)


def test_dropout_and_droppath_draw_from_the_generator():
    x = torch.ones(64, 3, 2, 2)
    dp = layers.DropPath(0.5)
    assert dp(x) is x  # eval mode
    a = dp(x, True, torch.Generator().manual_seed(3))
    b = dp(x, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    per_sample = a.reshape(64, -1)
    assert set(per_sample.unique().tolist()) == {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()  # one draw per sample
    with pytest.raises(ValueError, match="Generator"):
        dp(x, True, None)
    d = layers.dropout(torch.ones(1000), 0.1, torch.Generator().manual_seed(0))
    assert torch.isclose(d[d != 0], torch.tensor(1 / 0.9)).all()
    assert 0 < int((d == 0).sum()) < 1000


def test_make_divisible_matches_jax():
    for v in np.linspace(1, 400, 97):
        for div in (4, 8):
            assert nfnet.make_divisible(v, div) == jnfnet.make_divisible(v, div)


@pytest.mark.parametrize("cfg_name,size", [("NF_TINY", 32), ("NFNET_L0", 64)])
def test_normfreenet_matches_jax(cfg_name, size):
    """The whole tower (deep_quad stem, every block, final conv, pool) with
    the grouped 3x3 convs on the kernel route (plain version on the CPU)."""
    jcfg = dataclasses.replace(getattr(jnfnet, cfg_name), drop_path_rate=0.0)
    rs = np.random.RandomState(0)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    jmodel = jnfnet.NormFreeNet(jcfg)
    params = _jiggle(jmodel.init(jax.random.PRNGKey(0),
                                 jnp.asarray(x))["params"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = nfnet.NormFreeNet(getattr(nfnet, cfg_name), gconv=True)
    model.load_state_dict(params_from_jax(params, model))
    with torch.no_grad():
        got = model(_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    # the flat route agrees with the state-dict route
    flat = np.asarray(ravel_pytree(params)[0])
    np.testing.assert_array_equal(flat_from_jax(flat, model),
                                  flatten_params(model).numpy())
    np.testing.assert_array_equal(
        flat_to_jax(flatten_params(model).numpy(), model), flat)


def test_bi_encoder_matches_jax():
    """VLBiEncoder (NF_TINY tower + projection head, kernels on): both
    embeddings and the (loss, acc) of its forward."""
    rs = np.random.RandomState(2)
    x = rs.randn(3, 32, 32, 3).astype(np.float32)
    t = rs.randn(3, 48).astype(np.float32)
    jmodel = JVLBiEncoder(image_encoder_name="nf_tiny", text_embedding=48,
                          image_embedding=128, proj_dropout=0.0)
    params = _jiggle(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 jnp.asarray(t))["params"])
    model = VLBiEncoder("nf_tiny", 48, 128, proj_dropout=0.0, gconv=True)
    for part in ("image_encoder", "text_projection"):
        getattr(model, part).load_state_dict(
            params_from_jax(params[part], getattr(model, part)))
    v = {"params": params}
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        np.testing.assert_allclose(
            model.encode_image(xt).numpy(),
            np.asarray(jmodel.apply(v, jnp.asarray(x),
                                    method=JVLBiEncoder.encode_image)),
            rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(
            model.project_text(tt).numpy(),
            np.asarray(jmodel.apply(v, jnp.asarray(t),
                                    method=JVLBiEncoder.project_text)),
            rtol=2e-4, atol=2e-5)
        loss, acc = model(xt, tt)
    jloss, jacc = jmodel.apply(v, jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4)
    assert float(acc) == float(jacc)


@pytest.mark.parametrize("name", ["nf_tiny", "nfnet"])
def test_flat_order_is_the_reference_snapshot_order(name):
    """The port's registration order and torch layouts are exactly the
    reference ``parameters()`` order that the JAX package's torch-order
    codec writes into ``.pt`` buffers, so those files concatenate as
    stored."""
    from multimodal_dataset_distillation_tpu.models.zoo import (
        ImageTower as JImageTower,
    )

    tower = ImageTower(name)
    tmpl = jax.eval_shape(
        lambda: JImageTower(name).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    codec = torch_order.codec_for_image_tower(tmpl)
    assert [tuple(s) for s in FlatParams(tower).shapes] == codec.torch_shapes
    jflat = np.arange(codec.total_size, dtype=np.float64)
    torch_list = codec.torch_from_flat(jflat)
    np.testing.assert_array_equal(
        flat_from_jax(jflat, tower),
        np.concatenate([t.reshape(-1) for t in torch_list]))


def test_package_imports_nothing_of_jax():
    banned = {"jax", "jaxlib", "flax", "optax",
              "multimodal_dataset_distillation_tpu"}
    files = sorted((REPO / "multimodal_dataset_distillation_tpu_torch")
                   .rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{f}: imports {n}"
