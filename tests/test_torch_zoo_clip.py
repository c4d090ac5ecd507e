"""Port parity: the CLIP ViT-B/32, ConvNeXt-Tiny and ModifiedResNet towers
against the JAX package's ``models/clip_vision.py``, ``models/convnext.py``
and ``models/modified_resnet.py``.

Each at its published widths and depth, on small images so that the JAX
side's CPU time stays short (CLIP ViT-B/32 at 64^2: 4 patches and the
class token; ConvNeXt-Tiny at 32^2; the CLIP ResNet-50 layout at 64^2).
Seeded JAX variables go through ``models/convert.params_from_jax`` into
the port's modules, the same seeded numpy images through both.  1e-4
relative, with an absolute floor of 1e-5 of the largest output: the
convs and matmuls sum in other orders, and flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 where torch centres first (float32 round-off
apart).  ModifiedResNet in eval mode and in train mode (its BatchNorms on
batch statistics, the running averages moved as flax moves them).  Also:
the zoo's registration of ``clip`` and ``convnext`` (widths, the flax
auto-names, the flat orders), the seeded init of the new leaves, and the
HF-format import of the CLIP vision tower from a toy
``transformers.CLIPModel``.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.models import clip_vision as jcv
from multimodal_dataset_distillation_tpu.models import modified_resnet as jmr
from multimodal_dataset_distillation_tpu.models import zoo as jzoo
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.models import (
    clip_vision,
    convnext,
    modified_resnet,
    zoo,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    flat_to_jax,
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import (
    flatten_params,
)

from test_torch_zoo import assert_close, jax_variables, jit_apply, load_port
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZES = {"clip": 64, "convnext": 32}

# narrow stand-ins for the CLI runs of tests/test_torch_{buffer,distill,
# eval}_cli*.py: the towers' layer kinds and output widths (512, 768), a
# fraction of their parameters
NARROW = {
    "clip": lambda size: clip_vision.ClipVisionTransformer(
        clip_vision.ClipVisionConfig(width=64, num_layers=1, num_heads=2),
        image_size=size),
    "convnext": lambda size: convnext.ConvNeXt((1, 1, 1, 1),
                                               (16, 32, 64, 768)),
}


def narrow_towers(monkeypatch):
    """``zoo.build_tower`` builds the :data:`NARROW` towers for ``clip``
    and ``convnext``."""
    build = zoo.build_tower

    def narrow(name, transfer=False, gconv=False, image_size=224,
               stem_s2d=False):
        if name in NARROW:
            return NARROW[name](image_size)
        return build(name, transfer, gconv, image_size, stem_s2d)

    monkeypatch.setattr(zoo, "build_tower", narrow)


def _close(got, want):
    assert_close(got, want, rtol=1e-4, floor=1e-5)


@pytest.fixture(scope="module", params=["clip", "convnext"])
def tower_pair(request):
    """(name, JAX ImageTower variables, the port's ImageTower loaded with
    them, images, JAX output)."""
    name = request.param
    size = SIZES[name]
    x = np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32)
    jt = jzoo.ImageTower(name)
    v = jax_variables(jt, x, seed=2)
    tower = load_port(zoo.ImageTower(name, image_size=size), v)
    want = np.asarray(jit_apply(jt)(v, jnp.asarray(x), train=False))
    return name, v, tower, x, want


def test_tower_forward_matches_jax(tower_pair):
    name, _, tower, x, want = tower_pair
    with torch.no_grad():
        got = tower(torch.from_numpy(x))
    assert tuple(got.shape) == (2, zoo.IMAGE_FEATURE_DIMS[name])
    _close(got, want)
    with torch.no_grad():   # nothing in either tower is random
        torch.testing.assert_close(tower(torch.from_numpy(x), train=True),
                                   got, rtol=0, atol=0)


def test_flat_orders_roundtrip(tower_pair):
    """The JAX ravel order and the port's flat order map onto each other
    (the ``.npz`` buffers and ``Distiller.unroll``'s vectors)."""
    _, v, tower, _, _ = tower_pair
    flat = np.concatenate([np.asarray(a).reshape(-1) for a in
                           jax.tree_util.tree_leaves(v["params"])])
    port = flat_from_jax(flat, tower)
    np.testing.assert_array_equal(port, flatten_params(tower).numpy())
    np.testing.assert_array_equal(flat_to_jax(port, tower), flat)


def test_bf16_forward_is_finite(tower_pair):
    """The distill step's dtype: bfloat16 weights and images promote as in
    flax (the attention and every layer after it in float32 on CLIP)."""
    name, _, tower, x, want = tower_pair
    t = zoo.ImageTower(name, image_size=SIZES[name])
    t.load_state_dict(tower.state_dict())
    t = t.to(torch.bfloat16)
    with torch.no_grad():
        got = t(torch.from_numpy(x).bfloat16()).float()
    assert torch.isfinite(got).all()
    err = float((got - torch.from_numpy(want)).norm()
                / np.linalg.norm(want))
    assert err < 5e-2, err


def test_zoo_registers_clip_and_convnext():
    for name in ("clip", "convnext"):
        assert zoo.feature_dim(name) == jzoo.create_image_encoder(name)[1]
    assert set(zoo.IMAGE_FEATURE_DIMS) == set(jzoo.IMAGE_FEATURE_DIMS)
    assert zoo.JAX_TOWER_KEYS[clip_vision.ClipVisionTransformer] == \
        "ClipVisionTransformer_0"
    assert zoo.JAX_TOWER_KEYS[convnext.ConvNeXt] == "ConvNeXt_0"
    for name in ("clip", "convnext"):   # at 224^2, the JAX tree's size
        shapes = jax.eval_shape(lambda: jzoo.ImageTower(name).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
        t = zoo.ImageTower(name, image_size=224)
        assert sum(p.numel() for p in t.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert t.model.head is None
    assert zoo.ImageTower("clip").model.positional_embedding.shape == (
        50, 768)


@pytest.mark.parametrize("name", ["clip", "convnext"])
def test_init_bi_encoder_draws_the_jax_initializers(name):
    """class/positional embeddings normal(0.02), proj normal(0.01), layer
    scales 1e-6, depthwise kernels lecun-normal on their fan-in of 49,
    norm scales 1, biases 0; the same seed gives the same weights."""
    cfg = Config(image_encoder=name, image_size=SIZES[name], device="cpu",
                 text_encoder_config="tiny")
    a = init_bi_encoder(build_bi_encoder(cfg), 3)
    b = init_bi_encoder(build_bi_encoder(cfg), 3)
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)
    m = a.image_encoder.model
    if name == "clip":
        for p, std in ((m.class_embedding, 0.02),
                       (m.positional_embedding, 0.02), (m.proj, 0.01)):
            assert abs(float(p.std()) - std) < 0.3 * std
        assert float(m.ln_pre.weight.min()) == 1.0
    else:
        block = m.stages[2][4]
        assert torch.all(block.gamma == 1e-6)
        std = float(block.dwconv.weight.std())
        assert abs(std - 49 ** -0.5) < 0.1 * 49 ** -0.5
        assert float(block.dwconv.bias.abs().max()) == 0.0


@pytest.fixture(scope="module")
def resnet_pair():
    x = np.random.RandomState(4).randn(4, 64, 64, 3).astype(np.float32)
    jm = jmr.ModifiedResNet()
    v = jax_variables(jm, x, seed=4, train=False)
    net = load_port(modified_resnet.ModifiedResNet(input_resolution=64), v)
    return jm, v, net, x


def test_modified_resnet_eval_matches_jax(resnet_pair):
    jm, v, net, x = resnet_pair
    want = jit_apply(jm)(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert tuple(got.shape) == (4, 1024)
    _close(got, want)


def test_modified_resnet_train_matches_jax(resnet_pair):
    """Train mode: batch statistics, and the running averages flax writes
    (a fresh copy of the net: train mode moves them)."""
    jm, v, _, x = resnet_pair
    net = load_port(modified_resnet.ModifiedResNet(input_resolution=64), v)
    want, state = jit_apply(jm)(v, jnp.asarray(x), train=True,
                                mutable=("batch_stats",))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                  train=True)
    # 55 BatchNorms on batch statistics: held as tests/test_torch_zoo.py
    # holds ResNet-50's train mode (XLA's CPU reductions sum in sequence)
    assert_close(got, want, rtol=1e-4, floor=1e-3)
    stats = params_from_jax(v["params"], net, state["batch_stats"])
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 55
    moved = 0
    for k in keys:
        assert_close(net.state_dict()[k], stats[k], rtol=1e-4, floor=1e-3)
        moved += not torch.equal(net.state_dict()[k],
                                 params_from_jax(v["params"], net,
                                                 v["batch_stats"])[k])
    assert moved == len(keys)


def test_clip_vision_import_from_real_hf_model():
    """The port's CLIP vision tower from a toy ``transformers.CLIPModel``'s
    state dict against HF's own ``get_image_features``, and against the
    JAX package's import of the same state dict."""
    transformers = pytest.importorskip("transformers")
    vision_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, image_size=64, patch_size=16,
        hidden_act="quick_gelu", layer_norm_eps=1e-5)
    text_cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=16, hidden_act="quick_gelu")
    torch.manual_seed(3)
    hf = transformers.CLIPModel(transformers.CLIPConfig(
        text_config=text_cfg.to_dict(), vision_config=vision_cfg.to_dict(),
        projection_dim=24)).eval()
    cfg = clip_vision.ClipVisionConfig(image_size=64, patch_size=16,
                                       width=32, num_layers=2, num_heads=2,
                                       embed_dim=24)
    tower = clip_vision.ClipVisionTransformer(cfg)
    tower.load_state_dict(clip_vision.clip_vision_state_dict_from_hf(
        hf.state_dict(), cfg))
    x = np.random.RandomState(5).randn(3, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        want = hf.get_image_features(pixel_values=torch.from_numpy(x))
        got = tower(torch.from_numpy(x))
    _close(got, want.numpy())
    # the JAX mapping (inlined in try_hf_clip_vision_weights) on the same
    # state dict, through its module
    jm = jcv.ClipVisionTransformer(jcv.ClipVisionConfig(
        image_size=64, patch_size=16, width=32, num_layers=2, num_heads=2,
        embed_dim=24))

    class Fake:   # stands in for CLIPModel.from_pretrained
        @staticmethod
        def from_pretrained(*a, **k):
            return hf

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "transformers",
                   types.SimpleNamespace(CLIPModel=Fake))
        jv = jcv.try_hf_clip_vision_weights(jm.cfg)
    assert jv is not None
    want_sd = params_from_jax(jv["params"], tower)
    for k, p in tower.state_dict().items():
        torch.testing.assert_close(p, want_sd[k], rtol=0, atol=0, msg=k)


def test_hf_lookup_without_transformers_is_none(monkeypatch):
    """No ``transformers`` (the card's machine has none): the lookup fails
    quietly and the random init follows, as in the JAX package."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert clip_vision.try_hf_clip_vision_weights() is None
