"""The port's towers speak timm's / torchvision's names and the reference's
``parameters()`` order.

* A port tower's state dict is a timm / torchvision checkpoint to the JAX
  package: ``import_torch.load_image_tower_weights`` loads it (BatchNorm
  running averages included) and the JAX tower then gives the port's
  outputs.
* The port's flat order is the reference snapshot order that the JAX
  package's ``torch_order`` codec writes into ``.pt`` buffers, tower by
  tower, so those files concatenate as stored.
* ``TIMM_CKPT_NAMES`` and the local-checkpoint loader agree with JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.models import import_torch
from multimodal_dataset_distillation_tpu.models import torch_order
from multimodal_dataset_distillation_tpu.models import zoo as jzoo
from multimodal_dataset_distillation_tpu_torch.models import zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import FlatParams

from test_torch_zoo import FORWARD, assert_close, jax_variables, jit_apply
from test_torch_threads import share_cores  # noqa: F401 (autouse)


def _random_tower(name, size, seed=0):
    """A port tower with seeded weights moved off their init values
    (BatchNorm running averages too)."""
    tower = VLBiEncoder(name, 128, zoo.feature_dim(name),
                        image_size=size).image_encoder
    init_bi_encoder(tower, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, t in tower.state_dict().items():
            if n.endswith(("bias", "gain", "running_mean")) or (
                    t.dim() == 1 and n.endswith("weight")):
                t.add_(0.2 * torch.randn(t.shape, generator=gen))
            elif n.endswith("running_var"):
                t.mul_(torch.exp(0.3 * torch.randn(t.shape, generator=gen)))
    return tower


@pytest.mark.parametrize("arch", ["nfnet", "nf_resnet50", "nf_regnet", "vit",
                                  "resnet50", "resnet18"])
def test_port_state_dict_loads_as_a_timm_checkpoint_in_jax(arch):
    size = 64 if arch.startswith("resnet") else 32
    tower = _random_tower(arch, size)
    sd = {k: v.numpy() for k, v in tower.model.state_dict().items()}
    x = np.random.RandomState(3).randn(2, size, size, 3).astype(np.float32)
    jt = jzoo.ImageTower(arch)
    v = {k: {"image_encoder": t}
         for k, t in jax_variables(jt, x, seed=9).items()}
    v = import_torch.load_image_tower_weights(v, sd, arch=arch)
    want = jit_apply(jt)({k: t["image_encoder"] for k, t in v.items()},
                         jnp.asarray(x), train=False)
    with torch.no_grad():
        assert_close(tower(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", FORWARD)   # NF-L0, NF_TINY: test_torch_nfnet
def test_flat_order_is_the_codec_torch_order(name):
    tower = zoo.ImageTower(name, image_size=32)
    tmpl = jax.eval_shape(lambda: jzoo.ImageTower(name).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    codec = torch_order.codec_for_image_tower(tmpl)
    assert [tuple(s) for s in FlatParams(tower).shapes] == codec.torch_shapes
    jflat = np.arange(codec.total_size, dtype=np.float64)
    np.testing.assert_array_equal(
        flat_from_jax(jflat, tower),
        np.concatenate([t.reshape(-1) for t in codec.torch_from_flat(jflat)]))


def test_timm_checkpoint_names_match_jax():
    assert zoo.TIMM_CKPT_NAMES == import_torch._TIMM_CKPT_NAMES


@pytest.mark.parametrize("arch", ["nfnet", "resnet18", "vit"])
def test_local_checkpoint_loads_strictly(arch, tmp_path, monkeypatch):
    """A timm / torchvision file found through ``$MDD_TIMM_CKPT_<ARCH>``
    loads into the tower: the classifier kept where the tower has one,
    dropped where it is headless (nfnet), BatchNorm's
    ``num_batches_tracked`` dropped; JAX finds the same file."""
    src = _random_tower(arch, 32, seed=1)
    sd = dict(src.model.state_dict())
    if arch == "nfnet":
        sd["head.fc.weight"] = torch.zeros(1000, 2304)
        sd["head.fc.bias"] = torch.zeros(1000)
    if arch == "resnet18":
        sd["bn1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": sd}, path)
    monkeypatch.setenv(f"MDD_TIMM_CKPT_{arch.upper()}", str(path))
    got, where = zoo.load_timm_state_dict(arch)
    assert where == import_torch.find_local_timm_checkpoint(arch) == str(path)
    dst = zoo.ImageTower(arch, image_size=32)
    zoo.load_timm_image_tower(dst, got)
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
