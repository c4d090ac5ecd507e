"""Port parity: the outer distillation step over the CLIP ViT-B/32 and
ConvNeXt-Tiny students against the JAX Distiller.

The fixture of tests/test_torch_zoo_distill_c1.py (:func:`distill_parity`:
the same seeded weights, data, minibatch indices and expert segment
through both packages' ``Distiller``; nq=4, mb=2, syn_steps=2, float32,
dropout off).  Each tower at its published widths, cut in depth to keep
the JAX side's compile of the second-order step short: CLIP ViT-B/32 2 of
12 blocks (width 768, 12 heads) at 64^2 (4 patches and the class token);
ConvNeXt-Tiny one block a stage (dims 96/192/384/768, its stem,
downsamples, depthwise 7x7 convs and layer scales) at 32^2.  Their full
depth is held forward in tests/test_torch_zoo_clip.py.  2e-4 on per-step
students, 5e-3 on the loss and the meta-gradients.
"""

import dataclasses

import pytest

from multimodal_dataset_distillation_tpu.models import clip_vision as jcv
from multimodal_dataset_distillation_tpu.models import convnext as jcx
from multimodal_dataset_distillation_tpu_torch.models import (
    clip_vision,
    convnext,
)

from test_torch_zoo_distill_c1 import (
    check_meta_gradients,
    check_unroll,
    distill_parity,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE = {"clip": 64, "convnext": 32}
CUT = {
    "clip": (
        lambda: jcv.ClipVisionTransformer(dataclasses.replace(
            jcv.CLIP_VIT_B32, num_layers=2)),
        lambda size: clip_vision.ClipVisionTransformer(dataclasses.replace(
            clip_vision.CLIP_VIT_B32, num_layers=2), image_size=size)),
    "convnext": (
        lambda: jcx.ConvNeXt(depths=(1, 1, 1, 1)),
        lambda size: convnext.ConvNeXt(depths=(1, 1, 1, 1))),
}


@pytest.fixture(scope="module", params=list(CUT))
def parity(request):
    name = request.param
    return distill_parity(name, CUT[name], SIZE[name])


def test_unroll_matches_jax(parity):
    check_unroll(parity)


def test_meta_gradients_match_jax(parity):
    check_meta_gradients(parity)
