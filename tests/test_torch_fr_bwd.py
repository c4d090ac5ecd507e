"""Port parity: the distill step in each meta-backward orientation against
the JAX Distiller at the same setting.

``fr_bwd="rof"`` with ``fused_jvp`` on (the JAX defaults) and off, and
``fr_bwd="for"``: the fixture of tests/test_torch_zoo_distill_c1.py
(:func:`distill_parity`: the same seeded weights, data, minibatch indices
and expert segment through both packages' ``Distiller``; nq=4, mb=2,
syn_steps=2, float32, dropout off) on NF_TINY (an NFNet at toy size: its
stem, transition and 1x1 WSConvs on the merged-tangent conv under
``fused_jvp``, its grouped 3x3s on the ``GConv3x3`` Functions' forward-
mode rules, plain versions on the CPU) and on ViT-Tiny/16 cut to 2 blocks
at 32^2 (LayerNorm and softmax in their forward-AD forms).  2e-4 on
per-step students, 5e-3 on the loss and the meta-gradients.
"""

import pytest

from multimodal_dataset_distillation_tpu.models import nfnet as jnfnet
from multimodal_dataset_distillation_tpu.models import vit as jvit
from multimodal_dataset_distillation_tpu_torch.models import nfnet, vit

from test_torch_zoo_distill_c1 import (
    CFG,
    check_meta_gradients,
    check_unroll,
    distill_parity,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE = 32
CUT = {
    "nf_tiny": (lambda: jnfnet.nf_tiny(num_classes=0),
                lambda size: nfnet.NormFreeNet(nfnet.NF_TINY, gconv=True)),
    "vit": (lambda: jvit.VisionTransformer(depth=2),
            lambda size: vit.VisionTransformer(depth=2, image_size=size)),
}
MODES = {"rof_fused": dict(fr_bwd="rof", fused_jvp=True),
         "rof_plain": dict(fr_bwd="rof", fused_jvp=False),
         "for": dict(fr_bwd="for")}


@pytest.fixture(scope="module", params=[(t, m) for t in CUT for m in MODES],
                ids="-".join)
def parity(request):
    name, mode = request.param
    return distill_parity(name, CUT[name], SIZE,
                          {**CFG, "hvp_mode": "forward", **MODES[mode]})


def test_unroll_matches_jax(parity):
    check_unroll(parity)


def test_meta_gradients_match_jax(parity):
    check_meta_gradients(parity)
