"""Port parity: the ``MDD_PALLAS_GCONV`` override of ``cfg.pallas_gconv``.

``ops/gconv.py::configure`` resolves as the JAX gate
(``ops/pallas_gconv.py::enabled``) does on one device: the variable wins
when it is set, through the same ``env_bool`` parsing (empty is unset,
``0``/``off`` are False), else the config decides.  The JAX multi-device
force-off is left out on purpose (the port's ranks launch their own
kernels), so the JAX side is taken after ``set_enabled``, which clears it.
The towers built from a config put their grouped ``WSConv`` sites on the
kernel route exactly when the resolved value is True.  ``chip_smoke.py``
refuses to start while any of the three overrides is set.
"""

import sys

import pytest

from multimodal_dataset_distillation_tpu.ops import pallas_gconv as pg
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
    build_trainable_text,
)
from multimodal_dataset_distillation_tpu_torch.models.layers import WSConv
from multimodal_dataset_distillation_tpu_torch.ops import gconv
from test_torch_threads import share_cores  # noqa: F401 (autouse)

NFNET_SITES = 19      # NFNet-L0's grouped 3x3 stride-1 convs
ENV = "MDD_PALLAS_GCONV"


def set_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("env", [None, "", "0", "off", "1"])
def test_configure_resolves_as_the_jax_gate(monkeypatch, env, flag):
    set_env(monkeypatch, env)
    try:
        pg.set_enabled(flag)
        want = pg.enabled()
    finally:
        pg.set_enabled(False)
    assert gconv.configure(Config(pallas_gconv=flag)) is want
    assert want is (flag if env in (None, "") else env == "1")


@pytest.mark.parametrize("build", [build_bi_encoder, build_trainable_text])
@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("env", [None, "0", "1"])
def test_tower_sites_take_the_resolved_route(monkeypatch, env, flag,
                                             build):
    set_env(monkeypatch, env)
    cfg = Config(image_encoder="nfnet", image_size=224, pallas_gconv=flag,
                 text_encoder_config="tiny", device="cpu")
    model = build(cfg)
    convs = [m for m in model.image_encoder.modules()
             if isinstance(m, WSConv)]
    grouped = [m for m in convs
               if m.groups > 1 and m.kernel_size == 3 and m.stride == 1]
    assert len(grouped) == NFNET_SITES
    on = gconv.configure(cfg)
    assert sum(m.use_gconv for m in convs) == (NFNET_SITES if on else 0)
    assert all(m.use_gconv is on for m in grouped)


@pytest.mark.parametrize("name", ["MDD_PALLAS_GCONV", "MDD_STEM_S2D",
                                  "MDD_FUSED_JVP"])
def test_chip_smoke_refuses_each_override(monkeypatch, capsys, name):
    import chip_smoke

    for other in chip_smoke.ENV_OVERRIDES:
        monkeypatch.delenv(other, raising=False)
    assert chip_smoke.env_overrides() == []
    monkeypatch.setenv(name, "0")
    assert chip_smoke.env_overrides() == [name]
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 4      # before the card is looked for
    err = capsys.readouterr()
    assert name in err.err and err.out == ""
