"""Port parity: the reference-flag shim (``parse_config``) against the JAX
package's, on the same command lines.  Every field the two ``Config``s
share must parse to the same value; only ``device`` differs (a runtime
field in both, not a flag)."""

import dataclasses

import pytest

from multimodal_dataset_distillation_tpu import config as jconfig
from multimodal_dataset_distillation_tpu_torch import config as tconfig
from test_torch_threads import share_cores  # noqa: F401 (autouse)

ARGVS = [
    [],
    ["--syn_steps", "8", "--expert_epochs=2", "--lr_img", "100",
     "--lr_txt=50.5", "--lr_lr", "1e-2", "--num_queries", "500"],
    # `type=bool` flags of the reference, parsed from strings
    ["--std", "True", "--image_pretrained", "False", "--distill", "1",
     "--transfer", "no", "--text_trainable=t", "--draw", "False"],
    # bool-valued fields that are not reference type=bool flags
    ["--parallel_eval", "False", "--pallas_gconv", "True", "--native_decode",
     "false", "--traj_prefetch", "0", "--fused_jvp", "y"],
    # store_true switches
    ["--zca", "--no_aug", "--device_augment", "--disable_wandb", "--basis"],
    ["--dsa", "False"], ["--dsa=True"],
    ["--mesh_shape", "4,2", "--mesh_axes", "data,model"],
    ["--max_files", "3", "--max_experts=2", "--profile_dir", "/tmp/p",
     "--dataset", "coco", "--image_encoder", "nf_tiny", "--lr_net", "0.03"],
    # unknown flags are warned about and ignored
    ["--not_a_flag", "7", "--syn_steps", "3", "--also_unknown"],
]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("device", "name")}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_parse_config_matches_jax(argv, capsys):
    want = jconfig.parse_config(argv)
    jout = capsys.readouterr().out
    got = tconfig.parse_config(argv)
    assert capsys.readouterr().out == jout   # the same unknown-flag warning
    assert _fields(got) == _fields(want)
    assert got.device == "cuda"


def test_name_and_defaults_config_pass_through():
    got = tconfig.parse_config(["--name", "run7"],
                               tconfig.Config(device="cpu", seed=4))
    assert (got.name, got.seed, got.device) == ("run7", 4, "cpu")
    assert jconfig.parse_config(["--name", "run7"]).name == "run7"


@pytest.mark.parametrize("argv", [["--std"], ["--dsa", "maybe"]])
def test_malformed_flags_fail_like_jax(argv):
    """A bare ``--std`` (reference type=bool needs a value) and a ``--dsa``
    outside {True, False} are argparse errors in both packages."""
    for parse in (jconfig.parse_config, tconfig.parse_config):
        with pytest.raises(SystemExit):
            parse(argv)


@pytest.mark.parametrize("argv", [
    [], ["--lr_net", "0.1"], ["--lr_net=0.1", "--seed", "3"],
    ["lr_net", "-x", "--std=True"]])
def test_explicit_flags_matches_jax(argv):
    assert tconfig.explicit_flags(argv) == jconfig.explicit_flags(argv)


def test_device_is_not_a_flag():
    import argparse
    parser = tconfig.add_reference_flags(argparse.ArgumentParser())
    flags = {a.dest for a in parser._actions}
    assert "device" not in flags
    assert flags - {"help"} == {f.name for f in dataclasses.fields(
        tconfig.Config)} - {"device"}
