"""The port's ``cli/eval_distilled`` refuses what it cannot run before it
reads any data: each unported flag raises ``NotImplementedError`` naming
its ROADMAP item, a card asked for and missing raises ``RuntimeError``, and
``get_dataset`` (and the distilled set's loader) is never reached.  Flags
that the JAX ``eval_distilled`` never reads are ignored, as there."""

import pytest
import torch

from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled
from multimodal_dataset_distillation_tpu_torch.config import Config, parse_config
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

BASE = ["--dataset", "synthetic", "--image_encoder", "nf_tiny",
        "--image_size", "32", "--distilled_npz", "no_such_file.npz"]


class DataRead(Exception):
    """Raised in place of reading data."""


@pytest.fixture
def no_data(monkeypatch):
    def refuse(*a, **k):
        raise DataRead

    monkeypatch.setattr(eval_distilled, "get_dataset", refuse)
    monkeypatch.setattr(eval_distilled, "load_distilled", refuse)


def _cfg(extra, device="cpu"):
    return parse_config(BASE + extra, Config(device=device))


@pytest.mark.parametrize("extra,match", [
    (["--image_encoder", "convnext"], "--image_encoder=convnext"),
    (["--image_encoder", "clip"], "--image_encoder=clip"),
    (["--image_encoder", "convnext", "--transfer", "True"],
     "--image_encoder=convnext"),
    (["--text_encoder", "clip"], "--text_encoder=clip"),
])
def test_unported_flag_raises_before_data(no_data, extra, match):
    with pytest.raises(NotImplementedError, match=match) as err:
        eval_distilled.main(_cfg(extra), argv=[])
    assert "ROADMAP" in str(err.value)


def test_missing_card_raises_before_data(no_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eval_distilled.main(_cfg([], device="cuda"), argv=[])


@pytest.mark.parametrize("extra", [
    ["--device_augment", "True"], ["--zca", "True"],
    ["--mesh_shape", "2"], ["--stem_s2d", "True"]])
def test_flags_the_jax_eval_never_reads_are_ignored(no_data, extra):
    """The eval CLI, like the JAX one, does not read these and goes on to
    its data.  ``check_supported`` refuses them for the distill CLI, all
    but ``--device_augment``, which the distill CLI runs too."""
    cfg = _cfg(extra)
    if extra[0] != "--device_augment":
        with pytest.raises(NotImplementedError):
            eval_distilled.check_supported(cfg)
    with pytest.raises(DataRead):
        eval_distilled.main(cfg, argv=[])


@pytest.mark.parametrize("encoder", ["clip", "convnext"])
def test_build_bi_encoder_names_the_roadmap_item(encoder):
    """An unported tower is a NotImplementedError naming ROADMAP item 16,
    not a KeyError from the feature-width table."""
    with pytest.raises(NotImplementedError, match="item 16"):
        build_bi_encoder(Config(image_encoder=encoder, device="cpu"))


@pytest.mark.parametrize("extra", [
    ["--image_encoder", "convnet"], ["--image_encoder", "vit"],
    ["--image_encoder", "resnet50"], ["--transfer", "True"],
    ["--image_encoder", "convnet", "--only_has_image_projection", "True"]])
def test_ported_towers_and_heads_reach_the_data(no_data, extra):
    """Every ported tower, the transfer head and the image projection (the
    JAX eval CLI runs them all) pass the start-up checks."""
    with pytest.raises(DataRead):
        eval_distilled.main(_cfg(extra), argv=[])
