"""The port's ``cli/eval_distilled`` refuses what it cannot run before it
reads any data: a card asked for and missing raises ``RuntimeError``, and
``get_dataset`` (and the distilled set's loader) is never reached.  Flags
that the JAX ``eval_distilled`` never reads are ignored, as there.  The
CLIP and ConvNeXt towers and the CLIP text tower run through it at toy
size."""

import numpy as np
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


@pytest.mark.parametrize("extra", [
    ["--image_encoder", "convnext"], ["--image_encoder", "clip"],
    ["--image_encoder", "convnext", "--transfer", "True"],
    ["--text_encoder", "clip"]])
def test_new_towers_run_the_eval_cli(tmp_path, monkeypatch, extra):
    """``eval_distilled.main`` at toy size on a 4-pair set (one student,
    one epoch; CLIP ViT-B/32 and ConvNeXt as narrow stand-ins with their
    layer kinds and widths, the tiny text towers): the test caption cache
    under the JAX package's name, computed by the configured text tower,
    and the nine metrics finite and in [0, 100]."""
    from test_torch_zoo_clip import narrow_towers

    narrow_towers(monkeypatch)
    monkeypatch.chdir(tmp_path)
    rs = np.random.RandomState(0)
    np.savez("distilled_0.npz",
             image_syn=rs.randn(4, 32, 32, 3).astype(np.float32),
             text_syn=rs.randn(4, 128).astype(np.float32),
             syn_lr_img=np.float32(0.05))
    argv = ["--dataset", "synthetic", "--image_encoder", "nf_tiny",
            "--image_size", "32", "--synthetic_size", "4",
            "--synthetic_test_size", "4", "--num_eval", "1",
            "--epoch_eval_train", "1", "--batch_train", "4",
            "--batch_size_test", "4", "--k_test", "4", "--image_pretrained",
            "False", "--text_encoder_config", "tiny", "--text_pretrained",
            "False", "--num_workers", "0", "--parallel_eval", "False",
            "--distilled_npz", "distilled_0.npz", *extra]
    cfg = parse_config(argv, Config(device="cpu"))
    (val,) = eval_distilled.main(cfg, argv=argv)
    assert len(val) == 9
    assert all(np.isfinite(v) and 0 <= v <= 100 for v in val.values())
    with np.load(f"synthetic_{cfg.text_encoder}_text_embed.npz") as z:
        assert z["bert_test_embed"].shape == (20, 128)


def test_missing_card_raises_before_data(no_data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eval_distilled.main(_cfg([], device="cuda"), argv=[])


@pytest.mark.parametrize("extra", [
    ["--device_augment", "True"], ["--zca", "True"],
    ["--mesh_shape", "2"], ["--stem_s2d", "True"]])
def test_flags_the_jax_eval_never_reads_are_ignored(no_data, extra):
    """The eval CLI, like the JAX one, does not read these and goes on to
    its data.  ``check_supported`` refuses a ``--mesh_shape`` that does not
    fit the world for the distill CLI; it runs the others too."""
    cfg = _cfg(extra)
    if extra[0] == "--mesh_shape":
        with pytest.raises(ValueError, match="multiplies to 2"):
            eval_distilled.check_supported(cfg)
    else:   # the distill CLI runs these (the s2d stem, ZCA, the augment)
        eval_distilled.check_supported(cfg)
    with pytest.raises(DataRead):
        eval_distilled.main(cfg, argv=[])


def test_stem_s2d_is_not_read_by_the_eval(monkeypatch):
    """The JAX eval CLI never sets its s2d gate from the config: the
    students' stems are plain unless ``MDD_STEM_S2D`` says otherwise."""
    built = []

    def keep(cfg):
        built.append(cfg)
        raise DataRead

    monkeypatch.setattr(eval_distilled, "get_dataset", lambda cfg: (
        None, None, None, None))
    monkeypatch.setattr(eval_distilled, "load_distilled", lambda p: (
        np.zeros((1, 32, 32, 3)), np.zeros((1, 128)), {}))
    monkeypatch.setattr(eval_distilled, "load_or_process_file",
                        lambda *a, **k: {"bert_test_embed": np.zeros(1)})
    monkeypatch.setattr(eval_distilled, "build_bi_encoder", keep)
    with pytest.raises(DataRead):
        eval_distilled.main(_cfg(["--stem_s2d", "True"]), argv=[])
    assert built and not built[0].stem_s2d


@pytest.mark.parametrize("encoder", ["clip", "convnext"])
def test_build_bi_encoder_builds_the_new_towers(encoder):
    """The CLIP ViT-B/32 and ConvNeXt-Tiny bi-encoders at full width, with
    the JAX ``build_bi_encoder``'s widths: 512 / 768 features, the
    projection from the text width (768 BERT-base, 512 CLIP-base) to them."""
    from multimodal_dataset_distillation_tpu.config import Config as JConfig
    from multimodal_dataset_distillation_tpu.models.clip_model import (
        build_bi_encoder as jbuild,
    )

    for text in ("bert", "clip"):
        m = build_bi_encoder(Config(image_encoder=encoder, text_encoder=text,
                                    device="cpu"))
        j = jbuild(JConfig(image_encoder=encoder, text_encoder=text))
        proj = m.text_projection.projection
        assert (proj.in_features, proj.out_features) == (
            j.text_embedding, j.image_embedding)
        assert type(m.image_encoder.model).__name__ in (
            "ClipVisionTransformer", "ConvNeXt")


@pytest.mark.parametrize("extra", [
    ["--image_encoder", "convnet"], ["--image_encoder", "vit"],
    ["--image_encoder", "resnet50"], ["--transfer", "True"],
    ["--image_encoder", "convnet", "--only_has_image_projection", "True"]])
def test_ported_towers_and_heads_reach_the_data(no_data, extra):
    """Every ported tower, the transfer head and the image projection (the
    JAX eval CLI runs them all) pass the start-up checks."""
    with pytest.raises(DataRead):
        eval_distilled.main(_cfg(extra), argv=[])
