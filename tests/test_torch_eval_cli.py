"""The port's ``cli/eval_distilled`` entry point on the CPU, at a tiny
synthetic size: ``.npz`` and ``--save_pt`` inputs, the ``--lr_net``
precedence against the JAX CLI, the missing text cache, and the eval
students' initializer."""

import sys

import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.cli import eval_distilled as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled
from multimodal_dataset_distillation_tpu_torch.cli.distill import (
    make_eval_initializer,
)
from multimodal_dataset_distillation_tpu_torch.config import Config, parse_config
from multimodal_dataset_distillation_tpu_torch.models import zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    build_bi_encoder,
    init_bi_encoder,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

KEYS = ["txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1", "img_r5",
        "img_r10", "img_r_mean", "r_mean"]
TINY = ["--dataset", "synthetic", "--image_encoder", "nf_tiny",
        "--image_size", "32", "--synthetic_size", "2",
        "--synthetic_test_size", "4", "--num_eval", "2", "--batch_train", "4",
        "--batch_size_test", "3", "--k_test", "8", "--image_pretrained",
        "False", "--pallas_gconv", "True", "--num_workers", "2"]


def _write_set(tmp_path, fmt, n=5, lr=True):
    rs = np.random.RandomState(0)
    images = rs.randn(n, 32, 32, 3).astype(np.float32)
    texts = rs.randn(n, 768).astype(np.float32)
    if fmt == "npz":
        extra = {"syn_lr_img": np.float32(0.04)} if lr else {}
        np.savez(tmp_path / "distilled_3.npz", image_syn=images,
                 text_syn=texts, **extra)
        return str(tmp_path / "distilled_3.npz")
    torch.save(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
               tmp_path / "images_3.pt")
    torch.save(torch.from_numpy(texts), tmp_path / "labels_3.pt")
    return str(tmp_path / "images_3.pt")


@pytest.mark.parametrize("fmt,parallel", [("npz", "True"), ("npz", "False"),
                                          ("pt", "True")])
def test_eval_distilled_runs_on_cpu(tmp_path, monkeypatch, capsys, fmt,
                                    parallel):
    monkeypatch.chdir(tmp_path)
    np.savez("synthetic_bert_text_embed.npz",
             bert_test_embed=np.random.RandomState(1).randn(20, 768)
             .astype(np.float32))
    argv = TINY + ["--distilled_npz", _write_set(tmp_path, fmt),
                   "--parallel_eval", parallel, "--std", "True"]
    cfg = parse_config(argv, Config(device="cpu"))
    assert cfg.device == "cpu"
    results = eval_distilled.main(cfg, argv=argv)
    assert len(results) == 2
    for r in results:
        assert list(r) == KEYS
        assert all(np.isfinite(v) and 0 <= v <= 100 for v in r.values())
    out = capsys.readouterr().out
    assert "Evaluate_01: txt_r1=" in out and "Mean/r_mean = " in out
    assert ("lr_net=0.040000" in out) == (fmt == "npz")


@pytest.mark.parametrize("argv,lr", [
    ([], True), (["--lr_net", "0.3"], True), (["--lr_net=0.2"], False),
    ([], False)])
def test_lr_net_precedence_matches_jax(tmp_path, monkeypatch, capsys, argv,
                                       lr):
    """Explicit --lr_net > the npz's syn_lr_img > the default: the same
    choice and message as the JAX CLI (both stopped at the dataset, after
    choosing)."""
    path = _write_set(tmp_path, "npz", lr=lr)

    class Chosen(Exception):
        pass

    def stop(cfg):
        raise Chosen()

    monkeypatch.setattr(sys, "argv", ["eval_distilled"] + argv)
    monkeypatch.setattr(jcli, "get_dataset", stop)
    monkeypatch.setattr(eval_distilled, "get_dataset", stop)
    lr_net = 0.3 if "0.3" in argv else 0.2 if argv else 0.1
    outs = []
    # the port's CLI checks for the card before it reads anything: on the
    # CPU here
    for main, cfg in ((jcli.main, JConfig(distilled_npz=path,
                                          lr_net=lr_net)),
                      (eval_distilled.main, Config(distilled_npz=path,
                                                   lr_net=lr_net,
                                                   device="cpu"))):
        with pytest.raises(Chosen):
            main(cfg)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    payload = dict(np.load(path))
    want = (lr_net if argv or not lr else 0.04)
    assert eval_distilled.choose_lr_net(
        Config(lr_net=lr_net), payload,
        eval_distilled.explicit_flags(argv)) == pytest.approx(want)


def test_missing_text_cache_names_the_file(tmp_path, monkeypatch, capsys):
    """A missing test-caption cache is named and computed with the port's
    own BERT (BERT-base, random init and the hashing tokenizer offline)."""
    monkeypatch.chdir(tmp_path)
    argv = TINY + ["--distilled_npz", _write_set(tmp_path, "npz"),
                   "--num_eval", "1"]
    results = eval_distilled.main(parse_config(argv, Config(device="cpu")),
                                  argv=argv)
    assert "Processing ./synthetic_bert_text_embed.npz" in (
        capsys.readouterr().out)
    with np.load(tmp_path / "synthetic_bert_text_embed.npz") as f:
        embed = f["bert_test_embed"]
    assert embed.shape == (20, 768) and np.isfinite(embed).all()
    assert len(results) == 1 and np.isfinite(results[0]["r_mean"])
    with pytest.raises(SystemExit, match="Sibling labels"):
        eval_distilled.load_distilled(str(tmp_path / "images_9.pt"))


def test_eval_initializer_and_timm_lookup(tmp_path, monkeypatch):
    """No checkpoint: the seeded init.  A local timm file (env or hub
    cache) is found without any download, and a timm state dict with its
    classifier loads strictly into the headless tower."""
    monkeypatch.setenv("HOME", str(tmp_path))
    for env in ("MDD_TIMM_CKPT", "MDD_TIMM_CKPT_NFNET"):
        monkeypatch.delenv(env, raising=False)
    cfg = Config(image_encoder="nf_tiny", device="cpu")
    model = build_bi_encoder(cfg)
    sd = make_eval_initializer(cfg)(model, 7)
    want = init_bi_encoder(VLBiEncoder("nf_tiny", 768, 128), 7).state_dict()
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in sd)

    assert zoo.find_local_timm_checkpoint("nfnet") is None
    hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    (hub / zoo.TIMM_CKPT_NAMES["nfnet"][0]).write_bytes(b"x")
    assert zoo.find_local_timm_checkpoint("nfnet") == str(
        hub / zoo.TIMM_CKPT_NAMES["nfnet"][0])
    env_ckpt = tmp_path / "mine.pth"
    tower_sd = {k: v + 1.0 for k, v in
                model.image_encoder.model.state_dict().items()}
    torch.save({"state_dict": {**tower_sd,
                               "head.fc.weight": torch.zeros(3, 128)}},
               env_ckpt)
    monkeypatch.setenv("MDD_TIMM_CKPT_NFNET", str(env_ckpt))
    loaded, path = zoo.load_timm_state_dict("nfnet")
    assert path == str(env_ckpt) and "head.fc.weight" in loaded
    assert zoo.load_timm_state_dict("nf_tiny") == (None, None)
    zoo.load_timm_image_tower(model.image_encoder, loaded)
    got = model.image_encoder.model.state_dict()
    assert all(torch.equal(got[k], tower_sd[k]) for k in tower_sd)
