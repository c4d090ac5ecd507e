"""The port's expert entry point (``cli/buffer.main``) on the CPU at a tiny
size (NF_TINY at 32^2, tiny BERT, 8 synthetic pairs, batch 4), held
against the JAX package's ``cli/buffer.main``.

Parity runs: both CLIs train 2 experts x 5 epochs, sequentially with
``--decay`` (the 10x cut after epoch 3, then fresh momentum traces);
``--parallel_experts=2`` is held the same way in
tests/test_torch_buffer_parallel.py.  The inits are the JAX package's, with the
skipinit gains moved off zero so that the residual branches train, carried
to the port through its ``init_expert`` seam
(``models/convert.params_from_jax``); the caption caches the JAX CLI wrote
are copied to the port's working directory (the two BERTs initialise
differently); projection dropout is off on both sides (torch's generators
cannot draw JAX's masks; NF_TINY has no DropPath).  The train images, the
host RandAugment and the batch order are the same by construction
(tests/test_torch_data.py).  Tolerance: every snapshot of every written
``.npz``, 1e-3 in relative error norm per tower (float32; the convs and
the contrastive loss sum in other orders over 10 SGD steps).  The returned
buffer indices are equal.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.cli import buffer as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu.engine.expert import (
    init_bi_encoder as jinit_bi_encoder,
)
from multimodal_dataset_distillation_tpu.models import torch_order
from multimodal_dataset_distillation_tpu.models.clip_model import (
    build_bi_encoder as jbuild_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.cli import buffer as pcli
from multimodal_dataset_distillation_tpu_torch.cli import buffer_roco
from multimodal_dataset_distillation_tpu_torch.cli import distill as pdistill
from multimodal_dataset_distillation_tpu_torch.config import Config, parse_config
from multimodal_dataset_distillation_tpu_torch.engine import buffer_io
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_to_jax,
    params_from_jax,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
KW = dict(dataset="synthetic", synthetic_size=8, synthetic_test_size=4,
          image_encoder="nf_tiny", image_size=32, text_encoder_config="tiny",
          text_pretrained=False, image_pretrained=False, num_experts=2,
          train_epochs=5, batch_size_train=4, batch_size_test=4, k_test=4,
          lr_teacher_img=0.05, lr_teacher_txt=0.05, mom=0.5, l2=5e-4,
          num_workers=2, seed=0, disable_wandb=True, name="run",
          pallas_gconv=True)
CACHES = ("synthetic_bert_text_embed.npz",
          "synthetic_bert_train_text_embed.npz")


def _lift(tree, seed):
    """Skipinit gains 0.5 +- 0.1 from the seed (0 would cut every residual
    branch out of the loss)."""
    rs = np.random.RandomState(seed + 100)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(lift, tree)


def _jax_init(orig):
    def init(model, cfg):
        return {"params": _lift(orig(model, cfg)["params"], cfg.seed)}
    return init


def _port_init(model, cfg, seed):
    """The JAX init of expert ``seed`` as the port model's state dict."""
    jcfg = JConfig(**KW)
    tree = _lift(jinit_bi_encoder(jbuild_bi_encoder(jcfg),
                                  jcfg.replace(seed=seed))["params"], seed)
    return {f"{t}.{k}": v for t in ("image_encoder", "text_projection")
            for k, v in params_from_jax(tree[t], getattr(model, t)).items()}


def _no_dropout_port(cfg, device=None):
    model = build_bi_encoder(cfg, device)
    model.text_projection.rate = 0.0
    return model


def _trajs(save_dir, n):
    return [[buffer_io.load_trajectory_npz(
        os.path.join(save_dir, f"{kind}_replay_buffer_{i}.npz"))
        for kind in ("img", "txt")] for i in range(n)]


def run_both(root, mode, **kw):
    """Both CLIs with ``kw``, the JAX CLI first, whose caption caches the
    port's working directory then gets.  -> {side: saved indices, buffer
    directory, trajectories, log} and the root."""
    mp = pytest.MonkeyPatch()
    out = {"root": root}
    try:
        mp.setattr(jcli, "build_bi_encoder",
                   lambda cfg: jbuild_bi_encoder(cfg).clone(proj_dropout=0.0))
        mp.setattr(jcli, "init_bi_encoder", _jax_init(jcli.init_bi_encoder))
        mp.setattr(pcli, "build_bi_encoder", _no_dropout_port)
        mp.setattr(pcli, "init_expert", _port_init)
        for side in ("jax", "port"):
            (root / side).mkdir()
            mp.chdir(root / side)
            common = {**KW, **kw, "buffer_path": f"buffers_{mode}",
                      "save_dir": f"logs_{mode}"}
            if side == "jax":
                # one-device mesh: the suite's 8 CPU devices would shard
                # the batch of 4
                saved = jcli.main(JConfig(**common, mesh_shape=(1,)))
            else:
                for f in CACHES:
                    shutil.copy(root / "jax" / f, f)
                saved = pcli.main(Config(**common, device="cpu"))
            d = root / side / f"buffers_{mode}" / "synthetic" / "nf_tiny" / "bert"
            out[side] = dict(saved=saved, dir=d, trajs=_trajs(d, len(saved)),
                             log=root / side / f"logs_{mode}" / "run.jsonl")
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("buffer_cli"), "sequential",
                    decay=True)


def assert_trajectories_match(runs):
    p, j = runs["port"], runs["jax"]
    assert p["saved"] == j["saved"] == [0, 1]
    for i, (tp, tj) in enumerate(zip(p["trajs"], j["trajs"])):
        for kind, a, b in zip(("img", "txt"), tp, tj):
            assert a.shape == b.shape == (KW["train_epochs"] + 1, b.shape[1])
            assert np.isfinite(a).all()
            for e in range(len(b)):
                rel = np.linalg.norm(a[e] - b[e]) / np.linalg.norm(b[e])
                assert rel <= 1e-3, (i, kind, e, rel)
            # the experts moved, and by the JAX CLI's amounts
            step = np.linalg.norm(b[-1] - b[0])
            assert step > 0
            assert np.linalg.norm((a[-1] - a[0]) - (b[-1] - b[0])) <= 1e-2 * step


def assert_logs_match(runs):
    """The per-epoch log records: one per expert-epoch, the same keys, train
    loss within 1e-3 relative, the recalls (a few pairs: ranks can swap
    on a near-tie) in [0, 100]."""
    def records(path):
        with open(path) as f:
            return [r for r in map(json.loads, f) if "train_loss" in r]

    p, j = records(runs["port"]["log"]), records(runs["jax"]["log"])
    assert len(p) == len(j) == KW["num_experts"] * KW["train_epochs"]
    for a, b in zip(p, j):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-3)
        assert all(0.0 <= a[k] <= 100.0 for k in a if "_r" in k)


def assert_pt_matches_npz(runs):
    """The port's ``.pt`` (registration order) and ``.npz`` (JAX order) hold
    the same trajectory, read back by the port's ``load_buffer``."""
    p = runs["port"]
    model = build_bi_encoder(Config(**KW, device="cpu"))
    for i in range(2):
        for kind, tower in (("img", model.image_encoder),
                            ("txt", model.text_projection)):
            stem = os.path.join(p["dir"], f"{kind}_replay_buffer_{i}")
            (a,) = buffer_io.load_buffer(stem + ".npz", tower)
            (b,) = buffer_io.load_buffer(stem + ".pt", tower)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(flat_to_jax(b, tower),
                                          p["trajs"][i][kind == "txt"])


def test_trajectories_match_jax_cli(runs):
    assert_trajectories_match(runs)


def test_logged_metrics_match_jax_cli(runs):
    assert_logs_match(runs)


def test_port_pt_matches_its_npz(runs):
    assert_pt_matches_npz(runs)


def test_jax_reads_port_buffers_and_port_distills_them(runs, monkeypatch):
    """The JAX ``load_buffer`` reads the port's ``.npz`` and its ``.pt``
    (reference order, through the JAX codec) as the same trajectories, and
    the port's distill CLI runs an outer step on them."""
    p = runs["port"]
    jcfg = JConfig(**KW)
    tree = jinit_bi_encoder(jbuild_bi_encoder(jcfg), jcfg)["params"]
    codecs = {"img": torch_order.codec_for_image_tower(tree["image_encoder"]),
              "txt": torch_order.codec_for_projection(tree["text_projection"])}
    for i, traj in enumerate(p["trajs"]):
        for kind, want in zip(("img", "txt"), traj):
            stem = os.path.join(p["dir"], f"{kind}_replay_buffer_{i}")
            (npz,) = jbuffer_io.load_buffer(stem + ".npz")
            (pt,) = jbuffer_io.load_buffer(stem + ".pt", codecs[kind])
            np.testing.assert_array_equal(npz, want)
            np.testing.assert_array_equal(pt, want)
    monkeypatch.chdir(runs["root"] / "port")
    cfg = Config(**{**KW, "buffer_path": "buffers_sequential",
                    "save_dir": "logs_distill", "num_queries": 4,
                    "syn_steps": 2, "mini_batch_size": 2, "expert_epochs": 1,
                    "max_start_epoch": 2, "Iteration": 0, "num_eval": 0,
                    "pix_init": "noise", "txt_init": "noise", "draw": False,
                    "device": "cpu"})
    distiller, _ = pdistill.main(cfg)
    with open(os.path.join("logs_distill", "run.jsonl")) as f:
        losses = [r["Grand_Loss"] for r in map(json.loads, f)
                  if "Grand_Loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert torch.isfinite(distiller.state.image_syn).all()


@pytest.mark.parametrize("flag,ranks,error,match", [
    # a mesh that does not multiply to the world (one process: world 1)
    (dict(mesh_shape=(2,)), 1, ValueError, "multiplies to 2"),
    # two ranks on one card without gloo asked for: NCCL would refuse
    (dict(distributed=True, device="cuda"), 2, RuntimeError,
     "share 1 card")])
def test_unported_flags_raise_before_data(tmp_path, monkeypatch, flag, ranks,
                                          error, match):
    """The multi-rank start-up checks raise before any data is read or
    any rank waits on another."""
    def no_data(cfg):
        raise AssertionError("data was read before the flag check")

    monkeypatch.setattr(pcli, "get_dataset", no_data)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MDD_DIST_BACKEND", raising=False)
    for k, v in dict(WORLD_SIZE=ranks, RANK=0, LOCAL_RANK=0,
                     LOCAL_WORLD_SIZE=ranks).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(error, match=match):
        pcli.main(Config(**{**KW, "device": "cpu", **flag}))
    assert not torch.distributed.is_initialized()


NEW_FLAGS = [dict(zca=True), dict(text_encoder="clip"), dict(stem_s2d=True),
             dict(image_encoder="convnext"), dict(image_encoder="clip")]


@pytest.mark.parametrize("flag", NEW_FLAGS)
def test_new_flags_run_the_buffer_cli(tmp_path, monkeypatch, flag):
    """Each flag of the CLIP / ConvNeXt / ZCA / s2d slice through
    ``cli/buffer.main`` at toy size (1 expert x 1 epoch; CLIP ViT-B/32 and
    ConvNeXt as narrow stand-ins with their layer kinds and widths): the
    caption caches and buffers under the JAX package's names, read back by
    the JAX package (``.pt`` = ``.npz``, the CLIP and ConvNeXt snapshots in
    its ravel order), and by the port at the tower's width.  ``--zca`` only
    names the CIFAR buffer directories; ``--stem_s2d`` builds the s2d stem
    and trains as the plain stem does (1e-4)."""
    from multimodal_dataset_distillation_tpu.data import textcache as jtc
    from test_torch_zoo_clip import narrow_towers

    narrow_towers(monkeypatch)
    built = []
    build = pcli.build_bi_encoder

    def keep(cfg, device=None):
        built.append(build(cfg, device))
        return built[-1]

    monkeypatch.setattr(pcli, "build_bi_encoder", keep)
    monkeypatch.delenv("MDD_STEM_S2D", raising=False)
    kw = {**KW, "num_experts": 1, "train_epochs": 1, "device": "cpu",
          "buffer_path": "buffers", **flag}

    def run(work, **extra):
        (tmp_path / work).mkdir()
        monkeypatch.chdir(tmp_path / work)
        cfg = Config(**{**kw, **extra})
        assert pcli.main(cfg) == [0]
        return cfg, os.path.join("buffers", "synthetic", cfg.image_encoder,
                                 cfg.text_encoder)

    cfg, d = run("run")
    model = built[-1]
    jcfg = JConfig(**{k: v for k, v in kw.items() if k != "device"})
    def no_process(*a, **k):
        raise AssertionError("the JAX package recomputed a port cache")

    for kind in ("text", "train"):   # caches the JAX package reads as is
        z = jtc.load_or_process_file(kind, no_process, jcfg, None)
        assert z["bert_test_embed"].shape[1] == 128
    for kind, tower in (("img", model.image_encoder),
                        ("txt", model.text_projection)):
        stem = os.path.join(d, f"{kind}_replay_buffer_0")
        (npz,) = jbuffer_io.load_buffer(stem + ".npz")
        assert npz.shape == (2, sum(p.numel() for p in tower.parameters()))
        assert np.isfinite(npz).all()
        (a,) = buffer_io.load_buffer(stem + ".npz", tower)
        (b,) = buffer_io.load_buffer(stem + ".pt", tower)
        np.testing.assert_array_equal(a, b)
        if kind == "img" and cfg.image_encoder in ("clip", "convnext"):
            assert not buffer_io.has_reference_order(tower)
            (pt,) = jbuffer_io.load_buffer(stem + ".pt")   # as stored
            np.testing.assert_array_equal(pt, npz)
    if cfg.stem_s2d:
        assert model.image_encoder.model.stem.s2d
        (on,) = buffer_io.load_buffer(
            os.path.join(d, "img_replay_buffer_0.npz"), model.image_encoder)
        _, d_off = run("plain", stem_s2d=False)
        assert not built[-1].image_encoder.model.stem.s2d
        (off,) = buffer_io.load_buffer(
            os.path.join(d_off, "img_replay_buffer_0.npz"),
            built[-1].image_encoder)
        assert np.linalg.norm(on - off) <= 1e-4 * np.linalg.norm(off)


@pytest.mark.parametrize("flag", [
    dict(image_encoder="resnet18"), dict(image_encoder="resnet50"),
    dict(image_encoder="vit"), dict(image_encoder="nf_regnet"),
    dict(image_encoder="convnet", only_has_image_projection=True)])
def test_ported_towers_reach_the_data(tmp_path, monkeypatch, flag):
    """What the JAX buffer CLI trains (BatchNorm towers and the image
    projection included) passes the start-up checks."""
    class DataRead(Exception):
        pass

    def data(cfg):
        raise DataRead

    monkeypatch.setattr(pcli, "get_dataset", data)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(DataRead):
        pcli.main(Config(**{**KW, **flag, "device": "cpu"}))


@pytest.mark.parametrize("mode", [dict(parallel_experts=2),
                                  dict(text_trainable=True)])
def test_device_augment_outside_the_sequential_trainer_raises_before_data(
        tmp_path, monkeypatch, mode):
    """Those trainers neither augment nor normalise: the raw crops of
    ``--device_augment`` would reach their step as they are."""
    def no_data(cfg):
        raise AssertionError("data was read before the flag check")

    monkeypatch.setattr(pcli, "get_dataset", no_data)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--device_augment"):
        pcli.main(Config(**{**KW, **mode, "device_augment": True,
                            "device": "cpu"}))


def test_transfer_is_stripped_as_in_jax(tmp_path, monkeypatch):
    """The reference buffer.py has no --transfer: the teachers are plain
    bi-encoders, so the flag reaches the data instead of raising."""
    class DataRead(Exception):
        pass

    def data(cfg):
        assert not cfg.transfer
        raise DataRead

    monkeypatch.setattr(pcli, "get_dataset", data)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(DataRead):
        pcli.main(Config(**KW, transfer=True, device="cpu"))


@pytest.mark.parametrize("module", ["buffer", "buffer_roco"])
def test_no_card_raises_and_never_falls_back(tmp_path, monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pcli.main(Config(**KW, device="cuda"))
    proc = subprocess.run(
        [sys.executable, "-m",
         f"multimodal_dataset_distillation_tpu_torch.cli.{module}",
         "--dataset=synthetic", "--image_encoder=nf_tiny",
         f"--buffer_path={tmp_path}"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO),
                           "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert not list(tmp_path.iterdir())


def test_roco_default(tmp_path, monkeypatch):
    """``cli/buffer_roco`` is the buffer CLI with the root
    ``buffer_roco.py``'s defaults; one NF_TINY expert on a ROCO CSV fixture
    (a truncated JPEG and a missing file among its rows), through the
    raw-crop transform and the in-step augment."""
    parsed = parse_config([], buffer_roco.DEFAULTS)
    assert (parsed.dataset, parsed.image_encoder, parsed.disable_wandb) == (
        "roco", "nfnet", True)
    base = Config(name="")   # and every other field the Config default
    assert parsed.replace(dataset=base.dataset, name="",
                          image_encoder=base.image_encoder,
                          disable_wandb=base.disable_wandb) == base
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_fixtures
    finally:
        sys.path.remove(str(REPO / "tools"))
    make_fixtures.make_roco(str(tmp_path / "roco"), n_rows=8)
    monkeypatch.chdir(tmp_path)
    cfg = buffer_roco.DEFAULTS.replace(
        ann_root=str(tmp_path / "roco" / "radiologytraindata.csv"),
        image_root=str(tmp_path / "roco" / "images"), image_encoder="nf_tiny",
        image_size=32, text_encoder_config="tiny", text_pretrained=False,
        image_pretrained=False, num_experts=1, train_epochs=1,
        batch_size_train=4, batch_size_test=4, k_test=4, num_workers=2,
        buffer_path="buffers", save_dir="logs", device_augment=True,
        device="cpu")
    assert pcli.main(cfg) == [0]
    model = build_bi_encoder(cfg)
    (traj,) = buffer_io.load_buffer(
        "buffers/roco/nf_tiny/bert/img_replay_buffer_0.pt", model.image_encoder)
    assert traj.shape[0] == 2 and np.isfinite(traj).all()
    assert not np.array_equal(traj[0], traj[1])
