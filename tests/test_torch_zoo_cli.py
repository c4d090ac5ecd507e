"""The zoo's towers through the port's entry points on the CPU, at a tiny
synthetic size.

* ``cli/buffer.main`` for ConvNet-tiny (2 experts x 2 epochs) and ResNet-18
  (BatchNorm; one expert, one SGD step: tests/test_torch_zoo_train.py says
  why one) against the JAX package's ``cli/buffer.main``, as
  tests/test_torch_buffer_cli.py holds NF_TINY: the JAX CLI's inits (the
  flax tree with seeded values) carried across (``batch_stats`` too), the
  JAX CLI's caption caches copied to the port's directory, projection
  dropout off on both sides.  Every written
  ``.npz`` snapshot within 1e-3 relative error norm per tower, the ``.pt``
  the same trajectory.
* ``cli/eval_distilled.main`` on one distilled set under other towers
  (Table D's cross-tower eval) and with ``--transfer`` (NFNet-L0's
  1000-class head on the eval students), the counterpart of JAX
  tests/test_transfer_eval.py.
"""

import os
import shutil

import numpy as np
import pytest

from multimodal_dataset_distillation_tpu.cli import buffer as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.models.clip_model import (
    build_bi_encoder as jbuild,
)
from multimodal_dataset_distillation_tpu_torch.cli import buffer as pcli
from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine import buffer_io
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_to_jax,
    params_from_jax,
)

from test_torch_zoo import jax_variables
from test_torch_threads import share_cores  # noqa: F401 (autouse)

KW = dict(dataset="synthetic", text_encoder_config="tiny",
          text_pretrained=False, image_pretrained=False, batch_size_train=4,
          batch_size_test=4, k_test=4, lr_teacher_img=0.05,
          lr_teacher_txt=0.05, mom=0.5, l2=5e-4, num_workers=2, seed=0,
          disable_wandb=True, name="run", synthetic_test_size=4)
RUNS = {
    "convnet_tiny": dict(image_encoder="convnet_tiny", image_size=32,
                         synthetic_size=8, num_experts=2, train_epochs=2),
    "resnet18": dict(image_encoder="resnet18", image_size=64,
                     synthetic_size=4, num_experts=1, train_epochs=1),
}
CACHES = ("synthetic_bert_text_embed.npz",
          "synthetic_bert_train_text_embed.npz")


def _jax_init(model, cfg):
    """The JAX CLI's expert init: the flax tree with values from
    ``cfg.seed`` (no flax initializer runs)."""
    s = cfg.image_size
    return jax_variables(model, np.zeros((2, s, s, 3), np.float32),
                         np.zeros((2, model.text_embedding), np.float32),
                         seed=cfg.seed)


def _port_init(model, cfg, seed):
    """The JAX CLI's init of expert ``seed`` as the port's state dict."""
    jcfg = JConfig(**{k: getattr(cfg, k) for k in ("image_encoder",
                                                   "image_size",
                                                   "text_encoder_config")},
                   seed=seed)
    v = _jax_init(jbuild(jcfg), jcfg)
    stats = v.get("batch_stats", {})
    return {f"{t}.{k}": x for t in ("image_encoder", "text_projection")
            for k, x in params_from_jax(v["params"][t], getattr(model, t),
                                        stats.get(t)).items()}


def _no_dropout_port(cfg, device=None):
    model = build_bi_encoder(cfg, device)
    model.text_projection.rate = 0.0
    return model


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request, tmp_path_factory):
    name = request.param
    root = tmp_path_factory.mktemp(f"zoo_buffer_{name}")
    common = {**KW, **RUNS[name], "buffer_path": "buffers",
              "save_dir": "logs"}
    mp = pytest.MonkeyPatch()
    out = {"name": name, "cfg": common}
    try:
        mp.setattr(jcli, "build_bi_encoder",
                   lambda cfg: jbuild(cfg).clone(proj_dropout=0.0))
        mp.setattr(jcli, "init_bi_encoder", _jax_init)
        mp.setattr(pcli, "build_bi_encoder", _no_dropout_port)
        mp.setattr(pcli, "init_expert", _port_init)
        for side in ("jax", "port"):
            (root / side).mkdir()
            mp.chdir(root / side)
            if side == "jax":
                saved = jcli.main(JConfig(**common, mesh_shape=(1,)))
            else:
                for f in CACHES:
                    shutil.copy(root / "jax" / f, f)
                saved = pcli.main(Config(**common, device="cpu"))
            d = root / side / "buffers" / "synthetic" / name / "bert"
            out[side] = dict(saved=saved, dir=d, trajs=[[
                buffer_io.load_trajectory_npz(
                    os.path.join(d, f"{kind}_replay_buffer_{i}.npz"))
                for kind in ("img", "txt")] for i in range(len(saved))])
    finally:
        mp.undo()
    return out


def test_buffer_cli_trajectories_match_jax(runs):
    p, j = runs["port"], runs["jax"]
    cfg = runs["cfg"]
    assert p["saved"] == j["saved"] == list(range(cfg["num_experts"]))
    for tp, tj in zip(p["trajs"], j["trajs"]):
        for kind, a, b in zip(("img", "txt"), tp, tj):
            assert a.shape == b.shape == (cfg["train_epochs"] + 1,
                                          b.shape[1])
            for e in range(len(b)):
                rel = np.linalg.norm(a[e] - b[e]) / np.linalg.norm(b[e])
                assert rel <= 1e-3, (kind, e, rel)
            assert np.linalg.norm(b[-1] - b[0]) > 0


def test_buffer_cli_pt_holds_the_npz_trajectory(runs):
    """The ``.pt`` (registration order) and ``.npz`` (JAX order) read back
    as the same trajectory at the tower's width."""
    p = runs["port"]
    model = build_bi_encoder(Config(**runs["cfg"], device="cpu"))
    for i, traj in enumerate(p["trajs"]):
        for kind, tower, want in (("img", model.image_encoder, traj[0]),
                                  ("txt", model.text_projection, traj[1])):
            stem = os.path.join(p["dir"], f"{kind}_replay_buffer_{i}")
            (a,) = buffer_io.load_buffer(stem + ".npz", tower)
            (b,) = buffer_io.load_buffer(stem + ".pt", tower)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(flat_to_jax(b, tower), want)
            assert a.shape[1] == sum(t.numel() for t in tower.parameters())


def _distilled(tmp_path, size=16, n=8):
    rs = np.random.RandomState(0)
    path = str(tmp_path / "distilled_5.npz")
    np.savez(path, image_syn=rs.randn(n, size, size, 3).astype(np.float32),
             text_syn=rs.randn(n, 128).astype(np.float32),
             syn_lr_img=np.float32(0.05), syn_lr_txt=np.float32(0.05))
    return path


@pytest.mark.parametrize("encoder,transfer,dim", [
    ("convnet_tiny", False, 64), ("vit", False, 1000),
    ("resnet18", False, 512), ("nfnet", True, 1000)])
def test_eval_distilled_cross_tower(tmp_path, monkeypatch, encoder, transfer,
                                    dim):
    """A distilled set evaluates under another eval tower end to end (the
    eval students' widths as the JAX ``build_bi_encoder`` gives them); with
    ``--transfer`` NFNet-L0's students carry the 1000-class head."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(dataset="synthetic", synthetic_size=16,
                 synthetic_test_size=8, image_size=16, image_encoder=encoder,
                 text_encoder="bert", text_encoder_config="tiny",
                 text_pretrained=False, image_pretrained=False,
                 distilled_npz=_distilled(tmp_path), num_eval=2,
                 epoch_eval_train=0 if encoder == "nfnet" else 1,
                 batch_train=4, batch_size_test=8, k_test=8,
                 parallel_eval=False, transfer=transfer, seed=0,
                 device="cpu")
    assert build_bi_encoder(cfg).text_projection.projection.out_features \
        == dim == jbuild(JConfig(image_encoder=encoder, transfer=transfer,
                                 text_encoder_config="tiny")).image_embedding
    results = eval_distilled.main(cfg, argv=[])
    assert len(results) == 2
    for val in results:
        for k in ("txt_r1", "img_r1", "r_mean"):
            assert np.isfinite(val[k]) and 0.0 <= val[k] <= 100.0
