"""The port's distill entry point (``cli/distill.main``) on the CPU at a
tiny size (NF_TINY at 32^2, tiny BERT, the synthetic dataset), held
against the JAX package's ``cli/distill.main``, in the spirit of
``tests/test_end_to_end.py``.

Parity runs: both CLIs start from noise (``--pix_init noise --txt_init
noise``: the synthetic set comes from the shared numpy ``RandomState``)
and read one JAX-written expert buffer, with the settings of
``tests/test_torch_distill.py::CFG``.  Projection dropout is off on both
sides (torch's generators cannot draw JAX's masks; NF_TINY has no
DropPath).  Tolerances, float32: each iteration's ``Grand_Loss`` rtol
1e-3; the ``distilled_{it}.npz`` sets and learned LRs within the
meta-gradient tolerance 5e-3 (of ``tests/test_reference_parity.py``) of
their change from the init.  Everything else is exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.cli import distill as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu.engine.distill import (
    ExpertCycler as JExpertCycler,
)
from multimodal_dataset_distillation_tpu.engine.expert import (
    init_bi_encoder as jinit_bi_encoder,
)
from multimodal_dataset_distillation_tpu.models import torch_order
from multimodal_dataset_distillation_tpu.models.clip_model import (
    build_bi_encoder as jbuild_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.cli import distill as pcli
from multimodal_dataset_distillation_tpu_torch.cli.eval_distilled import (
    load_distilled,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine import buffer_io
from multimodal_dataset_distillation_tpu_torch.engine.checkpoint import (
    load_distill_checkpoint,
    save_distill_checkpoint,
)
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    DistillState,
    Distiller,
    ExpertCycler,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    flat_to_jax,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
KW = dict(dataset="synthetic", synthetic_size=8, synthetic_test_size=4,
          image_encoder="nf_tiny", image_size=32, text_encoder_config="tiny",
          text_pretrained=False, image_pretrained=False, num_queries=4,
          syn_steps=2, mini_batch_size=2, expert_epochs=1, max_start_epoch=2,
          lr_img=10.0, lr_txt=10.0, lr_lr=1e-2, lr_teacher_img=0.05,
          lr_teacher_txt=0.05, seed=0, Iteration=2, eval_it=2, num_eval=0,
          epoch_eval_train=1, batch_train=4, batch_size_test=4, k_test=4,
          num_workers=0, parallel_eval=False, disable_wandb=True,
          draw=True, name="run", pallas_gconv=True)


def _cfg(tmp, **kw):
    return Config(**{**KW, "buffer_path": str(tmp / "buffers"),
                     "save_dir": str(tmp / "logs"), "device": "cpu", **kw})


def _losses(cfg):
    out = {}
    with open(os.path.join(cfg.save_dir, f"{cfg.name}.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "Grand_Loss" in rec:
                out[rec["step"]] = rec["Grand_Loss"]
    return out


def _jax_tree(seed=0):
    """JAX NF_TINY + tiny-BERT bi-encoder params, skipinit gains off zero."""
    jcfg = JConfig(**KW)
    variables = jinit_bi_encoder(jbuild_bi_encoder(jcfg), jcfg)
    rs = np.random.RandomState(seed + 100)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(lift, variables["params"])


def _jax_traj(tree, n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + np.float32(0.01 * k) * rs.randn(
            *np.shape(x)).astype(np.float32)) if np.ndim(x) else x, tree)
        for k in range(n)]


def _no_dropout_port(orig):
    def build(cfg, device=None):
        model = orig(cfg, device)
        model.text_projection.rate = 0.0
        return model
    return build


def _no_dropout_jax(orig):
    return lambda cfg: orig(cfg).clone(proj_dropout=0.0)


METRICS = ("txt_r1", "txt_r5", "txt_r10", "txt_r_mean", "img_r1", "img_r5",
           "img_r10", "img_r_mean", "r_mean")


def _eval_stub(it_eval, model, variables, images, texts, *args, **kw):
    """Stands in for ``evaluate_synset`` in the parity runs: the eval path
    is held against the JAX package in tests/test_torch_eval*.py, and its
    student training would dominate this file's time.  Its metrics are
    statistics of the set it was handed, so both CLIs' eval blocks can be
    seen to receive the same synthetic set and learned LR."""
    cfg = args[1]
    vals = (np.abs(images).mean(), np.abs(texts).mean(), cfg.lr_net)
    return model, [0.0], {k: float(vals[i % 3]) for i, k in
                          enumerate(METRICS)}


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """Both CLIs, noise init, one JAX-written buffer (3 epochs), 3
    iterations with eval blocks (one stubbed student) at 0 and 2, and
    --save_pt."""
    root = tmp_path_factory.mktemp("cli_parity")
    tree = _jax_tree()
    jbuffer_io.save_expert(str(root / "buffers"),
                           _jax_traj(tree["image_encoder"]),
                           _jax_traj(tree["text_projection"], seed=1))
    kw = dict(pix_init="noise", txt_init="noise", num_eval=1, save_pt=True,
              buffer_path=str(root / "buffers"))
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(pcli, "build_bi_encoder",
                   _no_dropout_port(pcli.build_bi_encoder))
        mp.setattr(jcli, "build_bi_encoder",
                   _no_dropout_jax(jcli.build_bi_encoder))
        mp.setattr(pcli, "evaluate_synset", _eval_stub)
        mp.setattr(jcli, "evaluate_synset", _eval_stub)
        for side, main, cfg in (
                ("port", pcli.main, Config(**{**KW, **kw, "device": "cpu",
                                              "save_dir": str(root / "p")})),
                # one-device mesh: the suite's 8 CPU devices would shard
                # the minibatch (the same math, a slower compile)
                ("jax", jcli.main, JConfig(**{**KW, **kw, "mesh_shape": (1,),
                                             "save_dir": str(root / "j")}))):
            (root / f"cwd_{side}").mkdir()
            mp.chdir(root / f"cwd_{side}")
            distiller, history = main(cfg)
            out[side] = dict(cfg=cfg, history=history,
                             run=Path(cfg.save_dir) / "synthetic" / "run")
    finally:
        mp.undo()
    return out


def test_grand_loss_matches_jax_cli(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    lp, lj = _losses(p["cfg"]), _losses(j["cfg"])
    assert sorted(lp) == sorted(lj) == [0, 1, 2]
    for it in lj:
        assert np.isfinite(lp[it])
        np.testing.assert_allclose(lp[it], lj[it], rtol=1e-3,
                                   err_msg=f"iteration {it}")


def test_distilled_sets_match_jax_cli(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    init = None
    for it in (0, 2):
        got = load_distilled(str(p["run"] / f"distilled_{it}.npz"))
        want = load_distilled(str(j["run"] / f"distilled_{it}.npz"))
        if init is None:  # the noise init: the same numpy draws
            init = want
            for a, b in zip(got[:2], want[:2]):
                np.testing.assert_array_equal(a, b)
        for a, b, a0, name in (
                (got[0], want[0], init[0], "image_syn"),
                (got[1], want[1], init[1], "text_syn"),
                (got[2]["syn_lr_img"], want[2]["syn_lr_img"],
                 init[2]["syn_lr_img"], "syn_lr_img"),
                (got[2]["syn_lr_txt"], want[2]["syn_lr_txt"],
                 init[2]["syn_lr_txt"], "syn_lr_txt")):
            delta = np.asarray(b) - a0
            np.testing.assert_allclose(
                np.asarray(a) - a0, delta, rtol=5e-3,
                atol=5e-3 * np.abs(delta).max(), err_msg=f"{name} it {it}")
    assert [it for it, _ in p["history"]] == [it for it, _ in
                                              j["history"]] == [0, 2]
    for (_, a), (_, b) in zip(p["history"], j["history"]):
        np.testing.assert_allclose([a[0][k] for k in METRICS],
                                   [b[0][k] for k in METRICS], rtol=5e-3)


def test_artifact_names_match_jax_cli(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    names = sorted(os.listdir(p["run"]))
    assert names == sorted(os.listdir(j["run"]))
    for it in (0, 2):
        for f in (f"synthetic_images_{it}.png",
                  f"clipped_synthetic_images_{it}_std_2.5.png",
                  f"synthetic_sentences_{it}.txt", f"distilled_{it}.npz",
                  f"images_{it}.pt", f"labels_{it}.pt"):
            assert f in names
    assert os.listdir(p["cfg"].save_dir).count("run.jsonl") == 1
    assert sorted(os.listdir(p["cfg"].save_dir)) == sorted(
        os.listdir(j["cfg"].save_dir))
    images = torch.load(p["run"] / "images_2.pt", weights_only=True)
    assert tuple(images.shape) == (4, 3, 32, 32)


def test_dummy_buffers_give_a_finite_loss(tmp_path, monkeypatch, capsys):
    """No buffers: one dummy expert from the student's init (an .npz the
    JAX package reads), then finite losses."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path, Iteration=1)
    distiller, history = pcli.main(cfg)
    assert "fabricating dummy buffers" in capsys.readouterr().out
    losses = _losses(cfg)
    assert sorted(losses) == [0, 1] and all(map(np.isfinite,
                                                losses.values()))
    img = tmp_path / "buffers" / "img_replay_buffer_0.npz"
    (traj,) = jbuffer_io.load_buffer(str(img))
    assert traj.shape == (2, sum(p.numel() for p in
                                 distiller.model.image_encoder.parameters()))
    assert history == [] and distiller.nan_bailout_it is None


def test_nan_bailout_stops_the_loop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path, Iteration=50, max_start_epoch=1,
               lr_teacher_img=1e30, lr_teacher_txt=1e30, lr_lr=0.0)
    distiller, _ = pcli.main(cfg)
    assert distiller.nan_bailout_it is not None
    assert len(_losses(cfg)) < cfg.Iteration


def test_buffer_mismatch_raises_the_jax_error(tmp_path, monkeypatch):
    """An image buffer of another width: the same ValueError text from
    both CLIs."""
    tree = _jax_tree()
    jbuffer_io.save_expert(str(tmp_path / "buffers"),
                           _jax_traj(tree["image_encoder"]),
                           _jax_traj(tree["text_projection"]),
                           write_pt=False)
    np.savez(tmp_path / "buffers" / "img_replay_buffer_0.npz",
             trajectory=np.zeros((3, 10), np.float32))
    monkeypatch.chdir(tmp_path)
    msgs = []
    for main, cfg in ((pcli.main, _cfg(tmp_path)),
                      (jcli.main, JConfig(**{**KW, "save_dir": str(
                          tmp_path / "j"), "buffer_path": str(
                              tmp_path / "buffers")}))):
        with pytest.raises(ValueError, match="expert buffer param size 10 "
                           "!= student flat size") as e:
            main(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch):
    """A checkpoint at iteration 2 reloads into a fresh Distiller bit for
    bit, and a run resumed from it takes the same iteration-3 step as the
    uninterrupted run (same loss, same final state).  The uninterrupted
    run also traces iteration 2 (--profile_dir)."""
    monkeypatch.chdir(tmp_path)
    full = _cfg(tmp_path, Iteration=3, ckpt_it=2, name="full",
                profile_dir=str(tmp_path / "prof"))
    d_full, _ = pcli.main(full)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    ckpt = tmp_path / "logs" / "synthetic" / "full" / "distill_ckpt_2.pt"
    assert ckpt.is_file() and Path(str(ckpt) + ".meta.npz").is_file()
    resumed = full.replace(resume_from=str(ckpt), name="resumed", ckpt_it=0,
                           profile_dir=None)
    d_res, _ = pcli.main(resumed)
    assert _losses(resumed) == {3: _losses(full)[3]}
    for a, b in zip(dataclass_tensors(d_full.state),
                    dataclass_tensors(d_res.state)):
        assert torch.equal(a, b)
    assert torch.equal(d_full.rng.get_state(), d_res.rng.get_state())


def dataclass_tensors(state):
    return [state.image_syn, state.text_syn, state.syn_lr_img,
            state.syn_lr_txt, state.mom_img, state.mom_txt, *state.mom_lr]


def test_checkpoint_round_trip(tmp_path):
    cfg = _cfg(tmp_path)
    rs = np.random.RandomState(0)

    def distiller():
        model = init_bi_encoder(build_bi_encoder(cfg), 0)
        return Distiller(cfg, model, rs.randn(4, 32, 32, 3),
                         rs.randn(4, 128), device="cpu")

    d = distiller()
    st = d.state
    d.state = DistillState(*[t + k + 1.0 for k, t in
                             enumerate(dataclass_tensors(st)[:6])],
                           mom_lr=tuple(u - 3.0 for u in st.mom_lr))
    d.draw_seeds(3)
    host = np.random.RandomState(5)
    host.randn(7)
    path = save_distill_checkpoint(str(tmp_path / "c" / "distill_ckpt_4.pt"),
                                   d, 4, host_rng=host)
    fresh, host2 = distiller(), np.random.RandomState(0)
    assert load_distill_checkpoint(path, fresh, host_rng=host2) == 4
    for a, b in zip(dataclass_tensors(d.state),
                    dataclass_tensors(fresh.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert fresh.draw_seeds(2) == d.draw_seeds(2)
    assert host2.randn() == host.randn()
    with np.load(path + ".meta.npz") as meta:
        assert {"it", "n_queries", "torch_rng", "np_rng_keys"} <= set(meta)
    # a JAX .msgpack is read (tests/test_torch_jax_files.py); one that is
    # not a flax state dict of arrays is refused
    import msgpack
    import shutil

    bad = str(tmp_path / "distill_ckpt_4.msgpack")
    with open(bad, "wb") as f:
        f.write(msgpack.packb({"image_syn": msgpack.ExtType(7, b"")}))
    shutil.copy(path + ".meta.npz", bad + ".meta.npz")
    with pytest.raises(ValueError, match="ext type 7"):
        load_distill_checkpoint(bad, fresh)


@pytest.mark.parametrize("load_all", [True, False])
def test_cycler_visits_the_jax_sequence(tmp_path, load_all):
    """3 files x 2 experts, cache cap 2, prefetch on: the same (file,
    expert, start) walk, the same arrays (in each package's order), the
    same cache and in-flight keys after every call."""
    tree = _jax_tree()
    model = build_bi_encoder(_cfg(tmp_path))
    codecs = torch_order.codecs_for_student(tree)
    d = tmp_path / "b"
    d.mkdir()
    for n in range(3):
        for kind, sub, codec in (("img", "image_encoder", codecs[0]),
                                 ("txt", "text_projection", codecs[1])):
            jbuffer_io.save_trajectories_pt(
                str(d / f"{kind}_replay_buffer_{n}.pt"),
                [_jax_traj(tree[sub], seed=10 * n + e) for e in range(2)],
                codec=codec)
    img_files, txt_files = buffer_io.discover_buffers(str(d))
    kw = dict(max_start_epoch=2, expert_epochs=1, seed=3,
              load_all=load_all, device_cache_cap=2, prefetch=True)
    cyc = ExpertCycler(img_files, txt_files, img_template=model.image_encoder,
                       txt_template=model.text_projection, device="cpu", **kw)
    jcyc = JExpertCycler(img_files, txt_files, codecs=codecs, **kw)
    try:
        for _ in range(9):
            ti, tt, start = cyc.next_segment_device()
            ji, jt, jstart = jcyc.next_segment_device()
            assert start == jstart and cyc._last_key == jcyc._last_key
            np.testing.assert_array_equal(
                ti.numpy(), flat_from_jax(np.asarray(ji), model.image_encoder))
            np.testing.assert_array_equal(
                tt.numpy(),
                flat_from_jax(np.asarray(jt), model.text_projection))
            assert list(cyc._cache) == list(jcyc._device_cache)
            assert set(cyc._pending) == set(jcyc._pending)
            assert (cyc.file_idx, cyc.expert_idx) == (jcyc.file_idx,
                                                      jcyc.expert_idx)
            assert cyc.img_files == jcyc.img_files
    finally:
        jcyc.close()
        cyc.close()


def test_port_buffers_load_in_jax_and_back(tmp_path):
    """``save_expert`` of the port (.pt in registration order, .npz in JAX
    ravel order) loads through the JAX ``load_buffer``, and a JAX-written
    pair through the port's, to the same trajectories."""
    cfg = _cfg(tmp_path)
    model = init_bi_encoder(build_bi_encoder(cfg), 1)
    towers = (model.image_encoder, model.text_projection)
    rs = np.random.RandomState(0)
    trajs = [[[p.detach().numpy() + np.float32(0.01 * k) * np.asarray(
        rs.randn(*p.shape), np.float32) for p in t.parameters()]
        for k in range(3)] for t in towers]
    n = buffer_io.save_expert(str(tmp_path / "p"), *trajs, *towers)
    assert n == 0 and buffer_io.next_free_index(str(tmp_path / "p")) == 1
    tree = _jax_tree()
    codecs = torch_order.codecs_for_student(tree)
    for kind, traj, tower, codec in zip(("img", "txt"), trajs, towers,
                                        codecs):
        want = flat_to_jax(buffer_io.stack_trajectory(traj), tower)
        for ext in ("npz", "pt"):
            (got,) = jbuffer_io.load_buffer(
                str(tmp_path / "p" / f"{kind}_replay_buffer_0.{ext}"), codec)
            np.testing.assert_array_equal(got, want)
    jtrajs = [_jax_traj(tree[s]) for s in ("image_encoder",
                                           "text_projection")]
    jbuffer_io.save_expert(str(tmp_path / "j"), *jtrajs)
    for kind, traj, tower in zip(("img", "txt"), jtrajs, towers):
        want = flat_from_jax(jbuffer_io.stack_trajectory(traj), tower)
        for ext in ("npz", "pt"):
            (got,) = buffer_io.load_buffer(
                str(tmp_path / "j" / f"{kind}_replay_buffer_0.{ext}"), tower)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [dict(mesh_shape=(2,))])
def test_queued_flags_raise_at_start_up(tmp_path, monkeypatch, flag):
    def no_data(cfg):
        raise AssertionError("data was read before the flag check")

    monkeypatch.setattr(pcli, "get_dataset", no_data)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A, item 1\d"):
        pcli.main(_cfg(tmp_path, **flag))


@pytest.mark.parametrize("flag", [
    # 16^2 keeps the host's eigendecomposition at 768 features
    dict(zca=True, image_size=16), dict(text_encoder="clip"),
    dict(stem_s2d=True), dict(image_encoder="convnext"),
    dict(image_encoder="clip")])
def test_new_flags_run_the_distill_cli(tmp_path, monkeypatch, capsys, flag):
    """Each flag of the CLIP / ConvNeXt / ZCA / s2d slice through
    ``cli/distill.main`` at toy size from the real-pair init (dummy
    buffers, one outer step, an eval block of one student at iteration 0
    with the artifacts and ``--save_pt``; CLIP ViT-B/32 and ConvNeXt as
    narrow stand-ins with their layer kinds and widths): finite losses,
    caption caches and buffers that the JAX package reads as they are.
    ``--zca``: the whitened init, and ``images_zca_0.pt`` the
    de-whitened ``distilled_0.npz`` pixels (1e-5).  ``--stem_s2d``: the
    distill and eval students on the s2d stem, the losses those of the
    plain stem (1e-5)."""
    from multimodal_dataset_distillation_tpu.data import textcache as jtc
    from multimodal_dataset_distillation_tpu_torch.ops import zca as pzca
    from test_torch_zoo_clip import narrow_towers

    narrow_towers(monkeypatch)
    monkeypatch.delenv("MDD_STEM_S2D", raising=False)
    built, fitted = [], []
    build = pcli.build_bi_encoder

    def keep(cfg, device=None):
        built.append(build(cfg, device))
        return built[-1]

    class Keep(pzca.ZCAWhitening):
        def fit(self, images):
            fitted.append(self)
            return super().fit(images)

        def transform(self, images):
            self.whitened = super().transform(images)
            return self.whitened

    monkeypatch.setattr(pcli, "build_bi_encoder", keep)
    monkeypatch.setattr(pcli, "ZCAWhitening", Keep)

    def run(work, **extra):
        (tmp_path / work).mkdir()
        monkeypatch.chdir(tmp_path / work)
        cfg = _cfg(tmp_path / work, Iteration=1, eval_it=2, num_eval=1,
                   save_pt=True, **{**flag, **extra})
        distiller, history = pcli.main(cfg)
        losses = _losses(cfg)
        assert sorted(losses) == [0, 1]
        assert all(map(np.isfinite, losses.values()))
        assert [it for it, _ in history] == [0]
        assert all(np.isfinite(v) and 0 <= v <= 100
                   for v in history[0][1][0].values())
        return cfg, distiller, losses

    cfg, distiller, losses = run("run")
    jcfg = JConfig(**{**KW, **flag})

    def no_process(*a, **k):
        raise AssertionError("the JAX package recomputed a port cache")

    z = jtc.load_or_process_file("text", no_process, jcfg, None)
    assert z["bert_test_embed"].shape[1] == 128
    img = tmp_path / "run" / "buffers" / "img_replay_buffer_0.npz"
    (traj,) = jbuffer_io.load_buffer(str(img))
    assert traj.shape[1] == sum(
        p.numel() for p in distiller.model.image_encoder.parameters())
    run_dir = tmp_path / "run" / "logs" / "synthetic" / "run"
    image_syn, _, _ = load_distilled(str(run_dir / "distilled_0.npz"))
    if cfg.zca:
        (zca,) = fitted
        want = zca.inverse_transform(image_syn).transpose(0, 3, 1, 2)
        got = torch.load(run_dir / "images_zca_0.pt", weights_only=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert (run_dir / "zca_synthetic_images_0.png").exists()
        assert (run_dir / "clipped_zca_synthetic_images_0_std_2.5.png"
                ).exists()
        # the real-pair init was whitened (the eval block at iteration 0
        # saw the init)
        np.testing.assert_array_equal(image_syn, zca.whitened)
    else:
        assert not fitted and not (run_dir / "images_zca_0.pt").exists()
    if cfg.stem_s2d:
        assert all(m.image_encoder.model.stem.s2d for m in built)
        assert len(built) >= 3   # the start-up check, the student, eval
        _, _, plain = run("plain", stem_s2d=False)
        assert not built[-1].image_encoder.model.stem.s2d
        np.testing.assert_allclose([losses[i] for i in (0, 1)],
                                   [plain[i] for i in (0, 1)], rtol=1e-5)


@pytest.mark.parametrize("flag,match", [
    (dict(image_encoder="resnet18"), "BatchNorm"),
    (dict(image_encoder="resnet50"), "BatchNorm"),
    (dict(image_encoder="convnet", only_has_image_projection=True),
     "--only_has_image_projection")])
def test_what_jax_cannot_distill_raises_at_start_up(tmp_path, monkeypatch,
                                                    flag, match):
    """The JAX Distiller cannot run these (tests/test_torch_zoo_distill.py
    shows it raising): the port refuses them before any data is read."""
    def no_data(cfg):
        raise AssertionError("data was read before the check")

    monkeypatch.setattr(pcli, "get_dataset", no_data)
    with pytest.raises(ValueError, match=match):
        pcli.main(_cfg(tmp_path, **flag))


@pytest.mark.parametrize("flag", [
    dict(image_encoder="vit"), dict(image_encoder="nf_resnet50"),
    dict(image_encoder="nf_regnet"), dict(image_encoder="resnet18_gn"),
    dict(image_encoder="convnet"), dict(transfer=True)])
def test_ported_towers_reach_the_data(tmp_path, monkeypatch, flag):
    class DataRead(Exception):
        pass

    def data(cfg):
        raise DataRead

    monkeypatch.setattr(pcli, "get_dataset", data)
    with pytest.raises(DataRead):
        pcli.main(_cfg(tmp_path, **flag))


def test_device_augment_is_accepted(tmp_path, monkeypatch):
    """``--device_augment`` goes on to the data, as in the JAX distill CLI
    (whose ``create_dataset`` then installs the raw-crop train transform:
    tests/test_torch_data.py)."""
    class DataRead(Exception):
        pass

    def data(cfg):
        assert cfg.device_augment
        raise DataRead

    monkeypatch.setattr(pcli, "get_dataset", data)
    with pytest.raises(DataRead):
        pcli.main(_cfg(tmp_path, device_augment=True))


def test_no_card_raises_and_never_falls_back(tmp_path, monkeypatch):
    """The card is the default device: without one the entry point raises,
    as a function and as ``python -m``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pcli.main(_cfg(tmp_path, device="cuda"))
    proc = subprocess.run(
        [sys.executable, "-m",
         "multimodal_dataset_distillation_tpu_torch.cli.distill",
         "--dataset=synthetic", "--image_encoder=nf_tiny",
         f"--save_dir={tmp_path}", f"--buffer_path={tmp_path}"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO),
                           "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert not (tmp_path / "synthetic_bert_text_embed.npz").exists()
