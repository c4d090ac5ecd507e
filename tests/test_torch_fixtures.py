"""The port's fixture writer (``tools/torch_make_fixtures.py``) against the
JAX package's (``tools/make_fixtures.py``), byte for byte; the ROCO
fixture through the port's three CLIs on the CPU; and the caption caches
of the offline text tower, whose random init once left the quality
rehearsal's experts at chance (``ROADMAP.md`` C3).
"""

import csv
import glob
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu.engine.distill import (
    Distiller as JDistiller,
)
from multimodal_dataset_distillation_tpu.engine.expert import (
    init_bi_encoder as jinit_bi_encoder,
)
from multimodal_dataset_distillation_tpu.models import bert as jbert
from multimodal_dataset_distillation_tpu.models.clip_model import (
    build_bi_encoder as jbuild_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.cli import buffer as pbuffer
from multimodal_dataset_distillation_tpu_torch.cli import distill as pdistill
from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled as peval
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import create_dataset
from multimodal_dataset_distillation_tpu_torch.data.caption import pre_caption
from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import load_buffer
from multimodal_dataset_distillation_tpu_torch.engine.distill import Distiller
from multimodal_dataset_distillation_tpu_torch.models import bert
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    build_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import flat_from_jax
from test_torch_threads import share_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "torch_make_fixtures.py")


def _load_tool():
    spec = importlib.util.spec_from_file_location("torch_make_fixtures", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**"), recursive=True)):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("args", [["roco", "8"], ["coco", "6", "3"]],
                         ids=["roco", "coco"])
def test_fixtures_match_the_jax_tool_byte_for_byte(args, tmp_path):
    """Both tools as their users run them; the port's in a process that
    then has imported nothing of JAX or of the JAX package."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "make_fixtures.py"),
                    args[0], jout, *args[1:]], check=True, env=env,
                   capture_output=True)
    probe = (f"import runpy, sys; sys.argv = {[TOOL, args[0], pout, *args[1:]]!r}; "
             f"runpy.run_path({TOOL!r}, run_name='__main__'); "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'flax', 'multimodal_dataset_distillation_tpu')]; "
             "assert not bad, bad")
    subprocess.run([sys.executable, "-c", probe], check=True, env=env,
                   capture_output=True)
    want, got = _tree(jout), _tree(pout)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if args[0] == "roco":
        assert "images/ROCOv2_2023_000002.jpg" not in got   # missing file
        assert len(got["images/ROCOv2_2023_000001.jpg"]) == 40   # truncated
        rows = list(csv.DictReader(open(os.path.join(
            pout, "radiologytraindata.csv"))))
        assert [r["id"] for r in rows] == [f"R{i:05d}" for i in range(8)]
    else:
        train = json.load(open(os.path.join(pout, "ann",
                                            "coco_karpathy_train.json")))
        assert len(train) == 12 and train[0]["image_id"] == train[1]["image_id"]
        test = json.load(open(os.path.join(pout, "ann",
                                           "coco_karpathy_test.json")))
        assert len(test) == 3 and len(test[0]["caption"]) == 5
        assert test[0]["image"].startswith("val2014/")


def test_the_writer_refuses_an_unknown_kind(tmp_path):
    tool = _load_tool()
    with pytest.raises(SystemExit, match="unknown fixture kind"):
        tool.main(["flickr", str(tmp_path)])
    with pytest.raises(SystemExit):
        tool.main(["roco"])


def test_roco_fixture_through_the_three_clis(tmp_path, monkeypatch, capsys):
    """``cli.buffer_roco``'s defaults -> ``cli.distill`` -> ``cli.
    eval_distilled`` on the CPU, 1 expert x 1 epoch and 2 iterations;
    the truncated and the missing JPEG take the black-image fallback."""
    fixture = str(tmp_path / "fixture")
    _load_tool().make_roco(fixture, 40)
    monkeypatch.chdir(tmp_path)
    from multimodal_dataset_distillation_tpu_torch.cli.buffer_roco import DEFAULTS

    common = dict(image_root=os.path.join(fixture, "images"),
                  ann_root=os.path.join(fixture, "radiologytraindata.csv"),
                  text_encoder_config="tiny", image_size=16,
                  image_encoder="convnet", batch_size_test=16, k_test=8,
                  num_workers=2, device="cpu")
    saved = pbuffer.main(DEFAULTS.replace(
        **common, num_experts=1, train_epochs=1, batch_size_train=8,
        buffer_path="./buffers", lr_teacher_img=0.1, lr_teacher_txt=0.1))
    assert saved == [0]
    bdir = "./buffers/roco/convnet/bert"
    assert os.path.exists(os.path.join(bdir, "img_replay_buffer_0.npz"))
    cfg = Config(dataset="roco", **common, num_queries=4, mini_batch_size=4,
                 syn_steps=2, expert_epochs=1, max_start_epoch=1,
                 Iteration=2, eval_it=2, num_eval=1, epoch_eval_train=1,
                 batch_train=4, buffer_path=bdir, save_dir="./logged_files",
                 lr_img=10.0, lr_txt=10.0, lr_lr=1e-6, disable_wandb=True)
    _, history = pdistill.main(cfg)
    assert [it for it, _ in history] == [0, 2]
    losses = []
    for path in glob.glob("./logged_files/*.jsonl"):
        for line in open(path):
            row = json.loads(line)
            if "Grand_Loss" in row:
                losses.append(row["Grand_Loss"])
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    npz = glob.glob("./logged_files/roco/*/distilled_2.npz")
    assert len(npz) == 1
    results = peval.main(cfg.replace(distilled_npz=npz[0], num_eval=2,
                                     std=True, parallel_eval=False),
                         argv=[])
    assert len(results) == 2
    for res in [r for _, rs in history for r in rs] + results:
        assert all(0.0 <= v <= 100.0 for v in res.values()), res
    out = capsys.readouterr().out
    assert "Mean/r_mean = " in out and "Std/r_mean = " in out


def _roco_captions(tmp_path, n=64):
    fixture = str(tmp_path / "fixture")
    _load_tool().make_roco(fixture, n)
    rows = csv.DictReader(open(os.path.join(fixture,
                                            "radiologytraindata.csv")))
    return [pre_caption(r["caption"], 30) for r in rows]


def _spread(emb):
    """(mean pairwise cosine of distinct rows, mean per-dimension std)."""
    n = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    cos = n @ n.T
    return (float(cos[np.triu_indices(len(emb), 1)].mean()),
            float(emb.std(0).mean()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offline_caption_caches_are_as_spread_as_jax(seed, tmp_path):
    """C3: the offline BERT tower (random init, hashing tokenizer) must
    give the ROCO fixture's captions distinct CLS rows, as the JAX tower
    does (pairwise cosine ~0.93-0.96); under HF's normal(0.02) init the
    port's rows were 0.9999 alike and every expert stayed at chance."""
    caps = _roco_captions(tmp_path)
    port = bert.TextEncoder("tiny", pretrained=False, seed=seed,
                            device="cpu").encode(caps)
    jax_ = np.asarray(jbert.TextEncoder(variant="tiny", pretrained=False,
                                        seed=seed)(caps))
    (pc, ps), (jc, js) = _spread(port), _spread(jax_)
    assert pc < 0.98 and jc < 0.98
    assert abs(pc - jc) < 0.05, (pc, jc)
    assert 0.6 < ps / js < 1.6, (ps, js)


def test_both_distillers_agree_on_the_roco_fixture(tmp_path, monkeypatch):
    """C3's check on the distill side: the rehearsal's path (ROCO fixture,
    ConvNet, BERT tiny caches, the recipe's LRs) through the port's expert
    CLI; its ``.npz`` buffer read by both packages; the fixture's first
    images and their caption rows as the synthetic set; three outer steps
    of the JAX and the port Distiller on the same segment and minibatches,
    held after each step (grand loss 5e-3 relative, each update 5e-3 of
    its largest entry); a failure names the step and the quantity."""
    nq, size = 8, 16
    fixture = str(tmp_path / "fixture")
    _load_tool().make_roco(fixture, 48)
    monkeypatch.chdir(tmp_path)
    from multimodal_dataset_distillation_tpu_torch.cli.buffer_roco import DEFAULTS

    common = dict(image_root=os.path.join(fixture, "images"),
                  ann_root=os.path.join(fixture, "radiologytraindata.csv"),
                  text_encoder_config="tiny", image_size=size,
                  image_encoder="convnet", batch_size_test=16, k_test=8)
    pbuffer.main(DEFAULTS.replace(
        **common, num_workers=2, num_experts=1, train_epochs=3,
        batch_size_train=8, buffer_path="./buffers", lr_teacher_img=0.1,
        lr_teacher_txt=0.1, device="cpu"))
    stem = "./buffers/roco/convnet/bert/{}_replay_buffer_0.npz"
    recipe = dict(image_encoder="convnet", image_size=size, num_queries=nq,
                  mini_batch_size=nq, syn_steps=2, expert_epochs=2,
                  lr_img=10.0, lr_txt=10.0, lr_lr=1e-6, lr_teacher_img=0.1,
                  lr_teacher_txt=0.1, text_encoder_config="tiny", seed=0)
    cfg = Config(dataset="roco", **{**common, **recipe}, device="cpu")
    # rows 1 and 2 (the truncated and the missing JPEG) are black: a
    # constant image under ConvNet's instance norm is ill-conditioned (its
    # variance is 0 up to rounding), and there the packages' float32 updates
    # differ by ~2e-2 of the largest, spreading to the other rows through
    # the shared students; the rows that load are held
    rows = [0] + list(range(3, nq + 2))
    test_split = create_dataset(cfg)[2]
    image_syn = np.stack([np.asarray(test_split[i][0], np.float32)
                          for i in rows])
    if image_syn.shape[1] == 3:   # CHW -> the Distillers' NHWC
        image_syn = image_syn.transpose(0, 2, 3, 1)
    with np.load("roco_bert_train_text_embed.npz") as z:
        text_syn = z["bert_test_embed"][rows].astype(np.float32)

    jcfg = JConfig(**recipe)
    jmodel = jbuild_bi_encoder(jcfg).clone(proj_dropout=0.0)
    jd = JDistiller(jcfg, jmodel, jinit_bi_encoder(jmodel, jcfg),
                    image_syn, text_syn)
    model = build_bi_encoder(cfg, device="cpu")
    model.text_projection.rate = 0.0
    d = Distiller(cfg, model, image_syn, text_syn, device="cpu")
    towers = (model.image_encoder, model.text_projection)
    jtraj = [jbuffer_io.load_trajectory_npz(stem.format(k))
             for k in ("img", "txt")]
    ptraj = [load_buffer(stem.format(k), t)[0]
             for k, t in zip(("img", "txt"), towers)]
    for j, p_, t in zip(jtraj, ptraj, towers):
        np.testing.assert_array_equal(p_, flat_from_jax(j, t))
    start, e = 1, recipe["expert_epochs"]
    jseg = (jtraj[0][start], jtraj[1][start], jtraj[0][start + e],
            jtraj[1][start + e])
    pseg = (ptraj[0][start], ptraj[1][start], ptraj[0][start + e],
            ptraj[1][start + e])
    rng = np.random.RandomState(1)
    before = [image_syn, text_syn, 0.1, 0.1]
    for step in range(3):
        idx = jd.sample_indices(rng)
        jm = jd.step(*jseg, idx)
        pm = d.step(*pseg, idx)
        np.testing.assert_allclose(
            float(pm["grand_loss"]), float(jm["grand_loss"]), rtol=5e-3,
            err_msg=f"step {step}: grand loss")
        js, ps = jd.state, d.state
        for name, b in zip(("image_syn", "text_syn", "syn_lr_img",
                            "syn_lr_txt"), before):
            want = np.asarray(getattr(js, name)) - b
            got = getattr(ps, name).detach().numpy() - b
            np.testing.assert_allclose(
                got, want, rtol=5e-3, atol=5e-3 * np.abs(want).max() + 1e-12,
                err_msg=f"step {step}: update of {name}")


def _load_summary():
    path = os.path.join(ROOT, "tools", "torch_quality_summary.py")
    spec = importlib.util.spec_from_file_location("torch_quality_summary",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quality_summary_reads_and_pools_the_eval_logs(tmp_path, capsys):
    """The recipes' summary: one rehearsal (the eval CLI's Mean/Std
    lines, the distill log's first and last Grand_Loss, phase seconds,
    the card line) and several (each run's means, the order tested on
    the runs' differences distilled - init and distilled - random)."""
    tool = _load_summary()
    students = {"distilled": [[6.0, 7.0], [5.0]], "init": [[5.0, 5.0], [6.0]],
                "random": [[5.0, 6.0], [4.0]]}
    works = []
    for i in range(2):
        work = tmp_path / f"run{i}"
        (work / "logged_files").mkdir(parents=True)
        for name, runs in students.items():
            vals = runs[i]
            lines = [f"Evaluate_{j:02d}: txt_r1=1.0000 r_mean={v:.4f}"
                     for j, v in enumerate(vals)]
            lines.append(f"Mean/r_mean = {np.mean(vals):.4f}  "
                         f"Std/r_mean = {np.std(vals):.4f}")
            (work / f"eval_{name}.log").write_text("\n".join(lines) + "\n")
        rows = [{"step": k, "Grand_Loss": 2.0 - 0.1 * k} for k in range(3)]
        (work / "logged_files" / "run.jsonl").write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n")
        works.append(str(work))
    (tmp_path / "run0" / "card.txt").write_text("H100, 700.00 W\n")
    one = tool.main([works[0], "fixture=10", "buffer=12.5", "end=20"])
    assert one["sets"]["distilled"] == {"mean": 6.5, "std": 0.5, "n": 2}
    assert one["loss_first"] == [0, 2.0] and one["loss_last"][0] == 2
    assert one["phase_s"] == {"fixture": 2.5, "buffer": 7.5}
    assert one["card"] == "H100, 700.00 W"
    assert math.isclose(one["two_se"], 2 * 0.5 / math.sqrt(2))
    assert one["order_holds"] is True
    both = tool.main(works)
    assert [r["distilled"] for r in both["runs"]] == [6.5, 5.0]
    assert both["runs"][0]["card"] == "H100, 700.00 W"
    di, dr = both["diffs"]["init"], both["diffs"]["random"]
    assert di["values"] == [1.5, -1.0] and dr["values"] == [1.0, 1.0]
    assert math.isclose(di["mean"], 0.25)
    assert math.isclose(di["std"], np.std([1.5, -1.0], ddof=1))
    assert math.isclose(di["two_se"], 2 * di["std"] / math.sqrt(2))
    assert dr["two_se"] == 0.0
    assert both["order_holds"] is False   # 0.25 < 2 x 1.25
    out = capsys.readouterr().out
    assert "r_mean distilled: 6.5000" in out and "card: H100" in out
    assert "distilled - init over 2 runs: 0.2500" in out


def test_quality_summary_welch_compares_two_groups_of_runs(tmp_path, capsys):
    """``--welch``: each group's per-run differences (a run given as a
    work directory or as a ``distilled/init/random`` triple), Welch's t
    and its Welch-Satterthwaite degrees of freedom as the closed forms
    give them, the two-sided p, and the 5% verdict."""
    tool = _load_summary()
    work = tmp_path / "run"
    work.mkdir()
    for name, v in (("distilled", 7.0), ("init", 5.0), ("random", 5.5)):
        (work / f"eval_{name}.log").write_text(
            f"Evaluate_00: r_mean={v:.4f}\n"
            f"Mean/r_mean = {v:.4f}  Std/r_mean = 0.0000\n")
    a = [str(work), "6.5/6.0/5.0", "6.0/5.0/5.5"]
    b = ["6.0/5.9/5.5", "6.1/6.0/5.9", "5.8/5.6/5.7", "6.2/6.0/5.6"]
    out = tool.main(["--welch", *a, "--", *b])
    assert out["a"][0] == {"distilled": 7.0, "init": 5.0, "random": 5.5}
    ti = out["tests"]["init"]
    assert np.allclose(ti["a"], [2.0, 0.5, 1.0])
    assert np.allclose(ti["b"], [0.1, 0.1, 0.2, 0.2])
    va = np.var(ti["a"], ddof=1) / 3
    vb = np.var(ti["b"], ddof=1) / 4
    assert math.isclose(ti["t"], (np.mean(ti["a"]) - np.mean(ti["b"]))
                        / math.sqrt(va + vb), rel_tol=1e-9)
    assert math.isclose(ti["df"], (va + vb) ** 2
                        / (va ** 2 / 2 + vb ** 2 / 3), rel_tol=1e-9)
    from scipy import stats

    assert math.isclose(ti["p"], 2 * stats.t.sf(ti["t"], ti["df"]),
                        rel_tol=1e-9)
    assert 0.1 < ti["p"] < 0.2 and ti["differs"] is False
    tr = out["tests"]["random"]
    assert np.allclose(tr["a"], [1.5, 1.5, 0.5])
    assert np.allclose(tr["b"], [0.5, 0.2, 0.1, 0.6])
    assert tr["differs"] is False
    text = capsys.readouterr().out
    assert "distilled - init: a 1.1667 over 3 runs, b 0.1500 over 4" in text
    mixed = tool.main([str(work), "6.5/6.0/5.0"])     # across runs
    assert mixed["runs"][1] == {"work": "6.5/6.0/5.0", "card": None,
                                "distilled": 6.5, "init": 6.0,
                                "random": 5.0}
    assert np.allclose(mixed["diffs"]["init"]["values"], [2.0, 0.5])
    far = tool.main(["--welch", "7.0/5.0/5.0", "7.1/5.0/5.0", "6.9/5.0/5.0",
                     "--", *b])
    assert far["tests"]["init"]["p"] < 0.05
    assert far["tests"]["init"]["differs"] is True
