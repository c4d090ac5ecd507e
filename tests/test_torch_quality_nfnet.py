"""The headline-scale quality recipe of the port
(``tools/torch_quality_nfnet.sh``) against the JAX package's
(``tools/quality_nfnet.sh``), on the CPU.

(i) The recipe's buffer and distill command lines, parsed by each
package's own parser, set what the JAX lines set, but for the listed
exceptions.  (ii) The recipe's outer settings (real-pair init,
lr_img=lr_txt=100, lr_lr=1e-5, forward-HVP, --std) through both distill
CLIs at the toy widths of ``tests/test_torch_distill_cli.py``, float32
inner, 3 iterations: grand losses within 1e-3 relative.  (iii) ``ipc=50``
against ``ipc=1`` in the port's distill CLI: the same losses and
``distilled_{it}.npz`` contents, and no image grid at 50.  Also: the
recipe refuses to start under a route override, and
``tools/torch_quality_summary.py`` reads such runs and holds them to the
decision rule of PERF.md section 6.
"""

import json
import math
import os
import shlex
import subprocess
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest

from multimodal_dataset_distillation_tpu.cli import distill as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.config import (
    parse_config as jparse_config,
)
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu_torch.cli import distill as pcli
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.config import (
    parse_config as pparse_config,
)
from test_torch_distill_cli import (
    KW,
    _eval_stub,
    _jax_traj,
    _jax_tree,
    _losses,
    _no_dropout_jax,
    _no_dropout_port,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
#: the fields in which the port's recipe departs from the JAX one, and why
EXCEPTIONS = {
    "pallas_gconv": "the port's hand-written grouped-conv kernels are what "
                    "the rehearsal runs on the card (the JAX runs used "
                    "XLA's conv)",
    "seed": "each run's --seed: the recipe runs at several seeds",
    "eval_it": "eval blocks every EVAL_IT iterations (the JAX line's 50 is "
               "the default; the soak takes 100)",
    "num_eval": "two students a block, as the JAX run at QUALITY.md:96-97, "
                "so that each block has a spread",
    "draw": "the distill CLI writes distilled_{it}.npz only under --draw",
    "ipc": "ipc >= 50 skips the two image grids as the reference gates "
           "them; ipc reaches nothing else in the distill CLI",
    "buffer_path": "a path: the work directory's",
    "save_dir": "a path: the work directory's",
}


def _jax_line(script: str, cli: str) -> list:
    """The arguments after the ``<repo>/<cli>`` script in a JAX recipe."""
    text = (REPO / "tools" / script).read_text().replace("\\\n", " ")
    for line in text.splitlines():
        words = shlex.split(line)
        at = [i for i, w in enumerate(words) if w.endswith(f"/{cli}")]
        if at:
            return words[at[0] + 1:]
    raise AssertionError(f"no {cli} line in {script}")


def _port_lines(**knobs) -> dict:
    """The recipe's own buffer and distill argument lists (PRINT_ARGS=1),
    with none of its knobs set but ``knobs``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("SEED", "NEXP", "TEPOCHS", "ITERS", "EVAL_IT",
                        "NUM_EVAL", "CKPT_IT", "PALLAS", "BUFFERS",
                        "RESUME", "WORK", "LOAD_ALL")}
    out = subprocess.run(
        ["bash", str(REPO / "tools" / "torch_quality_nfnet.sh")],
        env={**env, "PRINT_ARGS": "1", **knobs}, check=True,
        capture_output=True, text=True).stdout
    return {line.split()[0]: shlex.split(line)[1:]
            for line in out.splitlines()}


def _fields(words: list) -> set:
    return {w[2:].split("=")[0] for w in words if w.startswith("--")}


@pytest.mark.parametrize("cli,kind,defaults", [
    ("buffer.py", "buffer", dict(image_encoder="nfnet")),
    ("distill.py", "distill", dict(image_encoder="nfnet", Iteration=5000)),
])
def test_recipe_sets_what_the_jax_recipe_sets(cli, kind, defaults):
    jwords = _jax_line("quality_nfnet.sh", cli)
    pwords = _port_lines()[kind]
    jcfg = jparse_config(jwords, defaults=JConfig(**defaults))
    pcfg = pparse_config(pwords, defaults=Config(**defaults))
    differ = {f for f in _fields(jwords) if getattr(jcfg, f)
              != getattr(pcfg, f)}
    assert differ <= set(EXCEPTIONS), differ
    assert _fields(pwords) - _fields(jwords) <= set(EXCEPTIONS)
    assert pcfg.image_size == 224 and pcfg.image_encoder == "nfnet"
    if kind == "distill":
        assert (pcfg.pallas_gconv, pcfg.draw, pcfg.ipc, pcfg.num_eval,
                pcfg.eval_it) == (True, True, 50, 2, 50)
        assert (pcfg.num_queries, pcfg.mini_batch_size, pcfg.syn_steps,
                pcfg.inner_dtype, pcfg.hvp_mode) == (100, 100, 8,
                                                     "bfloat16", "forward")


@pytest.mark.parametrize("knob", [None, "0", "1"])
def test_load_all_knob(knob):
    """``LOAD_ALL=1`` adds ``--load_all True`` to the distill line alone,
    and both packages' parsers read it there (the JAX distill CLI has the
    flag); unset or 0, the line is as before."""
    lines = _port_lines(**({} if knob is None else {"LOAD_ALL": knob}))
    want = knob == "1"
    assert ("--load_all" in lines["distill"]) is want
    assert "--load_all" not in lines["buffer"]
    for parse, config in ((pparse_config, Config), (jparse_config, JConfig)):
        cfg = parse(lines["distill"], defaults=config(image_encoder="nfnet",
                                                      Iteration=5000))
        assert cfg.load_all is want


@pytest.mark.parametrize("var", ["MDD_PALLAS_GCONV", "MDD_FUSED_JVP",
                                 "MDD_STEM_S2D"])
def test_recipe_refuses_an_override(var, tmp_path):
    """As chip_smoke.py: a route override in the environment, empty
    included, would change what the recipe runs; it refuses to start,
    before it touches its work directory."""
    work = tmp_path / "work"
    res = subprocess.run(
        ["bash", str(REPO / "tools" / "torch_quality_nfnet.sh")],
        env={**os.environ, var: "", "WORK": str(work)},
        capture_output=True, text=True)
    assert res.returncode == 4 and var in res.stderr
    assert not work.exists()


class _Encoder:
    """The frozen text tower's stand-in on both sides: a caption's
    embedding is drawn from a seed made from its text, so both CLIs' real-
    pair inits hold the same texts (their BERTs' random inits differ)."""
    hidden_size = 128

    def encode(self, texts, chunk_size=None):
        return np.stack([np.random.RandomState(
            zlib.crc32(t.encode())).randn(self.hidden_size).astype(
                np.float32) for t in texts])


def _outer(tmp, **kw):
    """The recipe's outer settings at the toy widths."""
    return {**KW, "pix_init": "real", "txt_init": "real", "lr_img": 100.0,
            "lr_txt": 100.0, "lr_lr": 1e-5, "lr_teacher_img": 0.1,
            "lr_teacher_txt": 0.1, "hvp_mode": "forward",
            "inner_dtype": "float32", "std": True, "num_eval": 1,
            "buffer_path": str(tmp / "buffers"), **kw}


@pytest.fixture(scope="module")
def buffers(tmp_path_factory):
    root = tmp_path_factory.mktemp("quality_nfnet")
    tree = _jax_tree()
    jbuffer_io.save_expert(str(root / "buffers"),
                           _jax_traj(tree["image_encoder"]),
                           _jax_traj(tree["text_projection"], seed=1))
    return root


def _run(monkeypatch, root, side, **kw):
    (root / f"cwd_{side}").mkdir()
    monkeypatch.chdir(root / f"cwd_{side}")
    if side == "jax":
        cfg = JConfig(**_outer(root, mesh_shape=(1,),
                               save_dir=str(root / side), **kw))
        return cfg, jcli.main(cfg)
    cfg = Config(**_outer(root, device="cpu", save_dir=str(root / side),
                          **kw))
    return cfg, pcli.main(cfg)


@pytest.fixture
def clis(monkeypatch):
    for cli, no_dropout in ((pcli, _no_dropout_port),
                            (jcli, _no_dropout_jax)):
        monkeypatch.setattr(cli, "build_bi_encoder",
                            no_dropout(cli.build_bi_encoder))
        monkeypatch.setattr(cli, "evaluate_synset", _eval_stub)
        monkeypatch.setattr(cli, "make_text_encoder", lambda cfg: _Encoder())


def test_outer_settings_match_the_jax_cli(buffers, clis, monkeypatch):
    out = {side: _run(monkeypatch, buffers, side) for side in ("port", "jax")}
    lp, lj = (_losses(out[s][0]) for s in ("port", "jax"))
    assert sorted(lp) == sorted(lj) == [0, 1, 2]
    for it in lj:
        assert np.isfinite(lp[it])
        np.testing.assert_allclose(lp[it], lj[it], rtol=1e-3,
                                   err_msg=f"iteration {it}")


def _members(npz: Path) -> dict:
    with zipfile.ZipFile(npz) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_ipc_50_skips_the_grids_only(buffers, clis, monkeypatch):
    runs = {ipc: _run(monkeypatch, buffers, f"ipc{ipc}", ipc=ipc)[0]
            for ipc in (1, 50)}
    assert _losses(runs[1]) == _losses(runs[50])
    dirs = {ipc: Path(cfg.save_dir) / "synthetic" / "run"
            for ipc, cfg in runs.items()}
    for it in (0, 2):
        assert (_members(dirs[1] / f"distilled_{it}.npz")
                == _members(dirs[50] / f"distilled_{it}.npz"))
    assert sorted(p.name for p in dirs[1].glob("*.png"))
    assert not list(dirs[50].glob("*.png"))


def _load_summary():
    import importlib.util

    path = REPO / "tools" / "torch_quality_summary.py"
    spec = importlib.util.spec_from_file_location("torch_quality_summary",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _headline_run(work: Path, losses: dict, blocks: dict, peaks=None,
                  calls=None):
    """A headline-scale run's files as the recipe leaves them: the distill
    CLI's JSONL (grand losses, the blocks' Mean/Std rows) and its log
    (each block's students, the allocator's peaks, the wrapper's line)."""
    (work / "logged_files").mkdir(parents=True)
    rows = [{"step": it, "Grand_Loss": v} for it, v in losses.items()]
    rows += [{"step": it, "Mean/r_mean": float(np.mean(v)),
              "Std/r_mean": float(np.std(v))} for it, v in blocks.items()]
    rows.sort(key=lambda r: (r["step"], "Grand_Loss" in r))
    (work / "logged_files" / "run.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n")
    lines = []
    for it, vals in blocks.items():
        lines += [f"Evaluate_{j:02d}: txt_r1=1.0000 r_mean={v:.4f}"
                  for j, v in enumerate(vals)]
        if peaks:
            lines.append(f"[hbm post-eval it={it}] in_use=1 MiB "
                         f"peak={peaks[it]} MiB reserved=2 MiB")
    wrap = {"launches": {"gconv3x3_fwd_tc": 1216 * len(losses)},
            "wall_s": 1.0, "nan_bailout_it": None,
            "step_calls_s": calls or [float(k) for k in range(len(losses))]}
    lines.append("distill wrapper: " + json.dumps(wrap))
    (work / "distill.log").write_text("\n".join(lines) + "\n")
    return str(work)


def test_quality_summary_holds_runs_to_the_rule(tmp_path, capsys):
    """``--rule``: each run's blocks, gain and its standard error (the
    students' sample std), loss ratio, seconds per step (intervals before
    an eval block left out), peaks and launches; the verdicts R1-R6 as
    PERF.md section 6 words them; ``--welch`` on gains."""
    tool = _load_summary()
    its = range(0, 101)
    loss = {it: 1.0 - 0.007 * it for it in its}
    calls = [2.0 * k + (3.0 if k >= 50 else 0.0) for k in its]   # block 50
    seeds = [_headline_run(tmp_path / f"a{s}", loss,
                           {0: [30.0, 31.0], 50: [40.0, 41.0],
                            100: [44.0 + s, 46.0 + s]}, calls=calls)
             for s in range(3)]
    off = _headline_run(tmp_path / "b", {**loss, 60: loss[60] * 1.2},
                        {0: [30.0, 31.0], 100: [43.0, 47.0]})
    resume = _headline_run(tmp_path / "c",
                           {it: loss[it] for it in its if it > 50},
                           {100: [45.0, 47.0]})
    soak = _headline_run(tmp_path / "d", {it: 1.0 for it in range(401)},
                         {0: [30.0, 30.0], 100: [46.0, 46.0],
                          200: [42.5, 42.5], 300: [47.0, 47.0],
                          400: [46.0, 46.0]},
                         peaks={0: 100, 100: 1000, 200: 1004, 300: 1004,
                                400: 1005})
    out = tool.main(["--rule", f"seeds={','.join(seeds)}", f"off={off}",
                     f"resume={resume}", f"soak={soak}"])
    a0 = out["runs"][seeds[0]]
    assert a0["blocks"][100] == {"values": [44.0, 46.0], "mean": 45.0,
                                 "std": np.std([44.0, 46.0], ddof=1), "n": 2}
    assert math.isclose(a0["gain"], 14.5)
    assert math.isclose(a0["gain_se"], math.sqrt((0.5 + 2.0) / 2))
    assert math.isclose(a0["loss_ratio"], loss[100] / loss[0])
    # the intervals before the blocks at 50 and 100 are left out
    assert a0["s_per_step"] == {"median": 2.0, "mean": 2.0, "n": 98}
    assert a0["launches"] == {"gconv3x3_fwd_tc": 1216 * 101}
    assert out["R3"]["gains"] == [14.5, 15.5, 16.5]
    assert math.isclose(out["R3"]["two_se"], 2 * 1.0 / math.sqrt(3))
    assert not out["R3"]["welch"]["differs"]
    r4 = out["R4"]
    assert r4["loss0_rel"] == 0.0 and r4["gain_diff"] == 0.0
    assert math.isclose(r4["two_se"], 2 * math.hypot(
        a0["gain_se"], math.sqrt((0.5 + 8.0) / 2)))
    assert math.isclose(r4["mean_loss_rel"], 0.2 * loss[60] / 50 / np.mean(
        [loss[it] for it in its if it > 50]))
    assert out["R5"] == {"steps": [51, 100], "max_abs_diff": 0.0,
                         "bitwise": True}
    assert math.isclose(out["R6"]["peak_growth"], 0.005)
    # R6: r_mean 42.5 at 200 is below 46 at 100 less 3
    assert out["verdict"] == {"R1": True, "R2": True, "R3": True,
                              "R4": True, "R5": True, "R6": False}
    assert "R6: FAILS" in capsys.readouterr().out
    # a soak that stops before the block at 400 is not judged to hold
    cut = _headline_run(tmp_path / "d_cut", {it: 1.0 for it in range(343)},
                        {0: [30.0, 30.0], 100: [46.0, 46.0],
                         200: [46.0, 46.0], 300: [46.0, 46.0]},
                        peaks={0: 100, 100: 1000, 200: 1000, 300: 1000})
    r6 = tool.rule(soak=[cut])
    assert r6["R6"]["missing_blocks"] == [400]
    assert r6["R6"]["peak_growth"] is None and r6["verdict"]["R6"] is False
    w = tool.main(["--welch", "15.52", "16.77", "5.47", "18.18", "--",
                   *seeds])["tests"]["gain"]
    assert w["a"] == [15.52, 16.77, 5.47, 18.18] and w["b"] == [14.5, 15.5,
                                                               16.5]
