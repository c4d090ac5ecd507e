"""A toy copy of the benchmark for the CPU tests: the repository's
``BENCHMARK.json`` and ``h100_bench/`` copied to a temporary directory,
with one configuration (the program's ``nf_tiny`` tower at 32^2, the tiny
text width, float32), two cells and a small expert mix added as files
only, as a later change would add them."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_TOWER = {"depths": [1, 2], "channels": [32, 64], "stem_type": "deep_quad",
             "stem_chs": 16, "group_size": 8, "bottle_ratio": 0.5,
             "extra_conv": True, "num_features": 128, "act": "silu",
             "attn_rd_ratio": 0.25, "attn_gain": 2.0, "alpha": 0.2,
             "skipinit": True, "drop_path_rate": 0.0, "num_classes": 0,
             "drop_rate": 0.0, "reg": False, "width_factor": 1.0, "ch_div": 8}
# the toy computes in float32: the program reads ~1e-7 against the
# reference there, so these limits leave it two orders of room
TOY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def toy_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "nfnet_l0.json").read_text())
    cfg.update(name="toy", port_encoder="nf_tiny", image_size=32,
               reference_rows=3, tower=dict(TOY_TOWER))
    cfg["text"] = {"embedding": 128, "dropout": 0.1, "port_config": "tiny"}
    cfg["init"]["trajectory_step"] = 0.01
    cfg["distill"].update(num_queries=8, mini_batch_size=4, syn_steps=2,
                          lr_img=10.0, lr_txt=10.0, inner_dtype="float32")
    cfg["expert"].update(batch=4)
    return cfg


def make(tmp: Path) -> Path:
    """-> the toy root (holding ``BENCHMARK.json`` and ``h100_bench/``)."""
    root = tmp / "toy"
    shutil.copytree(BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "toy", "reduced": [],
                             "file": "h100_bench/configs/toy.json", "why": "toy"})
    bench["workloads"] += [
        {"name": "toy.distill", "config": "toy", "traffic": "distill",
         "chips": 1, "why": "toy"},
        {"name": "toy.expert", "config": "toy", "traffic": "expert_toy",
         "chips": 1, "why": "toy"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "distill" if ("distill" in m["name"]
                                 or m["name"] == "outer_steps_per_s") else "expert"
            m["workloads"].append(f"toy.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = root / "h100_bench"
    (b / "configs" / "toy.json").write_text(json.dumps(toy_config()))
    (b / "traffic" / "expert_toy.json").write_text(json.dumps(
        {"kind": "expert", "pool": 16, "first_steps": 3, "reference_steps": 3,
         "profiled_steps": 6}))
    for name, traffic, control in (
            ("toy.distill", "distill", {"quant": "float8"}),
            ("toy.expert", "expert_toy",
             {"overrides": {"train_dtype": "bfloat16"}})):
        (b / "cells" / f"{name}.json").write_text(json.dumps(
            {"config": "toy", "traffic": traffic, "chips": 1, "why": "toy",
             "limits": TOY_LIMITS, "control": control}))
    return root


class Args:
    def __init__(self, workload, seed=7, seconds=0.5, trace=0):
        self.workload, self.seed, self.seconds, self.trace = (workload, seed,
                                                              seconds, trace)


def run_toy(root: Path, workload: str, **kw) -> dict:
    from h100_bench import run

    torch.set_num_threads(2)
    return run.run(Args(workload, **kw), device="cpu", root=root,
                   bench_dir=root / "h100_bench")
