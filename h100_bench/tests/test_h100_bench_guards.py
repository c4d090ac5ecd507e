"""Guards of the benchmark: what it imports, when it refuses to start,
that BENCHMARK.json's entries all have their files, and that a new
configuration, cell, traffic mix and metric are found as files alone."""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys

import pytest

import bench_toy
from bench_toy import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def imports(path):
    """Top-level names a module imports, import_module's literal prefixes
    included (the drivers import the program by name)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    bad = imports(path) & {"jax", "jaxlib", "flax",
                           "multimodal_dataset_distillation_tpu"}
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    assert "import_module(\"multimodal_dataset_distillation_tpu." not in text


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imports(path)
    assert "multimodal_dataset_distillation_tpu_torch" not in names
    assert not names & {"chip_smoke", "tools"}
    assert "multimodal_dataset_distillation_tpu" not in path.read_text()


def test_forbidden_compares_whole_names(monkeypatch):
    from h100_bench import harness

    monkeypatch.setitem(sys.modules, "multimodal_dataset_distillation_tpu_torch_x",
                        sys.modules[__name__])
    assert "multimodal_dataset_distillation_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "multimodal_dataset_distillation_tpu.ops",
                        sys.modules[__name__])
    assert harness.forbidden_loaded() == ["multimodal_dataset_distillation_tpu"]


@pytest.mark.parametrize("var", ["MDD_PALLAS_GCONV", "MDD_STEM_S2D", "MDD_FUSED_JVP"])
def test_refuses_route_overrides(var):
    env = {**os.environ, var: ""}
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "nfnet_l0.distill_f32", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and var in p.stderr
    assert p.stdout == ""


def test_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if not k.startswith("MDD_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "nfnet_l0.expert", "--seed", "2147483648", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and "CUDA card" in p.stderr
    assert p.stdout == ""


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_every_file():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("h100_bench/")
        assert NAME.match(c["name"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        spec = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert {k: spec[k] for k in ("config", "traffic", "chips")} == {
            k: w[k] for k in ("config", "traffic", "chips")}
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "traffic" / f"{mix['kind']}.py").exists()
        assert set(spec["limits"]) and all(v > 0 for v in spec["limits"].values())
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for cell in cells:
        from h100_bench import harness

        c = harness.load_cell(cell)
        assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_hbm_gib"}
        assert len(c.end_to_end) >= 3 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_each_reader_is_silent_without_a_reading(metric):
    from h100_bench import harness

    rec = harness.Records("distill" if "distill" in metric else "expert",
                          json.loads((BENCH / "configs" / "nfnet_l0.json").read_text()))
    assert harness.reader(metric).read(rec) is None


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_config_mix_and_metric_are_files_only(tmp_path):
    from h100_bench import harness

    root = bench_toy.make(tmp_path)
    before = digest(root / "h100_bench")
    b = root / "h100_bench"
    (b / "metrics" / "steps_seen.distill.py").write_text(
        "def read(rec):\n    return float(len(rec.spans.get('cycler', []))) or None\n")
    benchjson = json.loads((root / "BENCHMARK.json").read_text())
    benchjson["per_layer"].append(
        {"name": "steps_seen.distill", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "trajectory feed", "moves": "outer_steps_per_s",
         "workloads": ["toy.distill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(benchjson))
    after = digest(b)
    assert {k: after[k] for k in before} == before
    cell = harness.load_cell("toy.distill", root, b)
    assert cell.cfg["name"] == "toy" and cell.kind == "distill"
    assert "steps_seen.distill" in [m["name"] for m in cell.per_layer]
    rec = harness.Records("distill", cell.cfg, spans={"cycler": [0.1, 0.2]})
    assert harness.reader("steps_seen.distill", b).read(rec) == 2.0
    assert harness.load_cell("toy.expert", root, b).mix["pool"] == 16
