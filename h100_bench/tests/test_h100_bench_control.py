"""The control of each cell comes out not correct, at the cell's own size,
on three seeds: the program's own lower path, or the reference computed
in the next lower precision, in the program's place.  Needs the card:

    python -m pytest --noconftest -o addopts="" -m cuda h100_bench/tests/test_h100_bench_control.py
"""

import json

import pytest
import torch

from bench_toy import ROOT
from h100_bench import calibrate, harness
from h100_bench.reference import compare

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's size")
    c = harness.load_cell(cell)
    for seed in (2147483001, 2147483002, 2147483003):
        got = calibrate.readings(c, seed, ["control"])["control"]
        assert not compare.judge(got, c.spec["limits"]), (seed, got)
