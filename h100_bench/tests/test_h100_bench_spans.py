"""The per-layer metrics read from the program's own spans and counters
(``program_spans.py``): a toy cell traced on the CPU reports each of them
that needs no card, and each reads nothing from a program without the
recorder (the parent of the change that brought it)."""

import json

import pytest

import bench_toy
from bench_toy import BENCH

SPAN_METRICS = {
    "toy.distill": ["unroll_host_ms.distill", "meta_backward_host_ms.distill",
                    "cycler_copy_ms.distill"],
    "toy.expert": ["loader_ms.expert", "put_ms.expert", "step_host_ms.expert"]}


def _reset():
    from multimodal_dataset_distillation_tpu_torch.engine import distill  # noqa: F401
    from multimodal_dataset_distillation_tpu_torch.utils import logging as rlog

    rlog.reset()
    rlog.reset_counters("cycler")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = bench_toy.make(tmp_path_factory.mktemp("spans"))
    out = {}
    for cell in SPAN_METRICS:
        _reset()
        out[cell] = bench_toy.run_toy(root, cell, seed=2 ** 31 + 9, trace=1)
        out[cell]["spans"] = _spans()
    return out


def _spans():
    from multimodal_dataset_distillation_tpu_torch.utils import logging as rlog

    return rlog.spans()


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_toy_cell_reports_the_span_metrics(traced, cell):
    out = traced[cell]
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in SPAN_METRICS[cell]:
        if name != "cycler_copy_ms.distill":
            assert got[name]["value"] > 0, name
    if cell == "toy.distill":
        # the allocator's reading needs a CUDA device
        assert "unroll_saved_gib.distill" not in got
        # the copies of the profiled steps' segments (none where every one
        # hit the cache), inside those segments' spans (on the CPU the
        # stretch is one pass, so every step recorded is a profiled one)
        steps = [s for s in out["spans"] if s.name == "distill.step"]
        segs = [s for s in out["spans"] if s.name == "cycler.segment"]
        assert len(segs) == len(steps) > 0
        copy = got["cycler_copy_ms.distill"]["value"]
        assert copy == pytest.approx(
            sum(s.counts["copy_ns"] for s in segs) / len(segs) / 1e6)
        assert 0 <= copy <= max(s.end_ns - s.start_ns for s in segs) / 1e6
    else:
        assert got["put_ms.expert"]["value"] < got["step_host_ms.expert"]["value"]


@pytest.mark.parametrize("metric", [n for v in SPAN_METRICS.values() for n in v]
                         + ["unroll_saved_gib.distill"])
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, metric):
    from h100_bench import harness, trace
    from multimodal_dataset_distillation_tpu_torch.utils import logging as rlog

    monkeypatch.delattr(rlog, "RECORDER")
    rec = harness.Records("distill" if "distill" in metric else "expert",
                          json.loads((BENCH / "configs" / "nfnet_l0.json").read_text()))
    rec.trace = trace.Summary(steps=2, wall_s=1.0, busy_s=0.5, launches=10,
                              kernels=[], gaps=[])
    assert harness.reader(metric).read(rec) is None
