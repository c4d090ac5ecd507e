"""The port's spans and counters (``utils/logging.py``'s recorder).

Spans record only under ``torch.profiler``, on its clock, nested as the
program runs them: ``distill.step`` over ``distill.unroll`` and
``distill.meta_backward``, ``cycler.segment``, ``expert.step`` over
``expert.put``, and ``data.batch`` on its own.  Counters count always:
``cycler`` (``segments``, ``copy_ns``; the ``cycler.segment`` span carries
what they gain inside it) and ``launches`` (the grouped-conv kernels'
launches, ``ops/gconv.py::LAUNCHES``).  ``tools/torch_span_probe.py``
runs at the benchmark's toy cells.  Toy sizes on the CPU: NF_TINY at
32^2, the tiny text width.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from multimodal_dataset_distillation_tpu_torch.cli import distill as pcli
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data.pipeline import (
    ArrayPairLoader,
)
from multimodal_dataset_distillation_tpu_torch.engine import distill as edistill
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
    ExpertCycler,
    dummy_trajectory,
    noise_images,
    noise_texts,
)
from multimodal_dataset_distillation_tpu_torch.engine.expert import (
    BiEncoderTrainer,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc
from multimodal_dataset_distillation_tpu_torch.utils import logging as rlog
from test_torch_threads import share_cores  # noqa: F401 (autouse)

NQ, SIZE, TXT = 4, 32, 128
CFG = dict(image_encoder="nf_tiny", image_size=SIZE, num_queries=NQ,
           syn_steps=2, mini_batch_size=2, expert_epochs=1, lr_img=10.0,
           lr_txt=10.0, lr_lr=1e-2, lr_teacher_img=0.05,
           lr_teacher_txt=0.05, seed=0, pallas_gconv=True)
#: the clocks of the spans and of the profiler's events may differ by this
CLOCK_NS = 50_000


def _model():
    return init_bi_encoder(VLBiEncoder("nf_tiny", TXT, 128, gconv=True), 0)


def _distiller():
    """-> (a toy Distiller, its (img, txt) device trajectories)."""
    rng = np.random.RandomState(0)
    model = _model()
    d = Distiller(Config(**CFG), model, noise_images(NQ, SIZE, rng),
                  noise_texts(NQ, TXT, rng), device="cpu")
    trajs = []
    for tower in (model.image_encoder, model.text_projection):
        t = dummy_trajectory([p.detach().numpy() for p in tower.parameters()])
        trajs.append(d.put_trajectory(
            [np.concatenate([a.reshape(-1) for a in s]) for s in t]))
    return d, trajs


def _distill_steps(n):
    d, (img, txt) = _distiller()
    rng = np.random.RandomState(1)
    for _ in range(n):
        m = d.step_traj(img, txt, 0, d.sample_indices(rng))
        assert np.isfinite(float(m["grand_loss"]))


def _expert_steps(n):
    rs = np.random.RandomState(2)
    loader = ArrayPairLoader(rs.randn(4 * n, SIZE, SIZE, 3).astype(np.float32),
                             rs.randn(4 * n, TXT).astype(np.float32), 4,
                             seed=0)
    tr = BiEncoderTrainer(_model(), lr_img=0.01, lr_txt=0.01, seed=0)
    for images, texts in loader:
        loss, _ = tr.train_batch(images, texts)
        assert np.isfinite(float(loss))


def _profiled(fn):
    """-> the profiler's events while ``fn()`` ran, the spans recorded
    then (the recorder cleared first)."""
    rlog.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events(), rlog.spans()


def _cycler_files(tmp_path, n):
    tmpl = nn.Linear(2, 1)
    files = ([], [])
    for f in range(n):
        for kind, out in zip(("img", "txt"), files):
            path = str(tmp_path / f"{kind}_{f}.pt")
            torch.save([[[torch.full((1, 2), float(f)),
                          torch.full((1,), float(e))] for e in range(3)]],
                       path)
            out.append(path)
    return files, tmpl


@pytest.mark.parametrize("job", ["distill", "expert"])
def test_no_profiler_records_no_span_and_the_counters_count(tmp_path, job):
    rlog.reset()
    assert not torch.autograd._profiler_enabled()
    assert rlog.span("distill.step") is rlog.span("expert.put")
    if job == "distill":
        before = dict(edistill.CYCLER)
        files, tmpl = _cycler_files(tmp_path, 2)
        cyc = ExpertCycler(*files, 1, 1, tmpl, tmpl, load_all=True,
                           device="cpu")
        for _ in range(3):
            cyc.next_segment_device()
        assert edistill.CYCLER["segments"] == before["segments"] + 3
        assert edistill.CYCLER["copy_ns"] > before["copy_ns"]
        _distill_steps(1)
    else:
        _expert_steps(2)
    assert rlog.spans() == []


@pytest.mark.parametrize("job", ["distill", "expert"])
def test_spans_nest_as_the_program_runs(job):
    if job == "distill":
        _, got = _profiled(lambda: _distill_steps(2))
        steps = [s for s in got if s.name == "distill.step"]
        assert len(steps) == 2 and len(got) == 6
        for s in steps:
            assert s.parent is None and s.mem0 is None
            kids = [k for k in got if k.parent == s.id]
            assert [k.name for k in kids] == ["distill.unroll",
                                              "distill.meta_backward"]
            assert (s.start_ns <= kids[0].start_ns <= kids[0].end_ns
                    <= kids[1].start_ns <= kids[1].end_ns <= s.end_ns)
    else:
        _, got = _profiled(lambda: _expert_steps(3))
        by = {n: [s for s in got if s.name == n]
              for n in ("data.batch", "expert.step", "expert.put")}
        assert {n: len(v) for n, v in by.items()} == {
            "data.batch": 3, "expert.step": 3, "expert.put": 3}
        assert all(s.parent is None for s in by["data.batch"] + by["expert.step"])
        for put, step in zip(by["expert.put"], by["expert.step"]):
            assert put.parent == step.id
            assert step.start_ns <= put.start_ns <= put.end_ns <= step.end_ns
        # the loader's gather comes before the step it feeds
        for batch, step in zip(by["data.batch"], by["expert.step"]):
            assert batch.end_ns <= step.start_ns


def test_spans_share_the_profilers_clock():
    d, (img, txt) = _distiller()
    idx = d._indices(d.sample_indices(np.random.RandomState(1)))
    seeds = d.draw_seeds(len(idx))
    e = d.cfg.expert_epochs
    seg = img[0], txt[0], img[e], txt[e]
    events, got = _profiled(lambda: d._outer_update(*seg, idx, seeds))
    step, unroll, back = (next(s for s in got if s.name == n) for n in (
        "distill.step", "distill.unroll", "distill.meta_backward"))
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name().startswith("aten::")]
    assert len(ops) > 100
    for a, b in ops:
        assert step.start_ns - CLOCK_NS <= a and b <= step.end_ns + CLOCK_NS
    in_unroll = [b for a, b in ops if unroll.start_ns <= a <= unroll.end_ns]
    in_back = [a for a, b in ops if back.start_ns <= a <= back.end_ns]
    assert in_unroll and in_back
    assert max(in_unroll) <= back.start_ns + CLOCK_NS
    assert max(in_unroll) <= min(in_back) + CLOCK_NS


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("prefetch", [True, False])
def test_cycler_counts_segments_and_copies(tmp_path, monkeypatch, prefetch,
                                           profiled):
    files, tmpl = _cycler_files(tmp_path, 6)
    copies = []
    put = ExpertCycler._put
    monkeypatch.setattr(ExpertCycler, "_put", lambda self, a, b: (
        copies.append(1), put(self, a, b))[1])
    cyc = ExpertCycler(*files, 1, 1, tmpl, tmpl, seed=5, load_all=True,
                       device_cache_cap=4, prefetch=prefetch, device="cpu")
    rlog.reset_counters("cycler")
    seen, gained = [], []

    def walk():
        for k in range(1, 19):
            n0, t0 = len(copies), edistill.CYCLER["copy_ns"]
            cyc.next_segment_device()
            assert edistill.CYCLER["segments"] == k
            copied = len(copies) > n0
            gained.append(edistill.CYCLER["copy_ns"] - t0)
            assert (gained[-1] > 0) == copied
            seen.append(copied)

    if profiled:
        _, got = _profiled(walk)
        # each segment's span carries what the counters gained inside it
        assert [s.counts for s in got] == [
            {"segments": 1, "copy_ns": g} for g in gained]
        assert all(s.name == "cycler.segment" for s in got)
    else:
        walk()
    # 6 trajectories over 4 slots: some segments copy, some hit the cache
    assert any(seen) and not all(seen)


def test_the_distill_cli_writes_its_spans_into_the_trace(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(dataset="synthetic", synthetic_size=8, synthetic_test_size=4,
                 text_encoder_config="tiny", text_pretrained=False,
                 image_pretrained=False, max_start_epoch=2, Iteration=2,
                 eval_it=100, num_eval=0, epoch_eval_train=1, batch_train=4,
                 batch_size_test=4, k_test=4, num_workers=0,
                 parallel_eval=False, disable_wandb=True, name="run",
                 buffer_path=str(tmp_path / "buffers"),
                 save_dir=str(tmp_path / "logs"), device="cpu",
                 profile_dir=str(tmp_path / "prof"), **CFG)
    rlog.reset()
    pcli.main(cfg)
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    events = trace["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    # the profiled iteration's spans, on one row, at the profiler's base
    assert [e["name"] for e in mine] == [
        "cycler.segment", "distill.step", "distill.unroll",
        "distill.meta_backward"]
    assert {(e["pid"], e["tid"]) for e in mine} == {(mine[0]["pid"],
                                                     rlog.SPAN_TID)}
    for e, s in zip(mine, rlog.spans()):
        assert e["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-3)
        assert e["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3,
                                         abs=1e-3)
    assert mine[0]["args"]["segments"] == 1
    assert mine[0]["args"]["copy_ns"] == rlog.spans()[0].counts["copy_ns"]
    step = mine[1]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")
           and step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
    assert len(ops) > 100
    for e in ops:
        assert e["ts"] + e["dur"] <= step["ts"] + step["dur"] + CLOCK_NS / 1e3


def test_launches_are_a_counter_group_of_the_recorder():
    assert gc.LAUNCHES is rlog.RECORDER.counters["launches"]
    assert edistill.CYCLER is rlog.RECORDER.counters["cycler"]
    saved = dict(gc.LAUNCHES)
    try:
        gc.LAUNCHES["gconv3x3_fwd_tf32"] += 2
        rlog.reset()     # spans only
        assert gc.LAUNCHES["gconv3x3_fwd_tf32"] == saved["gconv3x3_fwd_tf32"] + 2
        gc.reset_launches()
        assert set(gc.LAUNCHES.values()) == {0}
    finally:
        gc.LAUNCHES.update(saved)


def test_the_span_probe_runs_at_the_toy_cells(tmp_path):
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_span_probe.py"
    spec = importlib.util.spec_from_file_location("torch_span_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    out = tmp_path / "probe.json"
    assert probe.main(["--toy", "--distill_rounds", "1", "--expert_rounds",
                       "2", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["recorded_in_profile"] == ["probe"]
    assert 0 < got["disabled_span_ns"][0] <= got["disabled_span_ns"][1]
    for kind, names, rounds in (
            ("distill", {"distill.step", "distill.unroll",
                         "distill.meta_backward", "cycler.segment"}, 1),
            ("expert", {"data.batch", "expert.step", "expert.put"}, 2)):
        job = got[kind]
        assert set(job["spans"]) == names
        assert job["spans_per_step"] == len(names)
        assert set(job["idle_ms_by_span"]) <= names | {"outside any span"}
        assert {k: len(v) for k, v in job["cost_on"]["walls_s"].items()} == {
            "on": rounds, "off": rounds, "off_again": rounds}
        assert len(job["clock_on_stretches"]) == rounds
    # the probe leaves the program's spans on
    assert all(m.span is rlog.span for m in probe.SPAN_MODULES)
