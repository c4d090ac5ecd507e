"""Run-to-run reproducibility of the port's eval students and experts, and
the trajectory walk under ``--load_all``, on the CPU.

* An eval block (``evaluate_synset`` per student, or
  ``evaluate_synset_parallel``) run twice from one init and one set gives
  bit-identical accuracies, metrics, trained parameters and scores.
* Each trainer step's backward pass runs with cuDNN held to its
  deterministic algorithms (on the card, cuDNN's weight gradient of the NF
  stems' first conv otherwise sums in an order that varies between
  calls), and the setting is restored after it: the distill CLI's outer
  steps never run under it, and its grand losses are bit for bit the same
  with eval blocks between its steps as without them.
* ``ExpertCycler`` with and without ``load_all`` walks the same (file,
  expert, start) sequence and serves the same segments, over several
  reshuffles of the files.
* ``tools/torch_eval_repro.py`` (the card's repro of the above) runs to
  its end at its toy shape and finds the toy eval block bit-identical.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu_torch.cli import distill as pcli
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import datasets
from multimodal_dataset_distillation_tpu_torch.data import pipeline
from multimodal_dataset_distillation_tpu_torch.data import transforms
from multimodal_dataset_distillation_tpu_torch.engine import buffer_io
from multimodal_dataset_distillation_tpu_torch.engine import eval as teval
from multimodal_dataset_distillation_tpu_torch.engine import expert
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
    ExpertCycler,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from test_torch_distill_cli import _cfg, _losses
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE, N_TEST, N_SYN = 32, 8, 6
EVAL = dict(lr_net=0.05, batch_train=4, epoch_eval_train=1, k_test=16,
            seed=0, image_encoder="nf_tiny", image_size=SIZE, device="cpu")


def _student(seed: int):
    """A seeded NF_TINY student with its skipinit gains off zero (so every
    residual branch trains) and the projection's dropout on."""
    model = init_bi_encoder(VLBiEncoder("nf_tiny", 768, 128,
                                        proj_dropout=0.1, gconv=True), seed)
    state = {k: v.fill_(0.5) if k.endswith("skipinit_gain") else v
             for k, v in model.state_dict().items()}
    return model, {k: v.clone() for k, v in state.items()}


def _inputs():
    rs = np.random.RandomState(5)
    loader = pipeline.Loader(datasets.SyntheticVLEval(
        N_TEST, transforms.make_test_transform(SIZE), SIZE, seed=2), 3)
    return (rs.randn(N_SYN, SIZE, SIZE, 3).astype(np.float32),
            rs.randn(N_SYN, 768).astype(np.float32), loader,
            rs.randn(5 * N_TEST, 768).astype(np.float32))


def _block(parallel: bool):
    """One eval block of 2 students from fresh models -> (accuracies,
    metrics, trained state dicts, score matrices)."""
    images, texts, loader, bert = _inputs()
    cfg = Config(**EVAL)
    inits = [_student(s)[1] for s in (0, 1)]
    if parallel:
        reuse = {}
        accs, vals = teval.evaluate_synset_parallel(
            2, _student(9)[0], inits, images, texts, loader, cfg, bert,
            reuse=reuse)
        models = [reuse["trainer"].model_for(j) for j in range(2)]
    else:
        accs, vals, models = [], [], []
        for j in range(2):
            model, acc, val = teval.evaluate_synset(
                j, _student(9)[0], inits[j], images, texts, loader, cfg,
                bert)
            accs.append(acc)
            vals.append(val)
            models.append(model)
    states = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in models]
    scores = [teval.score_matrix(loader, m, bert) for m in models]
    return accs, vals, states, scores


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
def test_eval_block_twice_is_bit_identical(parallel):
    a, b = _block(parallel), _block(parallel)
    assert a[0] == b[0] and a[1] == b[1]
    for sa, sb in zip(a[2], b[2]):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for sa, sb in zip(a[3], b[3]):
        assert torch.equal(sa, sb)
    # the students did train: their weights left the init
    init = _student(0)[1]
    assert any(not torch.equal(a[2][0][k], init[k]) for k in init)


@pytest.mark.parametrize("dtype,before", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", False)])
def test_trainer_backward_holds_cudnn_deterministic(dtype, before,
                                                    monkeypatch):
    """The flag is on while the step's gradients are computed (seen from a
    gradient hook on the stem's first conv) and back at its value after."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", before)
    model, state = _student(0)
    trainer = expert.BiEncoderTrainer(model, state, lr_img=0.05,
                                      lr_txt=0.05, momentum=0.9,
                                      compute_dtype=dtype, seed=3)
    seen = []
    stem = next(p for n, p in model.image_encoder.named_parameters()
                if "stem" in n and n.endswith("weight"))
    stem.register_hook(
        lambda g: seen.append(torch.backends.cudnn.deterministic))
    images, texts, _, _ = _inputs()
    for _ in range(2):
        loss, _ = trainer.train_batch(images[:4], texts[:4])
        assert torch.backends.cudnn.deterministic is before
    assert seen == [True, True] and bool(torch.isfinite(loss))


def test_deterministic_cudnn_restores_after_an_error():
    old = torch.backends.cudnn.deterministic
    with pytest.raises(ZeroDivisionError):
        with expert.deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
            1 / 0
    assert torch.backends.cudnn.deterministic is old


def test_distill_losses_unmoved_by_eval_blocks(tmp_path, monkeypatch):
    """The distill CLI at toy size, an eval block of 2 students before
    each of its steps or none: the same grand losses, bit for bit, and
    every outer step runs with cuDNN's setting as the caller left it."""
    flags, step = [], Distiller.step_traj

    def recording(self, *a, **kw):
        flags.append(torch.backends.cudnn.deterministic)
        return step(self, *a, **kw)

    monkeypatch.setattr(Distiller, "step_traj", recording)
    losses = {}
    for num_eval in (0, 2):
        work = tmp_path / f"eval{num_eval}"
        work.mkdir()
        monkeypatch.chdir(work)
        cfg = _cfg(work, Iteration=3, eval_it=1, num_eval=num_eval,
                   parallel_eval=True, draw=False)
        _, history = pcli.main(cfg)
        losses[num_eval] = _losses(cfg)
        assert len(history) == (4 if num_eval else 0)
    assert sorted(losses[0]) == [0, 1, 2, 3]
    assert losses[0] == losses[2]
    assert flags and not any(flags)


def _buffers(root, n_files: int, snapshots: int = 4):
    """``n_files`` one-expert buffer files of NF_TINY trajectories."""
    model = init_bi_encoder(VLBiEncoder("nf_tiny", 768, 128), 0)
    towers = (model.image_encoder, model.text_projection)
    rs = np.random.RandomState(1)
    for _ in range(n_files):
        trajs = [[[p.detach().numpy() + np.float32(0.01 * k) * np.asarray(
            rs.randn(*p.shape), np.float32) for p in t.parameters()]
            for k in range(snapshots)] for t in towers]
        buffer_io.save_expert(str(root), *trajs, *towers)
    return towers, buffer_io.discover_buffers(str(root))


@pytest.mark.parametrize("n_files", [2, 3])
def test_cycler_load_all_walks_the_same(tmp_path, n_files):
    (img_t, txt_t), (img_files, txt_files) = _buffers(tmp_path, n_files)
    kw = dict(max_start_epoch=3, expert_epochs=1, seed=7,
              img_template=img_t, txt_template=txt_t, device="cpu",
              device_cache_cap=4)
    lazy = ExpertCycler(img_files, txt_files, load_all=False, **kw)
    resident = ExpertCycler(img_files, txt_files, load_all=True, **kw)
    orders = set()
    try:
        for _ in range(4 * n_files + 1):   # four passes over the files
            a, b = lazy.next_segment_device(), resident.next_segment_device()
            assert lazy._last_key == resident._last_key
            assert a[2] == b[2]
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            assert lazy.img_files == resident.img_files
            orders.add(tuple(lazy.img_files))
            ha, hb = lazy.next_segment(), resident.next_segment()
            assert ha[4] == hb[4]
            for x, y in zip(ha[:4], hb[:4]):
                assert np.array_equal(x, y)
    finally:
        lazy.close()
        resident.close()
    assert len(orders) > 1   # the walk went through reshuffles


def test_the_eval_repro_tool_runs_at_its_toy_shape(tmp_path):
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_eval_repro.py"
    spec = importlib.util.spec_from_file_location("torch_eval_repro", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "repro.jsonl"
    assert tool.main(["--shape", "toy", "--reps", "2", "--out",
                      str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["block"]["bit_identical"] and got["block"]["metrics_equal"]
    assert got["grads"]["params"] > 0 and got["grads"]["differ"] == []
    assert got["grads"]["forward_equal"] and got["scores"]["equal"]
