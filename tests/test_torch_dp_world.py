"""The port's data-parallel distill step, checkpoint and eval students at
2 and 3 ranks against the same at one rank (``tests/torch_dp_worker.py``:
``gloo`` ranks on the CPU, one torch thread each).

Dropout (the text projection's, 0.1) and DropPath (NF_TINY's blocks, set
to 0.1 here) are on: every rank draws the whole minibatch's masks and
keeps its rows, so the step at any world is the one-rank step up to the
order of float sums (1e-6 in float32, 1e-12 in float64), in ``fr_bwd``
``rof`` and ``for`` and the reverse-mode oracle, with ``--shard_syn`` on
and a minibatch (5) and a query count (7) that the worlds do not divide.
"""

import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)
from torch_dp_worker import spawn

NQ, MB, SIZE = 7, 5, 32
MODEL_KW = dict(image_encoder_name="nf_tiny", text_embedding=768,
                image_embedding=128, proj_dropout=0.1, gconv=True)
CFG = dict(image_encoder="nf_tiny", image_size=SIZE, num_queries=NQ,
           syn_steps=2, mini_batch_size=MB, expert_epochs=1, lr_img=10.0,
           lr_txt=10.0, lr_lr=1e-2, lr_teacher_img=0.05,
           lr_teacher_txt=0.05, seed=0, pallas_gconv=True,
           inner_scale="syn_lr", shard_syn=True)
MODES = [dict(fr_bwd="rof"), dict(fr_bwd="for"), dict(hvp_mode="reverse")]


def _job(np_dtype=np.float32, **kw):
    model = init_bi_encoder(VLBiEncoder(**MODEL_KW), 0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "skipinit" in name:
                p.fill_(0.5)
    rs = np.random.RandomState(0)
    data = (rs.randn(NQ, SIZE, SIZE, 3).astype(np_dtype),
            rs.randn(NQ, 768).astype(np_dtype))
    i0, t0 = (torch.cat([p.detach().reshape(-1) for p in t.parameters()])
              .numpy().astype(np_dtype)
              for t in (model.image_encoder, model.text_projection))
    seg = (i0, t0, (i0 + 0.01 * rs.randn(*i0.shape)).astype(np_dtype),
           (t0 + 0.01 * rs.randn(*t0.shape)).astype(np_dtype))
    idx = np.stack([rs.permutation(NQ)[:MB] for _ in range(2)])
    return dict(model_kw=MODEL_KW, state_dict=model.state_dict(),
                drop_path=0.1, data=data, seg=seg, idx=idx,
                cfg=dict(CFG), **kw)


def _close(a, b, rtol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=name)


def _same_step(one, many, rtol):
    for k in range(len(one)):
        a, b = one[k], many[k]
        _close(b["loss"], a["loss"], rtol, "loss")
        _close(b["losses"], a["losses"], rtol, "losses")
        for name in ("his", "hts"):
            _close(b[name], a[name], rtol, name)
        for g, h, name in zip(b["grads"], a["grads"],
                              ("pixels", "texts", "lr_img", "lr_txt")):
            _close(g, h, rtol, name)
        for s, t in zip(b["state"], a["state"]):
            _close(s, t, rtol, "state")


@pytest.fixture(scope="module")
def float32_runs(tmp_path_factory):
    job = _job(scenario="distill", seeds=[(1, 2), (3, 4)], modes=MODES,
               steps=2)
    return {w: spawn(tmp_path_factory.mktemp(f"w{w}"), job, w)
            for w in (1, 2, 3)}


@pytest.mark.parametrize("world", [2, 3])
def test_step_at_world_is_the_one_rank_step(float32_runs, world):
    _same_step(float32_runs[1][0], float32_runs[world][0], 1e-6)
    for r in float32_runs[world][1:]:   # bit for bit on every rank
        assert [m["loss_bits"] for m in r] == [
            m["loss_bits"] for m in float32_runs[world][0]]


def test_step_at_world_two_is_the_one_rank_step_in_float64(tmp_path):
    job = _job(np.float64, scenario="distill", seeds=[(1, 2), (3, 4)],
               modes=MODES[:2], steps=1, dtype="float64")
    job["cfg"]["inner_dtype"] = "float64"
    one, two = (spawn(tmp_path / f"w{w}", job, w)[0] for w in (1, 2))
    _same_step(one, two, 1e-12)


def test_checkpoint_at_world_two_resumes_at_one_and_three(tmp_path):
    """A checkpoint written at world 2 (pad rows stripped) resumes at world
    1 and 3 (re-padded) and goes on as the uninterrupted one-rank run."""
    rs = np.random.RandomState(9)
    idxs = [np.stack([rs.permutation(NQ)[:MB] for _ in range(2)])
            for _ in range(3)]
    ckpt = str(tmp_path / "ckpt" / "distill_ckpt_2.pt")
    base = _job(scenario="resume")
    (whole,) = spawn(tmp_path / "a", dict(base, before=idxs, after=[]), 1)
    spawn(tmp_path / "b", dict(base, before=idxs[:2], after=[], save=ckpt),
          2)
    for world in (1, 3):
        got = spawn(tmp_path / f"c{world}",
                    dict(base, load=ckpt, before=[], after=idxs[2:]), world)
        for r in got:
            for a, b in zip(r, whole):
                _close(a, b, 1e-6, f"world {world}")


def test_eval_students_split_over_two_ranks(tmp_path):
    """Two students per rank, each with its own seed streams, give the
    one-rank results per student; every rank gets all of them."""
    rs = np.random.RandomState(2)
    syn = (rs.randn(6, SIZE, SIZE, 3).astype(np.float32),
           rs.randn(6, 768).astype(np.float32))
    job = _job(scenario="eval_students", syn=syn)
    job["cfg"] = dict(CFG, dataset="synthetic", text_encoder_config="tiny",
                      synthetic_test_size=6, num_eval=4, batch_train=3,
                      batch_size_test=4, k_test=4, epoch_eval_train=1,
                      num_workers=1, lr_net=0.05)
    (one,) = spawn(tmp_path / "w1", job, 1)
    two = spawn(tmp_path / "w2", job, 2)
    for r in two:
        assert len(r["acc"]) == 4 and len(r["val"]) == 4
        _close(r["acc"], one["acc"], 1e-6, "accuracies")
        for a, b in zip(r["val"], one["val"]):
            assert a.keys() == b.keys()
            _close([a[k] for k in a], [b[k] for k in a], 1e-6, "metrics")
