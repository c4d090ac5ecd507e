"""The plain reference against the program at toy widths on the CPU, and
its blocked meta-gradient against a plain ``create_graph`` unroll."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench_toy
from bench_toy import BENCH
from h100_bench import harness
from h100_bench.reference import nf, train, walk

P = "multimodal_dataset_distillation_tpu_torch"
REG_TOY = {**bench_toy.TOY_TOWER, "depths": [1, 2], "channels": [16, 32],
           "stem_type": "3x3", "stem_chs": 16, "group_size": 8,
           "bottle_ratio": 2.25, "extra_conv": False, "num_features": 64,
           "attn_rd_ratio": 0.5, "skipinit": False, "num_classes": 24,
           "reg": True, "width_factor": 0.75}
L0_TOY = {**bench_toy.TOY_TOWER, "drop_path_rate": 0.2}


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["nfnet_l0", "nf_regnet_b1"])
def test_param_tables_are_the_programs(name):
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)

    cfg = config(name)
    m = build_bi_encoder(Config(image_encoder=cfg["port_encoder"], device="cpu"),
                         device="cpu")
    harness.check_layout(m.image_encoder, nf.param_table(cfg["tower"]), "tower")
    harness.check_layout(m.text_projection, nf.text_param_table(
        768, nf.feature_width(cfg["tower"])), "text")


def port_net(table):
    from multimodal_dataset_distillation_tpu_torch.models import nfnet

    fields = {f.name for f in dataclasses.fields(nfnet.NfConfig)}
    return nfnet.NormFreeNet(nfnet.NfConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in table.items() if k in fields}))


@pytest.mark.parametrize("tower", [L0_TOY, REG_TOY], ids=["l0_like", "regnet_like"])
def test_tower_forward_matches_the_program(tower):
    net = port_net(tower)
    table = nf.param_table(tower, prefix="")
    harness.check_layout(net, table, "tower")
    flat = harness.init_flat(table, torch.Generator().manual_seed(0), "cpu",
                             {"skipinit_gain": [0.2, 0.05]})
    harness.load_flat(net, flat)
    x = torch.randn(6, 40, 40, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = net(x.permute(0, 3, 1, 2), True, torch.Generator().manual_seed(5))
        masks = train.tower_masks(tower, 6, torch.Generator().manual_seed(5), "cpu")
        want = nf.tower_forward(tower, nf.unflatten(flat, table), x, masks,
                                prefix="")
    assert nf.drop_layers(tower) == list(masks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_text_head_and_loss_match_the_program():
    from multimodal_dataset_distillation_tpu_torch.models.projection import (
        ProjectionHead)
    from multimodal_dataset_distillation_tpu_torch.ops.contrastive import info_nce

    head = ProjectionHead(12, 20, dropout=0.1)
    table = nf.text_param_table(12, 20)
    flat = harness.init_flat(table, torch.Generator().manual_seed(2), "cpu",
                             {"skipinit_gain": [0.2, 0.05]})
    harness.load_flat(head, flat)
    y = torch.randn(5, 12)
    with torch.no_grad():
        got = head(y, True, torch.Generator().manual_seed(3))
        mask = train.text_mask(5, 20, 0.1, torch.Generator().manual_seed(3), "cpu")
        want = nf.text_forward(nf.unflatten(flat, table), y, mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        f = torch.randn(5, 20)
        torch.testing.assert_close(nf.contrastive(f, want, nf.FIXED_LOGIT_SCALE),
                                   info_nce(f, want), rtol=1e-6, atol=1e-6)


def plain_outer_grads(m, st, seg, idx, seeds, hp):
    """The meta-gradients by one create_graph unroll over the whole batch."""
    leaves = [t.detach().clone().requires_grad_() for t in st.leaves()]
    x_all, y_all, lr_i, lr_t = leaves
    thi, tht = seg[0], seg[1]
    for s in range(len(idx)):
        gi_ = torch.Generator().manual_seed(seeds[s][0])
        gt_ = torch.Generator().manual_seed(seeds[s][1])
        n = len(idx[s])
        mi = train.tower_masks(m.tower, n, gi_, "cpu")
        mt = train.text_mask(n, hp["text_width"], hp["text_dropout"], gt_, "cpu")
        if not thi.requires_grad:
            thi, tht = thi.requires_grad_(), tht.requires_grad_()
        loss = nf.contrastive(m.image(thi, x_all[idx[s]], mi),
                              m.text(tht, y_all[idx[s]], mt), nf.RAW_LOG_SCALE)
        gi, gt = torch.autograd.grad(loss, (thi, tht), create_graph=True)
        thi, tht = thi - lr_i * gi, tht - lr_t * gt
    loss = (((thi - seg[2]) ** 2).sum() / ((seg[0] - seg[2]) ** 2).sum()
            + ((tht - seg[3]) ** 2).sum() / ((seg[1] - seg[3]) ** 2).sum())
    return loss, torch.autograd.grad(loss, leaves)


def test_blocked_meta_gradient_is_the_unroll():
    torch.manual_seed(0)
    t = {**bench_toy.TOY_TOWER, "drop_path_rate": 0.3}
    it, tt = nf.param_table(t), nf.text_param_table(10, nf.feature_width(t))
    m = train.Model(t, it, tt, rows=2)
    g = torch.Generator().manual_seed(4)
    init = {"skipinit_gain": [0.2, 0.05]}
    th0 = [harness.init_flat(tb, g, "cpu", init).double() for tb in (it, tt)]
    seg = th0 + [v + 1e-3 * torch.randn(v.shape, dtype=v.dtype) for v in th0]
    n = 5
    st = train.SynState(torch.randn(n, 24, 24, 3, dtype=torch.float64),
                        torch.randn(n, 10, dtype=torch.float64),
                        torch.tensor(0.1, dtype=torch.float64),
                        torch.tensor(0.1, dtype=torch.float64),
                        [torch.zeros(())] * 4)
    st.mom = [torch.zeros_like(v) for v in st.leaves()]
    idx = torch.as_tensor(walk.minibatches(np.random.RandomState(3), n, 4, 2))
    seeds = walk.DropoutSeeds(9).draw(2)
    hp = {"lr_img": 1.0, "lr_txt": 1.0, "lr_lr": 0.1, "text_width": 128,
          "text_dropout": 0.1}
    hp["text_width"] = nf.feature_width(t)
    _, loss, grads = train.distill_step(m, st, seg, idx, seeds, hp, "cpu")
    want_loss, want = plain_outer_grads(m, st, seg, idx, seeds, hp)
    assert abs(float(loss) - float(want_loss)) < 1e-12
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_walk_is_the_programs_cycler(tmp_path):
    from multimodal_dataset_distillation_tpu_torch.engine.distill import ExpertCycler
    from torch import nn

    tmpl = nn.Linear(2, 1)
    files = ([], [])
    for f in range(3):
        for kind, out in zip(("img", "txt"), files):
            path = str(tmp_path / f"{kind}_{f}.pt")
            torch.save([[[torch.full((1, 2), float(f)), torch.full((1,), float(e))]
                         for e in range(5)]] * 2, path)
            out.append(path)
    cyc = ExpertCycler(*files, 3, 1, tmpl, tmpl, seed=2147483647, load_all=True,
                       device="cpu")
    segs = walk.segments(3, 2, 5, 3, 1, 2147483647)
    for _ in range(20):
        img, _, start = cyc.next_segment_device()
        f, _, s = next(segs)
        assert (float(img[0, 0]), start) == (float(f), s)


def test_the_toy_cells_run_correct(tmp_path):
    root = bench_toy.make(tmp_path)
    for cell in ("toy.distill", "toy.expert"):
        out = bench_toy.run_toy(root, cell, seed=2 ** 31 + 5, trace=1)
        assert out["correct"], out["checks"]
        assert list(out)[-1] == "checks"
        assert out["attempted"] > 0 and out["failed"] == 0
        assert out["metrics"], out
