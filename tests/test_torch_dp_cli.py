"""The buffer and distill CLIs across ``gloo`` ranks on the CPU
(``tests/torch_dp_worker.py``), against the same CLIs on one rank.

* One node, two ranks: each expert is data-parallel, every rank on its
  rows of the one-rank run's batches; the buffers equal the one-rank ones
  up to the order of float sums (NF_TINY with ``--device_augment`` and
  the projection's dropout; ResNet-18, whose BatchNorm moments are the
  global batch's).
* Two nodes of one rank: the experts fan out over the nodes, each written
  under its global index, as a sequential run writes them; with
  ``--distributed`` one expert runs over both, each rank on its shard of
  the epoch, as a one-rank run on the shards' batches side by side.
* The distill CLI on two ranks: the grand losses and the synthetic set of
  the one-rank run (eval students split over the ranks, a checkpoint).
"""

import numpy as np
import pytest

from test_torch_threads import share_cores  # noqa: F401 (autouse)
from torch_dp_worker import spawn

KW = dict(dataset="synthetic", synthetic_size=16, synthetic_test_size=4,
          image_size=32, text_encoder_config="tiny", text_pretrained=False,
          image_pretrained=False, num_experts=1, train_epochs=1,
          batch_size_train=8, batch_size_test=4, k_test=4,
          lr_teacher_img=0.05, lr_teacher_txt=0.05, mom=0.5, l2=5e-4,
          num_workers=1, seed=0, disable_wandb=True, name="run",
          buffer_path="buffers", device="cpu")


def _buffers(tmp_path, cfg, world, local_world=0):
    cwd = tmp_path / f"w{world}_{local_world}"
    cwd.mkdir()
    out = spawn(cwd, dict(scenario="expert", cfg=cfg, cwd=str(cwd)), world,
                local_world)
    return out


def _same_files(got, want, rtol):
    assert sorted(got) == sorted(want)
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k],
                                       rtol=rtol, atol=rtol, err_msg=name)


@pytest.mark.parametrize("extra", [
    dict(image_encoder="nf_tiny", pallas_gconv=True, device_augment=True,
         train_epochs=2),
    dict(image_encoder="resnet18")], ids=["nf_tiny_augment", "resnet18_bn"])
def test_expert_data_parallel_on_one_node_is_the_one_rank_run(tmp_path,
                                                               extra):
    cfg = dict(KW, **extra)
    (one,) = _buffers(tmp_path, cfg, 1)
    two = _buffers(tmp_path, cfg, 2)
    assert two[0]["saved"] == [0] and two[1]["saved"] == []
    _same_files(two[0]["files"], one["files"], 2e-5)


def test_expert_fan_out_over_nodes_writes_global_indices(tmp_path):
    cfg = dict(KW, image_encoder="nf_tiny", pallas_gconv=True, num_experts=3,
               synthetic_size=8, batch_size_train=4)
    (one,) = _buffers(tmp_path, cfg, 1)
    nodes = _buffers(tmp_path, cfg, 2, local_world=1)
    assert nodes[0]["saved"] == [0, 2] and nodes[1]["saved"] == [1]
    _same_files(nodes[0]["files"], one["files"], 1e-6)


def test_distill_cli_on_two_ranks_is_the_one_rank_run(tmp_path):
    cfg = dict(KW, image_encoder="nf_tiny", pallas_gconv=True,
               num_queries=7, mini_batch_size=5, syn_steps=2, Iteration=3,
               eval_it=3, num_eval=2, epoch_eval_train=1, batch_train=4,
               ckpt_it=2, save_dir="logs", draw=False, pix_init="noise",
               txt_init="noise", expert_epochs=1, max_start_epoch=1)
    runs = {}
    for world in (1, 2):
        cwd = tmp_path / f"w{world}"
        cwd.mkdir()
        runs[world] = spawn(cwd, dict(scenario="distill_cli", cfg=cfg,
                                      cwd=str(cwd)), world)
    one, two = runs[1][0], runs[2]
    assert len(one["losses"]) == 4
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-6)
    # the set moves by lr_img = 1000 times meta-gradients whose float sums
    # run in another order: 1e-4 on values of order 1
    for r in two:
        for a, b in zip(r["syn"], one["syn"]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    # the eval block's students: split over the ranks, reported by rank 0
    (it_one, res_one), (it_two, res_two) = one["history"][-1], \
        two[0]["history"][-1]
    assert it_one == it_two == 3 and len(res_two) == 2
    for a, b in zip(res_two, res_one):
        np.testing.assert_allclose([a[k] for k in b], [b[k] for k in b],
                                   rtol=1e-5, atol=1e-5)
    assert (tmp_path / "w2" / "logs" / "synthetic" / "run"
            / "distill_ckpt_2.pt").exists()


def test_parallel_experts_split_over_ranks(tmp_path):
    """``--parallel_experts=2`` on two ranks: one model per rank, each on
    the one-rank run's batch stream; rank 0 writes both buffers."""
    cfg = dict(KW, image_encoder="nf_tiny", pallas_gconv=True, num_experts=2,
               parallel_experts=2, synthetic_size=8, batch_size_train=4)
    (one,) = _buffers(tmp_path, cfg, 1)
    two = _buffers(tmp_path, cfg, 2)
    assert two[0]["saved"] == [0, 1] and two[1]["saved"] == []
    _same_files(two[0]["files"], one["files"], 1e-6)


def test_distributed_over_nodes_shards_the_epoch(tmp_path):
    """``--distributed`` on two nodes: one expert data-parallel over both
    ranks, each reading its shard of the epoch at half the batch; rank 0
    writes the buffers.  They equal a one-rank run whose batch k is batch
    k of each rank's shard in rank order, with the same seeds (the
    in-step augment and the dropout drawn for that whole batch)."""
    cfg = dict(KW, image_encoder="nf_tiny", pallas_gconv=True,
               distributed=True, device_augment=True, train_epochs=2)
    nodes = _buffers(tmp_path, cfg, 2, local_world=1)
    assert nodes[0]["saved"] == [0] and nodes[1]["saved"] == []
    cwd = tmp_path / "shards"
    cwd.mkdir()
    (one,) = spawn(cwd, dict(scenario="expert_shards", shards=2, cfg=cfg,
                             cwd=str(cwd)), 1)
    assert one["saved"] == [0]
    _same_files(nodes[0]["files"], one["files"], 2e-5)
    traj = one["files"]["img_replay_buffer_0.npz"]
    (flat,) = [v for v in traj.values() if v.ndim == 2]
    assert flat.shape[0] == 3 and not np.array_equal(flat[0], flat[-1])
