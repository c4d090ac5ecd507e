"""The data-parallel layer's pieces: the collectives' second derivatives
in float64, the mesh helpers and the Loader's rank feeding.

``gather_rows`` and ``copy_to_ranks`` are ``autograd.Function`` pairs
whose backward and ``jvp`` are built from ``.apply`` of each other; as for
every new op on the distill path (ROADMAP C2), grad-of-jvp (``fr_bwd=
"rof"``) and jvp-of-grad (``"for"``) through them are held against
reverse-over-reverse at 1e-12 in float64, on two ``gloo`` ranks
(``tests/torch_dp_worker.py``), and the ranks' results against one rank's.
"""

import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu_torch.data.pipeline import Loader
from multimodal_dataset_distillation_tpu_torch.parallel import mesh as pm
from test_torch_threads import share_cores  # noqa: F401 (autouse)
from torch_dp_worker import spawn


def test_forward_ad_forms_through_gather_rows_match_reverse_over_reverse(
        tmp_path):
    (one,) = spawn(tmp_path / "w1", dict(scenario="gather_f64"), 1)
    two = spawn(tmp_path / "w2", dict(scenario="gather_f64"), 2)
    for res in [one] + two:
        for form in ("rof", "fo"):
            for a, b in zip(res[form], res["rr"]):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for r, res in enumerate(two):
        np.testing.assert_allclose(res["value"], one["value"], rtol=1e-12)
        # the weight's second derivative is whole on every rank; the
        # inputs' is the rank's rows of the one-rank one
        np.testing.assert_allclose(res["rr"][0], one["rr"][0], rtol=1e-12,
                                   atol=1e-12)
        n = len(res["rr"][1])
        np.testing.assert_allclose(res["rr"][1],
                                   one["rr"][1][r * n:(r + 1) * n],
                                   rtol=1e-12, atol=1e-12)


def test_mesh_helpers():
    mesh = pm.Mesh(world=4, rank=3, local_rank=1, local_world=2)
    assert (mesh.nodes, mesh.node, mesh.data) == (2, 1, 4)
    assert mesh.rows(8) == (6, 8)
    with pytest.raises(ValueError):
        mesh.rows(6)
    assert pm.expert_assignment(5, mesh) == [1, 3]
    assert pm.expert_assignment(5) == [0, 1, 2, 3, 4]
    assert pm.process_shard(10, mesh) == (5, 10)
    assert pm.pad_to_multiple(100, 3) == 102
    assert pm.data_axis_size(mesh) == 4


def test_backend_choice(monkeypatch):
    monkeypatch.delenv(pm.BACKEND_ENV, raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pm.resolve_backend(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError):
        pm.resolve_backend(torch.device("cpu"), "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pm.resolve_backend(torch.device("cuda")) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        pm.resolve_backend(torch.device("cuda"))
    monkeypatch.setenv(pm.BACKEND_ENV, "gloo")
    assert pm.resolve_backend(torch.device("cuda")) == "gloo"


def test_row_shard_draws_are_the_whole_batch_draws():
    g = torch.Generator().manual_seed(3)
    whole = torch.rand((6, 4), generator=g)
    for rank in range(3):
        g.manual_seed(3)
        shard = pm.RowShard(g, 2 * rank, 6)
        np.testing.assert_array_equal(
            pm.rows_of(torch.rand, (2, 4), shard, "cpu"),
            whole[2 * rank:2 * rank + 2])
    g.manual_seed(3)   # slots past the whole batch (pad) draw the fill
    tail = pm.rows_of(torch.rand, (3, 4), pm.RowShard(g, 4, 6), "cpu")
    np.testing.assert_array_equal(tail[:2], whole[4:])
    assert not tail[2].any()


class _Items:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), f"c{i}"


def test_loader_shard_and_rows():
    """``shard``: the JAX Loader's equal shards of one permutation;
    ``rows``: each rank's part of the one-process batches."""
    whole = [b[0][:, 0] for b in Loader(_Items(), 6, shuffle=True,
                                        drop_last=True, seed=4,
                                        num_workers=1)]
    parts = [[b[0][:, 0] for b in Loader(_Items(), 6, shuffle=True,
                                         drop_last=True, seed=4,
                                         num_workers=1, rows=(r, 3))]
             for r in range(3)]
    for k, batch in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), batch)
    shards = [Loader(_Items(), 3, shuffle=True, drop_last=True, seed=4,
                     num_workers=1, shard=(r, 2)) for r in range(2)]
    assert [len(s) for s in shards] == [3, 3]   # 23 // 2 = 11 items each
    seen = np.concatenate([b[0][:, 0] for s in shards for b in s])
    assert len(set(seen.tolist())) == len(seen) == 18
    perm = np.arange(23)   # the first epoch's permutation, seed 4 + 1
    np.random.RandomState(4 + 1).shuffle(perm)
    np.testing.assert_array_equal(seen[9:], perm[11:20])
    with pytest.raises(ValueError):
        Loader(_Items(), 6, drop_last=True, rows=(0, 4))


def test_eval_cli_stays_on_one_rank(monkeypatch):
    """The JAX eval CLI builds no mesh: launched on more than one rank,
    the port's raises before reading anything."""
    from multimodal_dataset_distillation_tpu_torch.cli import eval_distilled
    from multimodal_dataset_distillation_tpu_torch.config import Config

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="runs on one card"):
        eval_distilled.main(Config(device="cpu", distilled_npz="x.npz"),
                            argv=[])
