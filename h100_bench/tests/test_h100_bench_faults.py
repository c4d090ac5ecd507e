"""A run with its timed path broken underneath comes out not correct.

The look for a card is skipped and the rest of a run is driven on the
toy cells (CPU), with each fault a training cell can have on one chip
planted in the program: a step that returns its state unchanged, and a
batch of which half is left out (the mean taken over the rest)."""

import pytest

import bench_toy

D = "multimodal_dataset_distillation_tpu_torch.engine.distill.Distiller"
T = "multimodal_dataset_distillation_tpu_torch.engine.expert.BiEncoderTrainer"


def unchanged_distill(monkeypatch):
    from multimodal_dataset_distillation_tpu_torch.engine.distill import Distiller

    orig = Distiller._outer_update

    def broken(self, *a):
        st = self.state
        out = orig(self, *a)
        self.state = st
        return out

    monkeypatch.setattr(Distiller, "_outer_update", broken)


def half_distill(monkeypatch):
    from multimodal_dataset_distillation_tpu_torch.engine.distill import Distiller

    orig = Distiller.sample_indices
    monkeypatch.setattr(Distiller, "sample_indices",
                        lambda self, rng: orig(self, rng)[:, :self.cfg.mini_batch_size // 2])


def unchanged_expert(monkeypatch):
    from multimodal_dataset_distillation_tpu_torch.engine.expert import (
        BiEncoderTrainer)

    monkeypatch.setattr(BiEncoderTrainer, "_step",
                        lambda self, out: (out[0].detach(), out[1]))


def half_expert(monkeypatch):
    from multimodal_dataset_distillation_tpu_torch.engine.expert import (
        BiEncoderTrainer)

    orig = BiEncoderTrainer.train_batch
    monkeypatch.setattr(BiEncoderTrainer, "train_batch",
                        lambda self, x, y: orig(self, x[: len(x) // 2], y[: len(y) // 2]))


@pytest.mark.parametrize("cell,fault", [
    ("toy.distill", unchanged_distill), ("toy.distill", half_distill),
    ("toy.expert", unchanged_expert), ("toy.expert", half_expert)],
    ids=["distill-unchanged", "distill-half", "expert-unchanged", "expert-half"])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = bench_toy.make(tmp_path)
    assert bench_toy.run_toy(root, cell, seed=11)["correct"]
    fault(monkeypatch)
    out = bench_toy.run_toy(root, cell, seed=11)
    assert out["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in out["checks"].values())
