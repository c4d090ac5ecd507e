"""The expert phase's two in-step variants against the JAX package, on the
CPU: ``--text_trainable`` (BERT in the step) and ``--device_augment``
(RandAugment and the CLIP normalisation in the step).

``--text_trainable``: ``TrainableTextTrainer`` steps against the JAX
trainer's, and the CLI's written buffers (the BERT tower's trajectory, in
JAX ravel order in the ``.npz`` and as the JAX tree's leaves in the
``.pt``, as the JAX ``save_expert`` writes a tree it has no reference order
for) against the JAX CLI's.  NF_TINY at 32^2 and the tiny BERT, the JAX
inits carried across (``models/convert.params_from_jax``, BERT included),
projection dropout off on both sides (torch's generators cannot draw
JAX's masks; BERT has none).  Tolerances, float32: trainer parameters 2e-4
relative (as tests/test_torch_expert.py); CLI snapshots 1e-3 in relative
error norm per tower (tests/test_torch_buffer_cli.py).

``--device_augment``: the port's trainer equals its own composition (the
plan drawn from the trainer's generator before any dropout draw, the
augment, the normalisation, then the step), and the JAX trainer's step
equals the port's plain step on the JAX step's own augmented images
normalised the same way; the augment itself is held against JAX in
tests/test_torch_randaugment_device.py.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.cli import buffer as jcli
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.data.transforms import (
    CLIP_MEAN as JMEAN,
    CLIP_STD as JSTD,
)
from multimodal_dataset_distillation_tpu.engine import expert as jexpert
from multimodal_dataset_distillation_tpu.models import clip_model as jclip
from multimodal_dataset_distillation_tpu.models import projection as jproj
from multimodal_dataset_distillation_tpu.ops import randaugment_device as jra
from multimodal_dataset_distillation_tpu_torch.cli import buffer as pcli
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine import buffer_io, expert
from multimodal_dataset_distillation_tpu_torch.models.bert import BERT_TINY
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    VLBiEncoderTrainableText,
    build_trainable_text,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_to_jax,
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.ops import (
    randaugment_device as pra,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE, B, PAD = 32, 4, 64
HYPER = dict(lr_img=0.05, lr_txt=0.05, momentum=0.9, weight_decay=5e-4)
TOWERS = ("image_encoder", "text_encoder", "text_projection")
KW = dict(dataset="synthetic", synthetic_size=8, synthetic_test_size=4,
          image_encoder="nf_tiny", image_size=SIZE, text_encoder_config="tiny",
          text_pretrained=False, image_pretrained=False, num_experts=2,
          train_epochs=2, batch_size_train=B, batch_size_test=B, k_test=4,
          lr_teacher_img=0.05, lr_teacher_txt=0.05, mom=0.5, l2=5e-4,
          num_workers=2, seed=0, disable_wandb=True, name="run",
          pallas_gconv=True, text_trainable=True)


class _NoDropProjection(jproj.ProjectionHead):
    dropout: float = 0.0


@pytest.fixture
def no_jax_dropout(monkeypatch):
    """The JAX text-trainable bi-encoder builds its projection with the
    default dropout; off here, the parameters unchanged."""
    monkeypatch.setattr(jclip, "ProjectionHead", _NoDropProjection)


def _jax_text_tree(seed):
    """The JAX CLI's init of a text-trainable expert (cli/buffer.py:356-360)."""
    model = jclip.VLBiEncoderTrainableText(image_encoder_name="nf_tiny",
                                           image_embedding=128,
                                           bert_variant="tiny")
    rng = jax.random.PRNGKey(seed)
    ids = jnp.zeros((2, PAD), jnp.int32)
    v = model.init({"params": rng, "dropout": rng},
                   jnp.zeros((2, SIZE, SIZE, 3), jnp.float32), ids,
                   jnp.ones_like(ids))
    return model, jax.tree_util.tree_map(np.asarray, v["params"])


def _port_state(model, tree, towers=TOWERS):
    return {f"{t}.{k}": v for t in towers
            for k, v in params_from_jax(tree[t], getattr(model, t)).items()}


def _port_text_model():
    model = VLBiEncoderTrainableText("nf_tiny", 128, BERT_TINY, gconv=True)
    model.text_projection.rate = 0.0
    return model


def test_trainable_text_steps_match_jax(no_jax_dropout):
    jmodel, tree = _jax_text_tree(3)
    jt = jexpert.TrainableTextTrainer(jmodel, {"params": tree}, seed=0,
                                      **HYPER)
    model = _port_text_model()
    model.load_state_dict(_port_state(model, tree))
    pt = expert.TrainableTextTrainer(model, None, seed=0, **HYPER)
    rs = np.random.RandomState(0)
    for _ in range(3):
        images = rs.randn(B, SIZE, SIZE, 3).astype(np.float32)
        ids = rs.randint(3, 4096, (B, PAD)).astype(np.int32)
        mask = (np.arange(PAD)[None] < rs.randint(4, PAD, (B, 1))).astype(
            np.int32)
        jl, ja = jt.train_batch(images, ids, mask)
        pl, pa = pt.train_batch(images, ids, mask)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        assert float(pa) == float(ja)
    want = _port_state(model, jax.tree_util.tree_map(
        np.asarray, jt.variables["params"]))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)
    # the projection stayed at its init, BERT moved, and is the snapshot
    for k, v in model.text_projection.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), _port_state(model, tree)[f"text_projection.{k}"])
    snap = pt.snapshot_text_params()
    assert [s.shape for s in snap] == [
        tuple(p.shape) for p in model.text_encoder.parameters()]


@pytest.fixture(scope="module")
def text_runs(tmp_path_factory):
    """Both CLIs with --text_trainable, 2 experts x 2 epochs; the port from
    the JAX inits and the JAX CLI's caption caches."""
    root = tmp_path_factory.mktemp("buffer_text")
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(jclip, "ProjectionHead", _NoDropProjection)

        def port_init(model, cfg, seed):
            return _port_state(model, _jax_text_tree(seed)[1])

        def build(cfg, device=None):
            model = build_trainable_text(cfg, device)
            model.text_projection.rate = 0.0
            return model

        mp.setattr(pcli, "init_expert", port_init)
        mp.setattr(pcli, "build_trainable_text", build)
        for side in ("jax", "port"):
            (root / side).mkdir()
            mp.chdir(root / side)
            if side == "jax":
                saved = jcli.main(JConfig(**KW, buffer_path="buffers",
                                          save_dir="logs", mesh_shape=(1,)))
            else:
                for f in ("synthetic_bert_text_embed.npz",
                          "synthetic_bert_train_text_embed.npz"):
                    shutil.copy(root / "jax" / f, f)
                saved = pcli.main(Config(**KW, buffer_path="buffers",
                                         save_dir="logs", device="cpu"))
            out[side] = (saved, root / side / "buffers" / "synthetic" /
                         "nf_tiny" / "bert")
    finally:
        mp.undo()
    return out


def test_text_trainable_buffers_match_jax_cli(text_runs):
    (ps, pdir), (js, jdir) = text_runs["port"], text_runs["jax"]
    assert ps == js == [0, 1]
    model = build_trainable_text(Config(**KW, device="cpu"))
    for i in range(2):
        for kind, tower in (("img", model.image_encoder),
                            ("txt", model.text_encoder)):
            stem = f"{kind}_replay_buffer_{i}"
            a = buffer_io.load_trajectory_npz(str(pdir / f"{stem}.npz"))
            b = buffer_io.load_trajectory_npz(str(jdir / f"{stem}.npz"))
            assert a.shape == b.shape == (
                3, sum(p.numel() for p in tower.parameters()))
            for e in range(3):
                rel = np.linalg.norm(a[e] - b[e]) / np.linalg.norm(b[e])
                assert rel <= 1e-3, (i, kind, e, rel)
            assert np.linalg.norm(b[-1] - b[0]) > 0
            # the port's load_buffer reads its .pt and .npz alike (the .pt of
            # BERT in the JAX tree's order), in the module's order
            (npz,) = buffer_io.load_buffer(str(pdir / f"{stem}.npz"), tower)
            (pt,) = buffer_io.load_buffer(str(pdir / f"{stem}.pt"), tower)
            np.testing.assert_array_equal(npz, pt)
            np.testing.assert_array_equal(flat_to_jax(pt, tower), a)
        # the BERT .pt holds what the JAX save_expert writes for the tree
        got, want = (torch.load(str(d / f"txt_replay_buffer_{i}.pt"),
                                weights_only=False) for d in (pdir, jdir))
        assert len(got) == len(want) == 1 and len(got[0]) == len(want[0])
        for sa, sb in zip(got[0], want[0]):
            assert [t.shape for t in sa] == [t.shape for t in sb]
            fa, fb = (torch.cat([t.reshape(-1).float() for t in s])
                      for s in (sa, sb))
            assert float((fa - fb).norm() / fb.norm()) <= 1e-3


def test_text_trainable_starts_from_the_frozen_tower(tmp_path, monkeypatch):
    """With ``text_pretrained`` the in-step BERT starts from the frozen
    encoder's weights (the caption caches' tower), as in the JAX CLI."""
    from multimodal_dataset_distillation_tpu_torch.data.textcache import (
        make_text_encoder,
    )

    monkeypatch.chdir(tmp_path)
    cfg = Config(**{**KW, "num_experts": 1, "train_epochs": 1,
                    "text_pretrained": True, "buffer_path": "buffers",
                    "save_dir": "logs", "device": "cpu"})
    assert pcli.main(cfg) == [0]
    frozen = make_text_encoder(cfg).module
    (traj,) = buffer_io.load_buffer(
        "buffers/synthetic/nf_tiny/bert/txt_replay_buffer_0.npz", frozen)
    want = torch.cat([p.reshape(-1) for p in frozen.parameters()]).numpy()
    np.testing.assert_array_equal(traj[0], want)
    assert not np.array_equal(traj[1], want)


def _plain_model(proj_dropout=0.0):
    return VLBiEncoder("nf_tiny", 768, 128, proj_dropout=proj_dropout,
                       gconv=True)


def test_device_augment_is_plan_then_normalise_then_step():
    """The trainer's augmenting step is the plain step on the images the
    trainer's generator augments, with dropout drawn after the plan."""
    base = init_bi_encoder(_plain_model(proj_dropout=0.1), 0)
    init = {k: v.clone() for k, v in base.state_dict().items()}
    rs = np.random.RandomState(1)
    batches = [(rs.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32),
                rs.randn(B, 768).astype(np.float32)) for _ in range(2)]
    aug = expert.BiEncoderTrainer(base, init, seed=5, device_augment=True,
                                  **HYPER)
    for images, texts in batches:
        assert torch.isfinite(aug.train_batch(images, texts)[0])
    ref_model = _plain_model(proj_dropout=0.1)
    ref = expert.BiEncoderTrainer(ref_model, init, seed=5, **HYPER)
    mean, std = (torch.as_tensor(v) for v in (JMEAN, JSTD))
    for images, texts in batches:
        x = pra.random_augment(torch.from_numpy(images), ref.generator)
        ref.train_batch((x / 255.0 - mean) / std, texts)
    for (k, a), b in zip(base.state_dict().items(),
                         ref_model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert not torch.equal(base.state_dict()["text_projection.fc.weight"],
                           init["text_projection.fc.weight"])


def test_device_augment_step_matches_jax():
    """One JAX augmenting step (its key chain: split per batch, then the
    augment key split off inside the step) against the port's plain step on
    the same augmented images, normalised as the port normalises."""
    jmodel = jclip.VLBiEncoder(image_encoder_name="nf_tiny",
                               text_embedding=768, image_embedding=128,
                               proj_dropout=0.0)
    variables = jexpert.init_bi_encoder(
        jmodel, JConfig(image_encoder="nf_tiny", image_size=SIZE),
        jax.random.PRNGKey(2))
    jt = jexpert.BiEncoderTrainer(jmodel, variables, seed=7,
                                  device_augment=True, **HYPER)
    model = _plain_model()
    model.load_state_dict(_port_state(model, variables["params"],
                                      ("image_encoder", "text_projection")))
    pt = expert.BiEncoderTrainer(model, None, seed=0, **HYPER)
    rs = np.random.RandomState(2)
    key = jax.random.PRNGKey(7)
    mean, std = (torch.as_tensor(v) for v in (JMEAN, JSTD))
    for _ in range(2):
        images = rs.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
        texts = rs.randn(B, 768).astype(np.float32)
        key, sub = jax.random.split(key)
        augmented = np.array(jra.random_augment_device(
            images, jax.random.split(sub)[1]))
        jl, _ = jt.train_batch(images, texts)
        pl, _ = pt.train_batch((torch.from_numpy(augmented) / 255.0 - mean)
                               / std, texts)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want = _port_state(model, jax.tree_util.tree_map(
        np.asarray, jt.variables["params"]), ("image_encoder",
                                              "text_projection"))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_create_dataset_feeds_raw_crops_under_device_augment():
    """``--device_augment`` in the CLI's data: the train split yields raw
    [0, 255] crops (not normalised), the test split normalised images."""
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset

    train, test, _, _ = get_dataset(Config(**{**KW, "device_augment": True,
                                              "num_workers": 1,
                                              "device": "cpu"}))
    images = next(iter(train))[0]
    assert images.shape == (B, SIZE, SIZE, 3) and images.dtype == np.float32
    assert images.min() >= 0.0 and images.max() > 2.0
    assert np.array_equal(images, np.round(images))
    assert next(iter(test))[0].min() < 0.0


@pytest.mark.parametrize("lr", [0.05, -0.05])
def test_sgd_takes_a_negative_learned_lr_like_optax(lr):
    """A learned LR the outer loop drove below zero steps as the JAX chain
    steps it (torch's SGD refuses one at construction)."""
    rs = np.random.RandomState(3)
    p0 = rs.randn(6, 4).astype(np.float32)
    grads = [rs.randn(6, 4).astype(np.float32) for _ in range(3)]
    tx = jexpert.torch_sgd(lr, 0.5, 1e-2)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = expert.torch_sgd([tp], lr, 0.5, 1e-2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = jp + upd
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)
