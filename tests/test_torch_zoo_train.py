"""Port parity: the expert and eval-student trainers over the zoo's towers
against the JAX trainers, BatchNorm's running averages included.

ResNet-18 (BatchNorm, at 64^2 so that its last stage still averages 2x2
pixels per image), ConvNet-tiny and ViT-Tiny/16 (32^2): the same weights
(the JAX tree with seeded values, carried across by ``models/convert.py``,
``batch_stats`` too) and the same batches go through
``BiEncoderTrainer`` and ``ParallelExpertTrainer`` in both packages;
dropout off on both sides (``proj_dropout=0``).  Then ``evaluate_synset``
with a ResNet-18 student: trained in train mode (running averages moved)
and scored on its running averages.

Tolerances as tests/test_torch_expert.py: float32 parameters and running
averages 2e-4 relative (with an absolute floor of 2e-6), losses 1e-5
relative and accuracies exactly; bfloat16 compute 1e-2 of each tower's
norm, its running averages kept in float32.

ResNet-18 is held for one SGD step: a second step on batch statistics of
4 images at 2x2 pixels is ill-conditioned, and the JAX package's jitted
float32 step (which agrees with the port's to 3e-6 on the first) then
departs from its own eager gradient by 70% of the largest entry, while
after two steps the port's float32 parameters are within 2e-6 of a
float64 run's (measured on the CPU at this size).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.data import datasets as jdatasets
from multimodal_dataset_distillation_tpu.data import pipeline as jpipeline
from multimodal_dataset_distillation_tpu.data import transforms as jtransforms
from multimodal_dataset_distillation_tpu.engine import eval as jeval
from multimodal_dataset_distillation_tpu.engine import expert as jexpert
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import datasets
from multimodal_dataset_distillation_tpu_torch.data import pipeline
from multimodal_dataset_distillation_tpu_torch.data import transforms
from multimodal_dataset_distillation_tpu_torch.engine import eval as teval
from multimodal_dataset_distillation_tpu_torch.engine import expert
from multimodal_dataset_distillation_tpu_torch.models import zoo
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    params_from_jax,
)

from test_torch_zoo import jax_variables
from test_torch_threads import share_cores  # noqa: F401 (autouse)

TXT, B = 64, 4
HYPER = dict(lr_img=0.05, lr_txt=0.05, momentum=0.9, weight_decay=5e-4)
SIZES = {"resnet18": 64, "convnet_tiny": 32, "vit": 32}


def jax_setup(name, seed=0):
    """(JAX bi-encoder, its variables from the seed: params and any
    batch_stats)."""
    model = JVLBiEncoder(image_encoder_name=name, text_embedding=TXT,
                         image_embedding=zoo.feature_dim(name),
                         proj_dropout=0.0)
    s = SIZES[name]
    return model, jax_variables(model, np.zeros((2, s, s, 3), np.float32),
                                np.zeros((2, TXT), np.float32), seed=seed)


def port_model(name):
    return VLBiEncoder(name, TXT, zoo.feature_dim(name), proj_dropout=0.0,
                       image_size=SIZES[name])


def port_state(name, variables):
    """JAX variables -> the port bi-encoder's state dict."""
    model, sd = port_model(name), {}
    stats = variables.get("batch_stats", {})
    for part in ("image_encoder", "text_projection"):
        for k, t in params_from_jax(
                variables["params"][part], getattr(model, part),
                stats.get(part) if part in stats else None).items():
            sd[f"{part}.{k}"] = t
    return sd


def batches(name, n=3, seed=0):
    rs = np.random.RandomState(seed)
    s = SIZES[name]
    return [(rs.randn(B, s, s, 3).astype(np.float32),
             rs.randn(B, TXT).astype(np.float32)) for _ in range(n)]


def assert_state(model, name, variables, rtol=2e-4, atol=2e-6, floor=0.0):
    """Every parameter and running average as JAX's; ``floor``: an absolute
    tolerance of that share of each tensor's largest value."""
    want = port_state(name, jax.tree_util.tree_map(np.asarray, variables))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            v.numpy(), w, rtol=rtol,
            atol=max(atol, floor * float(np.abs(w).max())), err_msg=k)


STEPS = {"resnet18": 1, "convnet_tiny": 3, "vit": 3}


@pytest.mark.parametrize("name", list(SIZES))
def test_bi_encoder_trainer_matches_jax(name):
    jmodel, v = jax_setup(name)
    jtr = jexpert.BiEncoderTrainer(jmodel, v, seed=0, **HYPER)
    tr = expert.BiEncoderTrainer(port_model(name), port_state(name, v),
                                 seed=0, **HYPER)
    for b in batches(name, STEPS[name]):
        jl, ja = jtr.train_batch(*b)
        loss, acc = tr.train_batch(*b)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert float(acc) == float(ja)
    assert_state(tr.model, name, jtr.variables)
    assert ("batch_stats" in v) == (name == "resnet18")


def test_bf16_trainer_keeps_float32_running_averages():
    """bfloat16 compute on ResNet-18: the running averages stay float32 and
    move as the JAX bf16 trainer moves them (1e-2 of their norm, as the
    towers' parameters)."""
    name = "resnet18"
    jmodel, v = jax_setup(name)
    jtr = jexpert.BiEncoderTrainer(jmodel, v, seed=0,
                                   compute_dtype="bfloat16", **HYPER)
    tr = expert.BiEncoderTrainer(port_model(name), port_state(name, v),
                                 seed=0, compute_dtype="bfloat16", **HYPER)
    for b in batches(name, 1):
        jtr.train_batch(*b)
        tr.train_batch(*b)
    want = port_state(name, jax.tree_util.tree_map(np.asarray,
                                                   jtr.variables))
    got = tr.model.state_dict()
    init = port_state(name, v)
    for kind in ("running", "image_encoder", "text_projection"):
        keys = [k for k in got if kind in k and ("running" in k) == (
            kind == "running")]
        assert all(got[k].dtype == torch.float32 for k in keys)
        a = torch.cat([got[k].reshape(-1) for k in keys])
        b = torch.cat([want[k].reshape(-1) for k in keys])
        moved = torch.cat([init[k].reshape(-1) for k in keys])
        assert not torch.equal(a, moved), kind
        assert float((a - b).norm() / b.norm()) <= 1e-2, kind


def test_parallel_trainer_matches_jax_with_k_sets_of_stats():
    """K=2 ResNet-18 experts in lockstep: each model's parameters and its
    own running averages as JAX's vmapped trainer leaves them, and bit for
    bit those of a sequential port trainer fed the same batches."""
    name = "resnet18"
    (jmodel, v0), (_, v1) = jax_setup(name, 0), jax_setup(name, 1)
    bs = batches(name, 1, seed=7)
    images = [np.stack([b[0], b[0][::-1]]) for b in bs]
    texts = [np.stack([b[1], b[1][::-1]]) for b in bs]
    inits = [port_state(name, v) for v in (v0, v1)]
    par = expert.ParallelExpertTrainer(port_model(name), inits,
                                       seeds=[3, 4], **HYPER)
    jpar = jexpert.ParallelExpertTrainer(jmodel, [v0, v1], seeds=[3, 4],
                                         **HYPER)
    for i, t in zip(images, texts):
        loss, acc = par.train_batch(i, t)
        jl, ja = jpar.train_batch(i, t)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
    for j in range(2):
        assert_state(par.model_for(j), name, jax.tree_util.tree_map(
            lambda x: np.asarray(x[j]), jpar.variables))
        seq = expert.BiEncoderTrainer(port_model(name), inits[j],
                                      seed=3 + j, **HYPER)
        for i, t in zip(images, texts):
            seq.train_batch(i[j], t[j])
        for k, x in seq.model.state_dict().items():
            assert torch.equal(x, par.model_for(j).state_dict()[k]), k


def test_evaluate_synset_with_a_batchnorm_student():
    """A ResNet-18 student trains on batch statistics (its running
    averages moving; one step of 8 images) and is scored on its running
    averages: accuracies, trained state and metrics as JAX's."""
    name, n_test = "resnet18", 8
    size = SIZES[name]
    cfg = dict(lr_net=0.05, batch_train=8, epoch_eval_train=0, k_test=16,
               seed=0, image_encoder=name, image_size=size)
    tl = pipeline.Loader(datasets.SyntheticVLEval(
        n_test, transforms.make_test_transform(size), size, seed=2), 3)
    jl = jpipeline.Loader(jdatasets.SyntheticVLEval(
        n_test, jtransforms.make_test_transform(size), size, seed=2), 3)
    rs = np.random.RandomState(5)
    images = rs.randn(8, size, size, 3).astype(np.float32)
    texts = rs.randn(8, TXT).astype(np.float32)
    bert = rs.randn(5 * n_test, TXT).astype(np.float32)
    jmodel, v = jax_setup(name)
    jvars, jacc, jval = jeval.evaluate_synset(
        1, jmodel, v, images, texts, jl, JConfig(**cfg), bert)
    init = port_state(name, v)
    model, acc, val = teval.evaluate_synset(
        1, port_model(name), init, images, texts, tl, Config(**cfg), bert)
    np.testing.assert_allclose(acc, jacc, rtol=1e-5)
    assert val == jval
    # the step's stem-conv gradient passes all 20 BatchNorms on batch
    # statistics: float32 itself parts from a float64 run of this step by
    # 1.1e-4 there (the JAX package's by 1.5e-4) against a largest weight
    # of ~0.3, so each tensor is held to 2e-3 of its largest value too
    assert_state(model, name, jvars, floor=2e-3)
    assert not torch.equal(model.state_dict()[
        "image_encoder.model.bn1.running_mean"],
        init["image_encoder.model.bn1.running_mean"])
