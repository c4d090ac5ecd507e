"""Port parity: ``engine/eval.py`` against the JAX package.

Top-k masks and ranks are exact (the same comparisons on the same
numbers).  ``retrieval_eval`` and ``evaluate_synset`` run the same NF_TINY
weights (carried across as in test_torch_expert.py, dropout off) on the
same synthetic test split and seeded text embeddings: score matrices
within 1e-5 of the largest score (float32 convs summed in other orders),
per-epoch accuracies within 1e-5, metrics equal (no near-tie at this
size moves a rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.data import datasets as jdatasets
from multimodal_dataset_distillation_tpu.data import pipeline as jpipeline
from multimodal_dataset_distillation_tpu.data import transforms as jtransforms
from multimodal_dataset_distillation_tpu.engine import eval as jeval
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import datasets
from multimodal_dataset_distillation_tpu_torch.data import pipeline
from multimodal_dataset_distillation_tpu_torch.data import transforms
from multimodal_dataset_distillation_tpu_torch.engine import eval as teval
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
    init_bi_encoder,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import flatten_params
from test_torch_expert import _jax_variables, port_model, port_state
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE, N_TEST = 32, 8
EVAL = dict(lr_net=0.05, batch_train=4, epoch_eval_train=1, k_test=16,
            seed=0, image_encoder="nf_tiny", image_size=SIZE)


def _loaders():
    """Port and JAX test loaders over the same synthetic split."""
    t = pipeline.Loader(datasets.SyntheticVLEval(
        N_TEST, transforms.make_test_transform(SIZE), SIZE, seed=2), 3)
    j = jpipeline.Loader(jdatasets.SyntheticVLEval(
        N_TEST, jtransforms.make_test_transform(SIZE), SIZE, seed=2), 3)
    return t, j


def _text(seed=1):
    return np.random.RandomState(seed).randn(5 * N_TEST, 768).astype(
        np.float32)


def _planted_ties(seed=3, n_img=17, n_txt=85, k=9):
    rng = np.random.RandomState(seed)
    sims = rng.randn(n_img, n_txt).astype(np.float32)
    sims[:, 40:45] = sims[:, :5]      # ties outside the -100 block too
    img2txt = {i: sorted(rng.choice(n_txt, 5, replace=False).tolist())
               for i in range(n_img)}
    txt2img = {t: int(rng.randint(n_img)) for t in range(n_txt)}
    return sims, k, img2txt, txt2img


@pytest.mark.parametrize("k", [1, 2, 5, 9, 200])
def test_topk_score_matrix_equals_jax(k):
    sims = np.random.RandomState(k).randn(7, 11).astype(np.float32)
    got = teval.topk_score_matrix(torch.from_numpy(sims), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jeval.topk_score_matrix(jnp.asarray(sims), k)))


def test_golden_ranks():
    """The golden cases of tests/test_itm_eval.py."""
    scores_i2t = np.full((3, 6), -100.0)
    for i in range(3):
        scores_i2t[i, 2 * i], scores_i2t[i, 2 * i + 1] = 10.0, 9.0
    scores_t2i = np.full((6, 3), -100.0)
    for t in range(6):
        scores_t2i[t, t // 2] = 10.0
    r = teval.itm_eval(scores_i2t, scores_t2i, {t: t // 2 for t in range(6)},
                       {i: [2 * i, 2 * i + 1] for i in range(3)})
    assert r["txt_r1"] == r["img_r1"] == r["r_mean"] == 100.0
    r = teval.itm_eval(np.array([[5.0, 9.0, -100.0, -100.0]]),
                       np.array([[9.0], [1.0], [1.0], [1.0]]), {0: 0, 1: 0,
                                                                 2: 0, 3: 0},
                       {0: [0]})
    assert (r["txt_r1"], r["txt_r5"]) == (0.0, 100.0)
    # ties: the later column ranks first (a reversed stable argsort)
    np.testing.assert_array_equal(
        teval._ranks_desc(np.array([[1.0, 3.0, 3.0, 2.0]] * 2),
                          np.array([1, 2])), [1, 0])


@pytest.mark.parametrize("seed", [3, 4])
def test_itm_eval_and_device_ranks_equal_jax_with_ties(seed):
    sims, k, img2txt, txt2img = _planted_ties(seed)
    i2t = np.array(jeval.topk_score_matrix(jnp.asarray(sims), k))
    t2i = np.array(jeval.topk_score_matrix(jnp.asarray(sims.T), k))
    assert (teval.itm_eval(i2t, t2i, txt2img, img2txt)
            == jeval.itm_eval(i2t, t2i, txt2img, img2txt))
    targets = np.asarray([txt2img[t] for t in range(sims.shape[1])])
    np.testing.assert_array_equal(teval._ranks_desc(t2i, targets),
                                  jeval._ranks_desc(t2i, targets))
    np.testing.assert_array_equal(
        teval._ranks_desc_device(torch.from_numpy(t2i),
                                 torch.from_numpy(targets)).numpy(),
        teval._ranks_desc(t2i, targets))
    cands = teval.candidate_table(img2txt, sims.shape[0])
    np.testing.assert_array_equal(cands, jeval.candidate_table(
        img2txt, sims.shape[0]))
    np.testing.assert_array_equal(
        teval._tr_ranks_device(torch.from_numpy(i2t),
                               torch.from_numpy(cands)).numpy(),
        np.asarray(jeval._tr_ranks_device(jnp.asarray(i2t),
                                          jnp.asarray(cands))))


def test_retrieval_eval_matches_jax():
    jmodel, variables = _jax_variables()
    model = port_model(variables["params"])
    tl, jl = _loaders()
    bert = _text()
    ti2t, tt2i = teval.epoch_test(tl, model, bert, k_test=16)
    ji2t, jt2i = jeval.epoch_test(jl, jmodel, variables, bert, k_test=16)
    sims = teval.score_matrix(tl, model, bert).numpy()
    scale = np.abs(sims).max()
    for got, want in ((ti2t, ji2t), (tt2i, jt2i)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(np.where(ti2t > -100, ti2t, sims), sims)
    got = teval.retrieval_eval(tl, model, bert, k_test=16)
    assert got == jeval.retrieval_eval(jl, jmodel, variables, bert, 16)
    assert got == teval.itm_eval(ti2t, tt2i, tl.dataset.txt2img,
                                 tl.dataset.img2txt)


def _syn(seed=5, n=6):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, SIZE, SIZE, 3).astype(np.float32),
            rs.randn(n, 768).astype(np.float32))


def test_evaluate_synset_matches_jax():
    jmodel, variables = _jax_variables()
    tl, jl = _loaders()
    images, texts = _syn()
    bert = _text()
    jvars, jacc, jval = jeval.evaluate_synset(
        1, jmodel, variables, images, texts, jl, JConfig(**EVAL), bert)
    model, acc, val = teval.evaluate_synset(
        1, port_model(), port_state(variables["params"]), images, texts, tl,
        Config(**EVAL), bert)
    np.testing.assert_allclose(acc, jacc, rtol=1e-5)
    assert val == jval
    want = port_state(jax.tree_util.tree_map(np.asarray, jvars["params"]))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)


def test_evaluate_synset_parallel_equals_sequential_and_reuse():
    """Parallel == sequential exactly in the port (dropout on: per-model
    generators at cfg.seed + j), and a second call through ``reuse``
    equals a fresh one."""
    tl, _ = _loaders()
    images, texts = _syn()
    bert = _text()
    cfg = Config(**EVAL)
    inits = []
    for s in (0, 1, 2):   # the port's own init, skipinit gains off zero
        model = init_bi_encoder(VLBiEncoder("nf_tiny", 768, 128), s)
        inits.append({k: v.fill_(0.5) if k.endswith("skipinit_gain")
                      else v for k, v in model.state_dict().items()})
    reuse = {}
    for _ in range(2):
        accs, vals = teval.evaluate_synset_parallel(
            3, port_model(proj_dropout=0.1), inits, images, texts, tl, cfg,
            bert, reuse=reuse)
    seq_reuse = {}
    template = port_model(proj_dropout=0.1)
    for j in range(3):
        model, acc, val = teval.evaluate_synset(
            j, template, inits[j], images, texts, tl, cfg, bert,
            reuse=seq_reuse)
        assert acc == accs[j] and val == vals[j]
        assert torch.equal(flatten_params(model), flatten_params(
            reuse["trainer"].model_for(j)))
    assert seq_reuse["trainer_seq"].model is template
