"""Retrieval evaluation: epoch_test, itm_eval, retrieval_eval, evaluate_synset.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/eval.py``
(reference ``epoch_original.py:68-195``, BLIP-derived):

* ``epoch_test``: project the cached text embeddings through
  ``text_projection`` and l2-normalize; encode and normalize the test
  images; ``sims = exp(log(1/0.07)) * img @ txt.T``; keep the top
  ``k_test`` (=128) entries per row in each direction, the rest -100.
* ``itm_eval``: ranks from the score matrices and the ``img2txt`` /
  ``txt2img`` ground truth -> TR/IR R@1/5/10, their means, ``r_mean``.
* ``evaluate_synset``: train a fresh bi-encoder on the synthetic set (SGD
  momentum 0.9, wd 5e-4, lr = the learned ``syn_lr``), then score it.

The scoring path runs on the model's device: encode, normalize, the
scaled product (float32, TF32 off: the JAX ``Precision.HIGHEST``), the
top-k mask and the tie-exact ranks.  Only the two rank vectors reach the
host (:func:`retrieval_eval`).  ``itm_eval`` is the host (numpy) version
the ranks are held against.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import ArrayPairLoader
from ..models.clip_model import VLBiEncoder
from ..ops.contrastive import FIXED_LOGIT_SCALE, l2_normalize
from ..parallel.mesh import SINGLE, Mesh
from .expert import BiEncoderTrainer, ParallelExpertTrainer, StateDict


def topk_score_matrix(sims: torch.Tensor, k: int) -> torch.Tensor:
    """Keep top-k per row, fill the rest with -100 (epoch_original.py:95-105)."""
    vals, idx = torch.topk(sims, min(k, sims.shape[1]), dim=1)
    return torch.full_like(sims, -100.0).scatter_(1, idx, vals)


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@torch.no_grad()
def score_matrix(testloader, model: VLBiEncoder,
                 bert_test_embed) -> torch.Tensor:
    """(n_img, n_txt) float32 similarities, before the top-k mask, on the
    model's device."""
    device = next(model.parameters()).device
    chunks = []
    # The JAX package pads the last batch to keep XLA's shapes static.
    # Nothing in eval mode mixes the rows of a batch, so a short batch gives
    # the same rows and the port takes it as it is.
    for images, _idx in testloader:
        x = torch.as_tensor(images, dtype=torch.float32, device=device)
        chunks.append(l2_normalize(model.encode_image(x).float()))
    img = torch.cat(chunks)
    txt = l2_normalize(model.project_text(torch.as_tensor(
        bert_test_embed, dtype=torch.float32, device=device)))
    with _no_tf32():
        return FIXED_LOGIT_SCALE * (img @ txt.T)


def _epoch_test_scores(testloader, model: VLBiEncoder, bert_test_embed,
                       k_test: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device score matrices (i2t, t2i); core of :func:`epoch_test`."""
    sims = score_matrix(testloader, model, bert_test_embed)
    return topk_score_matrix(sims, k_test), topk_score_matrix(sims.T, k_test)


def epoch_test(testloader, model: VLBiEncoder, bert_test_embed,
               k_test: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Score matrices (i2t, t2i) for a test loader, on the host."""
    i2t, t2i = _epoch_test_scores(testloader, model, bert_test_embed, k_test)
    return i2t.cpu().numpy(), t2i.cpu().numpy()


def _ranks_desc(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Rank of ``targets[i]`` in ``np.argsort(scores[i], kind="stable")
    [::-1]``: ``#(s_i > s_t) + #(s_i == s_t and i > t)``, with no sort.
    The reference's default quicksort orders ties arbitrarily, but ties
    arise only in the -100 block of the top-k mask, whose ranks are
    >= k_test, so R@1/5/10 are the same under every tie order."""
    targets = np.asarray(targets)
    s_t = np.take_along_axis(scores, targets[:, None], axis=1)
    idx = np.arange(scores.shape[1])[None, :]
    greater = (scores > s_t).sum(axis=1)
    ties_after = ((scores == s_t) & (idx > targets[:, None])).sum(axis=1)
    return greater + ties_after


def candidate_table(img2txt: Dict[int, list], n_img: int) -> np.ndarray:
    """(n_img, max_captions) padded candidate-column table, -1 padded."""
    width = max(len(img2txt[i]) for i in range(n_img))
    out = np.full((n_img, width), -1, np.int64)
    for i in range(n_img):
        c = np.asarray(img2txt[i], np.int64)
        out[i, : len(c)] = c
    return out


def _metrics_from_ranks(tr_ranks: np.ndarray,
                        ir_ranks: np.ndarray) -> Dict[str, float]:
    tr1, tr5, tr10 = (100.0 * np.sum(tr_ranks < k) / len(tr_ranks)
                      for k in (1, 5, 10))
    ir1, ir5, ir10 = (100.0 * np.sum(ir_ranks < k) / len(ir_ranks)
                      for k in (1, 5, 10))
    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    r_mean = (tr_mean + ir_mean) / 2
    return {"txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
            "txt_r_mean": tr_mean, "img_r1": ir1, "img_r5": ir5,
            "img_r10": ir10, "img_r_mean": ir_mean, "r_mean": r_mean}


def itm_eval(scores_i2t: np.ndarray, scores_t2i: np.ndarray,
             txt2img: Dict[int, int], img2txt: Dict[int, list]
             ) -> Dict[str, float]:
    """Rank-based retrieval metrics (epoch_original.py:114-161), on the
    host; the reference's per-row argsort loop as one broadcast pass."""
    scores_i2t = np.asarray(scores_i2t)
    scores_t2i = np.asarray(scores_t2i)
    # Images -> Text: best (minimum) rank over each image's caption set
    cands = candidate_table(img2txt, scores_i2t.shape[0])
    tr_ranks = np.full(scores_i2t.shape[0], np.iinfo(np.int64).max)
    for c in range(cands.shape[1]):
        col = cands[:, c]
        valid = col >= 0
        r = _ranks_desc(scores_i2t[valid], col[valid])
        tr_ranks[valid] = np.minimum(tr_ranks[valid], r)
    # Text -> Images
    ir_targets = np.asarray([txt2img[i] for i in range(scores_t2i.shape[0])])
    ir_ranks = _ranks_desc(scores_t2i, ir_targets)
    return _metrics_from_ranks(tr_ranks, ir_ranks)


def _ranks_desc_device(scores: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`_ranks_desc` (same tie-exact formula)."""
    s_t = scores.gather(1, targets[:, None])
    idx = torch.arange(scores.shape[1], device=scores.device)[None, :]
    greater = (scores > s_t).sum(dim=1)
    ties_after = ((scores == s_t) & (idx > targets[:, None])).sum(dim=1)
    return greater + ties_after


def _tr_ranks_device(scores_i2t: torch.Tensor,
                     cands: torch.Tensor) -> torch.Tensor:
    """Min rank over each row's (-1 padded) candidate columns."""
    big = torch.iinfo(torch.int64).max
    out = torch.full((scores_i2t.shape[0],), big, dtype=torch.int64,
                     device=scores_i2t.device)
    for c in range(cands.shape[1]):  # <= max captions per image
        col = cands[:, c]
        r = _ranks_desc_device(scores_i2t, col.clamp_min(0))
        out = torch.minimum(out, torch.where(col >= 0, r, big))
    return out


def retrieval_eval(testloader, model: VLBiEncoder, bert_test_embed,
                   k_test: int = 128) -> Dict[str, float]:
    """``itm_eval(*epoch_test(...))`` with scores, mask and ranks on the
    device: only the two rank vectors cross to the host (at COCO scale the
    score matrices are 2 x ~500 MB)."""
    i2t, t2i = _epoch_test_scores(testloader, model, bert_test_embed, k_test)
    ds, device = testloader.dataset, i2t.device
    cands = torch.as_tensor(candidate_table(ds.img2txt, i2t.shape[0]),
                            device=device)
    ir_targets = torch.as_tensor(
        np.asarray([ds.txt2img[i] for i in range(t2i.shape[0])], np.int64),
        device=device)
    tr_ranks = _tr_ranks_device(i2t, cands).cpu().numpy()
    ir_ranks = _ranks_desc_device(t2i, ir_targets).cpu().numpy()
    return _metrics_from_ranks(tr_ranks, ir_ranks)


def evaluate_synset(it_eval: int, model: VLBiEncoder, variables: StateDict,
                    images_train: np.ndarray, texts_train: np.ndarray,
                    testloader, cfg: Config, bert_test_embed,
                    reuse: Optional[dict] = None):
    """Train a fresh model on the synthetic set, then retrieval-eval it.

    Reference ``evaluate_synset`` (epoch_original.py:164-195): SGD momentum
    0.9, weight decay 5e-4, lr = ``cfg.lr_net`` (the learned
    ``syn_lr_img``), ``epoch_eval_train`` + 1 epochs at ``batch_train``;
    batch order and dropout from ``cfg.seed + it_eval``.  ``model`` is
    trained in place from ``variables``.  ``reuse``: a dict the caller
    keeps; the trainer is cached there and re-armed on later calls.

    -> (trained model, per-epoch accuracies, metrics).
    """
    trainer = (reuse or {}).get("trainer_seq")
    if trainer is not None and trainer.model is model:
        trainer.reset(variables, seed=cfg.seed + it_eval,
                      lr_img=cfg.lr_net, lr_txt=cfg.lr_net)
    else:
        trainer = BiEncoderTrainer(
            model, variables, lr_img=cfg.lr_net, lr_txt=cfg.lr_net,
            momentum=0.9, weight_decay=5e-4, seed=cfg.seed + it_eval)
        if reuse is not None:
            reuse["trainer_seq"] = trainer
    loader = ArrayPairLoader(images_train, texts_train,
                             batch_size=cfg.batch_train, shuffle=True,
                             seed=cfg.seed + it_eval)
    acc_list = [trainer.train_epoch_arrays(loader)[1]
                for _ in range(int(cfg.epoch_eval_train) + 1)]
    val_result = retrieval_eval(testloader, model, bert_test_embed,
                                cfg.k_test)
    return model, acc_list, val_result


def evaluate_synset_parallel(num_eval: int, model: VLBiEncoder,
                             variables_list: Sequence[StateDict],
                             images_train: np.ndarray,
                             texts_train: np.ndarray, testloader,
                             cfg: Config, bert_test_embed,
                             reuse: Optional[dict] = None,
                             mesh: Optional[Mesh] = None
                             ) -> Tuple[List[List[float]], List[dict]]:
    """The ``num_eval`` synset evaluations through one
    :class:`~.expert.ParallelExpertTrainer`: model ``j`` starts from
    ``variables_list[j]`` with batch order and dropout from ``cfg.seed +
    j``, the streams ``evaluate_synset(it_eval=j)`` uses, so each result
    equals the sequential path's.  -> (acc lists, metrics), one each per
    model.  ``reuse`` as in :func:`evaluate_synset`.  ``mesh``: the
    students split over its ranks (every rank calls; each gets every
    result), as the JAX function shards them over ``data``."""
    seeds = [cfg.seed + j for j in range(num_eval)]
    trainer = (reuse or {}).get("trainer")
    if (trainer is not None and trainer.k == num_eval
            and trainer.mesh == (mesh or SINGLE)):
        trainer.reset(list(variables_list), seeds=seeds,
                      lr_img=cfg.lr_net, lr_txt=cfg.lr_net)
    else:
        trainer = ParallelExpertTrainer(
            model, list(variables_list), lr_img=cfg.lr_net,
            lr_txt=cfg.lr_net, momentum=0.9, weight_decay=5e-4, seeds=seeds,
            mesh=mesh)
        if reuse is not None:
            reuse["trainer"] = trainer
    loaders = [ArrayPairLoader(images_train, texts_train,
                               batch_size=cfg.batch_train, shuffle=True,
                               seed=s) for s in seeds]
    acc_hist = [trainer.train_epoch_captions(loaders, lambda t: t)[1]
                for _ in range(int(cfg.epoch_eval_train) + 1)]
    acc_lists = [[float(a[j]) for a in acc_hist] for j in range(num_eval)]
    val_results = [trainer.on_owner(j, lambda t: retrieval_eval(
        testloader, t.model, bert_test_embed, cfg.k_test))
        for j in range(num_eval)]
    return acc_lists, val_results
