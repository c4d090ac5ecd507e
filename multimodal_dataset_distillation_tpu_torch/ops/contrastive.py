"""Symmetric InfoNCE contrastive loss, accuracy, and normalization.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/contrastive.py``.

Logit-scale conventions of the reference:

* model forward + retrieval eval use ``exp(log(1/0.07)) ~= 14.2857``
  -> :data:`FIXED_LOGIT_SCALE`
* the upstream inner loop uses the *unexponentiated* ``log(1/0.07)``
  -> :data:`RAW_LOG_SCALE`
* the fork's inner loop uses the learnable inner LR as the scale.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from .fused_jvp import has_tangent

FIXED_LOGIT_SCALE: float = 1.0 / 0.07
RAW_LOG_SCALE: float = math.log(1.0 / 0.07)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 0.0) -> torch.Tensor:
    """Row-normalize ``x``; ``eps=0`` gives NaN on a zero row, as torch's
    ``x / x.norm(dim=1, keepdim=True)`` in the reference does."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    if eps:
        norm = norm.clamp_min(eps)
    return x / norm


def log_softmax(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t.log_softmax(dim)``, in plain ops while a forward-mode tangent
    rides on ``t``: the reverse pass over the fused op's forward-mode rule
    raises (an in-place write to a saved ``exp`` output).  The shift ``m``
    is a constant, as the max is in the fused op."""
    if not has_tangent(t):
        return t.log_softmax(dim)
    m = t.detach().amax(dim, keepdim=True)
    return t - (m + (t - m).exp().sum(dim, keepdim=True).log())


def softmax(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax(t, dim)``, in plain ops while a forward-mode tangent
    rides on ``t`` (as :func:`log_softmax`)."""
    if not has_tangent(t):
        return torch.softmax(t, dim)
    e = (t - t.detach().amax(dim, keepdim=True)).exp()
    return e / e.sum(dim, keepdim=True)


def _symmetric_ce(logits: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  n_valid: Optional[int] = None) -> torch.Tensor:
    """(CE(logits, diag) + CE(logits.T, diag)) / 2 with diagonal targets.

    ``mask`` (0/1 per row, padding at the tail) makes the loss over a
    padded batch exactly the unpadded loss: pad columns get a large
    negative logit (their probability underflows to 0) and pad rows weigh
    0.  ``n_valid`` is the count of real rows (the mean's denominator).
    """
    if mask is None:
        loss_i2t = -log_softmax(logits, 1).diagonal().mean()
        loss_t2i = -log_softmax(logits, 0).diagonal().mean()
        return (loss_i2t + loss_t2i) / 2.0
    # finite (not -inf) so log_softmax gradients stay NaN-free
    big_neg = torch.finfo(logits.dtype).max * -0.5
    m = mask.to(logits.dtype)
    diag_i2t = log_softmax(logits.masked_fill(m[None, :] <= 0, big_neg),
                           1).diagonal()
    diag_t2i = log_softmax(logits.masked_fill(m[:, None] <= 0, big_neg),
                           0).diagonal()
    nv = float(n_valid) if n_valid is not None else m.sum()
    loss_i2t = -(diag_i2t * m).sum() / nv
    loss_t2i = -(diag_t2i * m).sum() / nv
    return (loss_i2t + loss_t2i) / 2.0


def _logits(img_emb, txt_emb, scale, normalize):
    if normalize:
        img_emb = l2_normalize(img_emb)
        txt_emb = l2_normalize(txt_emb)
    return scale * (img_emb @ txt_emb.T)


def info_nce(img_emb: torch.Tensor, txt_emb: torch.Tensor,
             scale: Union[torch.Tensor, float] = FIXED_LOGIT_SCALE,
             normalize: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE loss over an (already-projected) embedding batch."""
    return _symmetric_ce(_logits(img_emb, txt_emb, scale, normalize))


def contrastive_loss_and_acc(
    img_emb: torch.Tensor, txt_emb: torch.Tensor,
    scale: Union[torch.Tensor, float] = FIXED_LOGIT_SCALE,
    normalize: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss + the reference's accuracy (networks.py:884-887): the count of
    row-argmax hits plus column-argmax hits, halved (not normalized)."""
    logits = _logits(img_emb, txt_emb, scale, normalize)
    labels = torch.arange(logits.shape[0], device=logits.device)
    acc_i = (logits.argmax(1) == labels).sum()
    acc_t = (logits.argmax(0) == labels).sum()
    return _symmetric_ce(logits), (acc_i + acc_t) / 2.0
